"""Contiguous KV layout of the PyTorch port held against the JAX package.

On the CPU the port's ``decode_attention`` (K2) and ``prefill_attention``
(K3) take their plain versions; they must match the JAX Pallas kernels
(interpret mode, small blocks) within atol 1e-5 in float32 — both sides
compute a float32 softmax over the same inputs, only the order of
summation differs. Scaled int8 caches are built by the JAX quantizer and
go to both sides as the same bytes. The contiguous runner
(``ModelRunner(paged=False)``) must give the JAX contiguous runner's greedy
tokens (float32 weights, float32 and int8 caches, ``step`` and
``step_n``), prefix-reuse admissions included. The kernels themselves are
checked on the card by tests/test_torch_cuda.py.
"""

import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu import ops as jops  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models import quant as jq  # noqa: E402
from localai_tpu_torch import ops as tops  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import load_config_file  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.models.manager import build_runner  # noqa: E402
from localai_tpu_torch.ops import _build  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401
from test_torch_runner import _model  # noqa: E402

# (S, Hq, Hkv, hd, C, positions, window, JAX block_k)
DECODE_CASES = {
    "g2-edges": (3, 4, 2, 16, 32, [7, 8, 31], None, 8),
    "g4-ragged": (4, 8, 2, 32, 64, [0, 15, 16, 63], None, 16),
    "g1": (2, 4, 4, 32, 48, [5, 40], None, 16),
    "window": (3, 8, 2, 16, 64, [3, 30, 63], 11, 8),
    # C=100 is no multiple of the port kernel's 64-row tile
    "c100": (2, 4, 2, 16, 100, [99, 64], None, 20),
}


def _decode_inputs(S, Hq, Hkv, hd, C, positions, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(S, Hkv, C, hd)).astype(np.float32)
    v = rng.normal(size=(S, Hkv, C, hd)).astype(np.float32)
    return q, k, v, np.asarray(positions, np.int32)


def _jax_xla_decode(q, keys, values, pos, C, window, hd):
    """The JAX package's XLA grouped attention with a decode mask."""
    idx = np.arange(C)[None, None, :]
    mask = idx <= pos[:, None, None]
    if window is not None:
        mask &= idx > pos[:, None, None] - window
    out = jl._grouped_attn(types.SimpleNamespace(hd=hd),
                           jnp.asarray(q)[:, None], jnp.asarray(keys),
                           jnp.asarray(values), jnp.asarray(mask))
    return np.asarray(out[:, 0])


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_matches_jax(case, kv):
    S, Hq, Hkv, hd, C, positions, window, bk = DECODE_CASES[case]
    q, k, v, pos = _decode_inputs(S, Hq, Hkv, hd, C, positions, 3)
    if kv == "int8":
        kq, ks = jq.quantize_lastdim(jnp.asarray(k))
        vq, vs = jq.quantize_lastdim(jnp.asarray(v))
        cache = [np.array(a) for a in (kq, vq)]     # writable copies
        scales = [np.array(a) for a in (ks, vs)]
        keys = cache[0].astype(np.float32) * scales[0][..., None]
        values = cache[1].astype(np.float32) * scales[1][..., None]
    else:
        cache, scales, keys, values = [k, v], [], k, v
    want_kernel = np.asarray(jops.decode_attention(
        jnp.asarray(q), *map(jnp.asarray, cache), jnp.asarray(pos),
        *map(jnp.asarray, scales), sliding_window=window, block_k=bk,
        interpret=True))
    want_xla = _jax_xla_decode(q, keys, values, pos, C, window, hd)
    before = tops.decode_attention.launches
    got = tops.decode_attention(
        *[torch.from_numpy(a) for a in (q, *cache, pos, *scales)],
        sliding_window=window)
    assert tops.decode_attention.launches == before  # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (S, Hq, hd)
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=1e-5)


# (T, Hq, Hkv, hd, length, window); windows wider than T - length, so
# every row, padding rows included, keeps at least one key
PREFILL_CASES = {
    "g1-full": (32, 4, 4, 16, 32, None),
    "g2-short": (32, 8, 4, 16, 20, None),
    "g4-window": (48, 8, 2, 16, 48, 10),
    "g4-window-short": (48, 8, 2, 32, 30, 40),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_attention_matches_jax(case):
    T, Hq, Hkv, hd, length, window = PREFILL_CASES[case]
    rng = np.random.default_rng(5)
    q = rng.normal(size=(T, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(Hkv, T, hd)).astype(np.float32)
    v = rng.normal(size=(Hkv, T, hd)).astype(np.float32)
    want = np.asarray(jops.prefill_attention(
        *map(jnp.asarray, (q, k, v)), jnp.int32(length),
        sliding_window=window, block_q=16, block_k=16, interpret=True))
    before = tops.prefill_attention.launches
    got = tops.prefill_attention(*map(torch.from_numpy, (q, k, v)), length,
                                 sliding_window=window)
    assert tops.prefill_attention.launches == before
    assert got.shape == (T, Hq, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)  # all T rows


def test_paged_plain_version_is_the_gathered_contiguous_one():
    """K1's plain version gathers the pool through the tables and runs
    K2's plain version on the gathered rows."""
    rng = np.random.default_rng(6)
    S, Hq, Hkv, hd, bt, MB = 2, 4, 2, 16, 8, 3
    N = S * MB + 1
    q = torch.from_numpy(rng.normal(size=(S, Hq, hd)).astype(np.float32))
    pool = torch.from_numpy(rng.normal(size=(N, Hkv, bt, hd)).astype(
        np.float32))
    tables = torch.from_numpy((rng.permutation(N - 1) + 1).astype(
        np.int32).reshape(S, MB))
    pos = torch.tensor([5, 20], dtype=torch.int32)
    rows = tops.attention.gather_blocks(pool, tables)
    torch.testing.assert_close(
        tops.paged_decode_attention_ref(q, pool, pool, tables, pos),
        tops.decode_attention_ref(q, rows, rows, pos), rtol=0, atol=0)


RUNNER_KW = dict(num_slots=4, max_ctx=160, prefill_buckets=[32])
PROMPTS = [
    list(b"the quick brown fox jumps over the lazy dog, and again it jumps"),
    list(b"0123456789abcdefg"),
    list(b"hi"),
]


def _run(runner, prompts, singles=3, multi=4):
    """Greedy: admit each prompt, ``singles`` step() calls, then one
    step_n(multi). Returns (slots, token rows per prompt)."""
    slots, seqs = [], []
    for p in prompts:
        s = runner.acquire_slot()
        seqs.append([runner.admit(s, p, temperature=0.0)])
        slots.append(s)
    for _ in range(singles):
        toks = runner.step()
        for seq, s in zip(seqs, slots):
            seq.append(int(toks[s]))
    rows = runner.step_n(multi)
    for seq, s in zip(seqs, slots):
        seq.extend(int(t) for t in rows[:, s])
    return slots, seqs


def _pair(kv_dtype):
    cfg_j, params_j, cfg_t, params_t = _model("tiny")
    jr = JaxRunner(cfg_j, params_j, paged=False,
                   attn_impl="pallas_interpret", kv_dtype=kv_dtype,
                   **RUNNER_KW)
    tr = ModelRunner(cfg_t, params_t, paged=False, device="cpu",
                     kv_dtype=kv_dtype, **RUNNER_KW)
    return jr, tr


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_contiguous_greedy_and_resume_match_jax(kv_dtype):
    jr, tr = _pair(kv_dtype)
    assert not tr.paged and tr.allocator is None and tr.attn_impl == "torch"
    assert tuple(tr.kv.k.shape) == (2, 4, 2, 160, 16)
    assert (tr.kv.k_scale is not None) == (kv_dtype == "int8")
    launches = tops.decode_attention.launches
    out = {}
    for name, r in (("jax", jr), ("port", tr)):
        slots, seqs = _run(r, PROMPTS)
        # a second prompt that shares 40 tokens with slot 0's record reuses
        # its rows: released slots keep their KV and their position
        resident = PROMPTS[0] + seqs[0][:-1]
        for s in slots:
            r.release(s)
        again = PROMPTS[0][:40] + list(b" something else")
        s = r.acquire_slot(slots[0])
        assert s == slots[0]
        first = r.admit(s, again, temperature=0.0, resident=resident)
        assert (r.last_prefill_path, r.last_prefix_reused) == ("resume", 40)
        tail = [first] + [int(r.step()[s]) for _ in range(3)]
        out[name] = (seqs, tail)
    assert out["port"] == out["jax"]
    assert tops.decode_attention.launches == launches  # CPU: plain version


def test_reusable_prefix_gates():
    _, tr = _pair("float32")
    p = list(range(40))
    s = tr.acquire_slot()
    tr.admit(s, p, temperature=0.0)
    tr.release(s)
    assert tr.slot_position(s) == 40  # kept at release
    assert tr.reusable_prefix(s, p, p) == 39       # last token recomputed
    assert tr.reusable_prefix(s, p, p, valid_n=10) == 0   # below the minimum
    assert tr.reusable_prefix(s, p, p[:20] + [7] * 5) == 20
    # a tail bucket that would overhang the context: no reuse
    assert tr.reusable_prefix(s, list(range(150)), list(range(150)),
                              valid_n=150) == 0


def test_int4_needs_the_paged_layout():
    _, _, cfg_t, params_t = _model("tiny")
    with pytest.raises(ValueError, match="paged"):
        ModelRunner(cfg_t, params_t, paged=False, device="cpu",
                    kv_dtype="int4", **RUNNER_KW)


def _yaml(tmp_path, engine, **extra):
    p = tmp_path / "c.yaml"
    p.write_text(yaml.safe_dump({"name": "c", "model": "debug:tiny",
                                 "engine": engine, **extra}))
    return p


@pytest.mark.parametrize("engine,extra,match", [
    # self-extend, refused once, now loads (match None): the runner it
    # builds is tests/test_torch_selfextend.py's
    pytest.param({"grp_attn_n": 4, "grp_attn_w": 64}, {}, None,
                 id="engine0-extra0-self-extend"),
    ({"kv_paged": False, "kv_dtype": "int4"}, {}, "int4"),
])
def test_unported_config_is_refused_at_load(tmp_path, engine, extra, match):
    if match is None:
        cfg = load_config_file(_yaml(tmp_path, engine, **extra))
        assert (cfg.engine.grp_attn_n, cfg.engine.grp_attn_w) == (4, 64)
        return
    with pytest.raises(ValueError, match=match):
        load_config_file(_yaml(tmp_path, engine, **extra))


def test_mmproj_config_loads_a_tower_beside_a_contiguous_runner(tmp_path):
    """``mmproj`` (once refused at load) gives the model a vision tower
    in the engine's dtype on its device; an unknown preset fails the
    load, as on the JAX package."""
    from localai_tpu_torch.models.manager import build_serving_model

    engine = {"kv_paged": False, "dtype": "float32", "kv_dtype": "float32",
              "max_slots": 1}
    cfg = load_config_file(_yaml(tmp_path, engine, mmproj="debug:vit"))
    sm = build_serving_model(cfg, AppConfig(device="cpu"))
    try:
        assert not sm.runner.paged and sm.vision is not None
        assert sm.vision.device.type == "cpu"
        assert sm.vision.params["projector"]["w2"].shape == (
            sm.runner.cfg.hidden_size, sm.runner.cfg.hidden_size)
        assert sm.image_token_id == 0
    finally:
        sm.close()
    bad = load_config_file(_yaml(tmp_path, engine, mmproj="debug:vision"))
    with pytest.raises(ValueError, match="unknown debug vision preset"):
        build_serving_model(bad, AppConfig(device="cpu"))


def test_kv_paged_false_builds_a_contiguous_runner(tmp_path):
    cfg = load_config_file(_yaml(tmp_path, {
        "kv_paged": False, "prefill_buckets": [16, 64], "dtype": "float32",
        "kv_dtype": "int8", "max_slots": 2}, context_size=96))
    assert (cfg.engine.kv_paged, cfg.engine.prefill_buckets) == (
        False, [16, 64])
    _, runner = build_runner(cfg, AppConfig(device="cpu"))
    assert not runner.paged and runner.buckets == [16, 64, 96]
    assert tuple(runner.kv.k.shape)[1:4] == (2, 2, 96)
    cfg.engine.kv_paged = None
    _, paged = build_runner(cfg, AppConfig(device="cpu"))
    assert paged.paged and paged.allocator is not None


def test_launch_count_loses_no_update():
    """Many threads counting launches at once (the engine thread and the
    HTTP threads do) lose no increment."""
    def fake():
        pass

    fake.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                _build.count_launch(fake)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fake.launches == 16 * 2000


def test_select_attn_impl_gates():
    cpu = dict(device=torch.device("cpu"), num_heads=4, num_kv_heads=2,
               head_dim=48, dtype=torch.float16)
    assert tops.select_attn_impl(**cpu)[0] == "torch"
    card = dict(device=torch.device("cuda"), num_heads=32, num_kv_heads=8,
                head_dim=128, dtype=torch.bfloat16)
    assert tops.select_attn_impl(**card) == ("kernel", "")
    assert tops.select_attn_impl(**card, kv_dtype="int8", max_ctx=4096) == (
        "kernel", "")
    for bad in (dict(head_dim=96), dict(num_heads=136),
                dict(kv_dtype="int4"), dict(kv_dtype=torch.float32),
                dict(kv_dtype="int8", max_ctx=4098)):
        with pytest.raises(ValueError):
            tops.select_attn_impl(**{**card, **bad})

