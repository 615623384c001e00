"""Every GQA group from 1 to 16 on the port's attention path, on the CPU.

The card's kernels take groups 1-16: K1 and K2 run a group on the next
compiled group capacity (1, 2, 4, 8, 16) with the rows past the group
masked, K3 reads the group at run time and masks the rows a block has
left over. Here, on the CPU:

  * the plain versions of K1, K2 and K3 (what the wrappers run for CPU
    tensors, and what the card's kernels are held to) match the JAX
    package's Pallas kernels in interpret mode at groups 3, 5, 6, 7 and
    16, within atol 1e-5 in float32 (both sides compute a float32 softmax
    over the same numpy-seeded inputs; only the summation order differs);
  * the split-walk model of K1 matches too at those groups (the kernel's
    partials are laid out by the group, not the capacity);
  * ``select_paged_attn_impl`` / ``select_attn_impl`` (pure functions)
    answer "kernel" on a CUDA device for every group 1-16 at head dims 64
    and 128 and raise, naming the value, for head dim 80 and group 17;
  * a plain model of K3's block map (``prefill_row_map``) writes every
    (position, head) row exactly once at every group, for 64- and 128-row
    blocks and T not a multiple of a block;
  * the tiny-model greedy stream of the port equals the JAX package's at
    groups 3 and 7 on the paged and the contiguous layout (float32, exact
    tokens);
  * ``engine.attn_impl`` and ``LOCALAI_ATTN_IMPL`` / ``LOCALAI_PAGED_ATTN_
    IMPL`` are accepted and refused as the JAX package's
    ``resolve_attn_impl`` / ``select_paged_attn_impl`` accept and refuse
    them, with its precedence and messages, and never move the runner off
    its one path.
The kernels themselves at these groups are held to the plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu import ops as jops  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.ops import tuning as jtuning  # noqa: E402
from localai_tpu_torch import ops as tops  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.loader import load_config_file  # noqa: E402
from localai_tpu_torch.engine import runner as trunner  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models.manager import build_runner  # noqa: E402
from localai_tpu_torch.ops import attention as tatt  # noqa: E402
from test_torch_attention import _inputs  # noqa: E402
from test_torch_contiguous import _decode_inputs  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

GROUPS = (3, 5, 6, 7, 16)
CUDA = torch.device("cuda")


# -- the plain versions against the JAX Pallas kernels -----------------------


@pytest.mark.parametrize("window", [None, 11])
@pytest.mark.parametrize("g", GROUPS)
def test_paged_plain_version_matches_jax_at_group(g, window):
    S, Hkv, hd, bt, MB = 3, 2, 16, 8, 8
    q, k, v, tables, pos = _inputs(S, g * Hkv, Hkv, hd, bt, MB,
                                   [7, 8, 63], 20 + g)
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, pos)]
    want = np.asarray(jops.paged_decode_attention(
        *jargs, sliding_window=window, interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v, tables, pos)]
    got = tops.paged_decode_attention(*t, sliding_window=window)
    assert got.shape == (S, g * Hkv, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the kernel's split walk at the finest split and at two blocks
    for bps in (1, 2):
        split = tatt.paged_decode_attention_split_ref(
            *t, split_blocks=bps, sliding_window=window)
        np.testing.assert_allclose(split.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("g", GROUPS)
def test_contiguous_plain_version_matches_jax_at_group(g):
    S, Hkv, hd, C = 3, 2, 16, 100
    q, k, v, pos = _decode_inputs(S, g * Hkv, Hkv, hd, C, [99, 64, 3],
                                  30 + g)
    want = np.asarray(jops.decode_attention(
        *map(jnp.asarray, (q, k, v, pos)), block_k=20, interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v, pos)]
    got = tops.decode_attention(*t)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    split = tatt.decode_attention_split_ref(*t, split_tiles=1)
    np.testing.assert_allclose(split.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("length,window", [(40, None), (27, 20)])
@pytest.mark.parametrize("g", GROUPS)
def test_prefill_plain_version_matches_jax_at_group(g, length, window):
    T, Hkv, hd = 40, 2, 16
    rng = np.random.default_rng(40 + g)
    q = rng.normal(size=(T, g * Hkv, hd)).astype(np.float32)
    k = rng.normal(size=(Hkv, T, hd)).astype(np.float32)
    v = rng.normal(size=(Hkv, T, hd)).astype(np.float32)
    want = np.asarray(jops.prefill_attention(
        *map(jnp.asarray, (q, k, v)), jnp.int32(length),
        sliding_window=window, block_q=8, block_k=8, interpret=True))
    got = tops.prefill_attention(*map(torch.from_numpy, (q, k, v)), length,
                                 sliding_window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# -- what the card takes --------------------------------------------------


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", range(1, 17))
def test_card_takes_every_group(g, hd):
    """Both selectors answer "kernel" on a CUDA device (they read shapes
    only, so no card is needed) on every KV storage they take."""
    heads = dict(num_heads=2 * g, num_kv_heads=2, head_dim=hd)
    for kv in (torch.bfloat16, "int8", "int4"):
        assert tops.select_paged_attn_impl(
            device=CUDA, block_tokens=64, kv_dtype=kv,
            dtype=torch.bfloat16, **heads) == ("kernel", "")
    for kv in (None, torch.bfloat16, "int8"):
        assert tops.select_attn_impl(
            device=CUDA, dtype=torch.bfloat16, kv_dtype=kv, max_ctx=4096,
            **heads) == ("kernel", "")


@pytest.mark.parametrize("hd,g,what", [(80, 4, "head_dim 80"),
                                       (128, 17, "GQA group 17"),
                                       (64, 24, "GQA group 24")])
def test_card_refuses_what_no_kernel_takes_naming_it(hd, g, what):
    heads = dict(num_heads=2 * g, num_kv_heads=2, head_dim=hd)
    with pytest.raises(ValueError, match=what):
        tops.select_paged_attn_impl(device=CUDA, block_tokens=64,
                                    kv_dtype=torch.bfloat16,
                                    dtype=torch.bfloat16, **heads)
    with pytest.raises(ValueError, match=what):
        tops.select_attn_impl(device=CUDA, dtype=torch.bfloat16, **heads)


@pytest.mark.parametrize("name,heads,kv_heads,hd", [
    ("Llama-3.2-3B", 24, 8, 128), ("Qwen2.5-7B", 28, 4, 128),
    ("Qwen2.5-14B", 40, 8, 128), ("Qwen2.5-1.5B", 12, 2, 128),
    ("Mixtral-8x22B", 48, 8, 128), ("Llama-3.1-405B", 128, 8, 128),
    ("SmolLM-135M", 9, 3, 64)])
def test_published_checkpoints_pass_the_card_gates(name, heads, kv_heads,
                                                   hd):
    """The runner's two gates at each checkpoint's heads, on both
    layouts, bf16 and int8 storage (a runner on the card is built behind
    exactly these calls)."""
    kw = dict(device=CUDA, num_heads=heads, num_kv_heads=kv_heads,
              head_dim=hd)
    for kv in (torch.bfloat16, "int8"):
        assert tops.select_paged_attn_impl(
            block_tokens=64, kv_dtype=kv, dtype=torch.bfloat16,
            **kw)[0] == "kernel"
        assert tops.select_attn_impl(dtype=torch.bfloat16, kv_dtype=kv,
                                     max_ctx=4096, **kw)[0] == "kernel"


@pytest.mark.parametrize("g", range(1, 17))
def test_decode_shared_memory_mirrors_the_capacity(g):
    """K1/K2 run group g on capacity G = decode_group(g), the smallest
    compiled one that holds it; their shared memory is G's (the sources'
    smem_bytes at G), and every group fits at the serving shape."""
    G = tatt.decode_group(g)
    assert G in tatt.DECODE_GROUPS and G >= g and G < 2 * g
    for pool in ("", "int8", "int4"):
        for dt in (torch.bfloat16, torch.float32):
            got = tatt.kernel_smem_bytes(dt, 128, g, 64, pool)
            assert got == tatt.kernel_smem_bytes(dt, 128, G, 64, pool)
            row = {"int8": 128, "int4": 64}.get(
                pool, 128 * (2 if dt == torch.bfloat16 else 4))
            assert got == (4 * 64 * row + (4 * 64 * 4 if pool else 0)
                           + G * 128 * 4 + G * 64 * 4 + 3 * G * 4)
            assert tatt.kernel_gate(dt, 128, g, 64, pool) == ""


def test_decode_group_refuses_above_16():
    with pytest.raises(ValueError, match="17"):
        tatt.decode_group(17)


# -- K3's block map ------------------------------------------------------------


@pytest.mark.parametrize("rows", tatt.PREFILL_ROWS)
@pytest.mark.parametrize("g", range(1, 17))
def test_prefill_block_map_writes_every_row_once(g, rows):
    """Blocks of ``rows`` rows take rows // g positions; every (position,
    head) of a prompt is written by exactly one row of one block, and the
    rows % g rows a block has left over write nothing."""
    bq = rows // g
    for T in (1, bq - 1 or 1, bq, bq + 1, 3 * bq + 2, 301):
        pos_per_block, blocks = tatt.prefill_grid(T, g, rows)
        assert pos_per_block == bq and blocks == -(-T // bq)
        written = []
        for b in range(blocks):
            m = tatt.prefill_row_map(b, T, g, rows)
            assert len(m) == rows
            assert all(x is None for x in m[bq * g:])   # left over
            written += [x for x in m if x is not None]
        assert sorted(written) == [(t, h) for t in range(T)
                                   for h in range(g)]


def test_prefill_plan_counts_positions_per_block():
    """The plan's block count uses rows // g positions a block: at group 7
    a 128-row block holds 18 positions, not 128 / 7."""
    # Qwen2.5-7B: 28 q / 4 kv heads, T=4096: 4 * ceil(4096 / 18) = 912
    # blocks of 128 rows, more than 2 on each of 132 SMs
    assert tatt.prefill_grid(4096, 7, 128) == (18, 228)
    assert tatt.prefill_block_rows(4096, 28, 4, 132) == 128
    # 4 * ceil(1024 / 18) = 228 < 264: 64-row blocks
    assert tatt.prefill_block_rows(1024, 28, 4, 132) == 64


# -- the tiny model's greedy stream at groups 3 and 7 ---------------------

RUNNER_KW = dict(num_slots=3, max_ctx=160, prefill_buckets=[32],
                 kv_dtype="float32", kv_block_tokens=16, prefill_chunk=32)
PROMPTS = [list(b"a group of seven query heads shares one kv head"),
           list(b"0123456789abcdefg"), list(b"hi")]


def _group_model(g):
    """debug:tiny's widths at GQA group g (2 kv heads of head dim 16)."""
    cfg_j = dataclasses.replace(
        jl.LlamaConfig(vocab_size=512, hidden_size=32 * g,
                       intermediate_size=128, num_layers=2, num_heads=2 * g,
                       num_kv_heads=2, max_position_embeddings=512),
        dtype="float32")
    params_j = jl.init_params(jax.random.key(g), cfg_j)
    cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
    params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                    cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _greedy(runner, steps=10):
    slots, seqs = [], []
    for p in PROMPTS:
        s = runner.acquire_slot()
        seqs.append([int(runner.admit(s, p, temperature=0.0))])
        slots.append(s)
    for _ in range(steps):
        toks = runner.step()
        for seq, s in zip(seqs, slots):
            seq.append(int(toks[s]))
    return seqs


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("g", [3, 7])
def test_greedy_stream_matches_jax_at_group(g, paged):
    cfg_j, params_j, cfg_t, params_t = _group_model(g)
    jr = JaxRunner(cfg_j, params_j, paged=paged, attn_impl="xla",
                   **RUNNER_KW)
    want = _greedy(jr)
    r = ModelRunner(cfg_t, params_t, paged=paged, device="cpu", **RUNNER_KW)
    assert _greedy(r) == want


# -- engine.attn_impl and the two variables ------------------------------

VALUES = ("auto", "", "pallas", "pallas_interpret", "xla", "bogus", "lax")


@pytest.fixture
def no_attn_env(monkeypatch):
    monkeypatch.delenv("LOCALAI_ATTN_IMPL", raising=False)
    monkeypatch.delenv("LOCALAI_PAGED_ATTN_IMPL", raising=False)
    return monkeypatch


def _jax_accepts(requested, paged):
    """Whether the JAX package accepts ``requested`` (its own functions,
    as its runner calls them: select_attn_impl always, the paged one on a
    paged runner)."""
    try:
        jops.resolve_attn_impl(requested, backend="cpu")
        if paged:
            jops.select_paged_attn_impl(
                requested, num_heads=4, num_kv_heads=2, head_dim=16,
                block_tokens=16, backend="cpu",
                tuned=jtuning.TuneEntry())
    except ValueError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("env_paged", ["", "xla", "bogus"])
@pytest.mark.parametrize("env", ["", "pallas", "bogus"])
@pytest.mark.parametrize("requested", VALUES)
def test_attn_impl_is_accepted_and_refused_as_on_the_jax_package(
        no_attn_env, requested, env, env_paged):
    """An explicit value wins; "auto"/"" takes the variable; an unknown
    value raises the JAX package's message. Both layouts."""
    if env:
        no_attn_env.setenv("LOCALAI_ATTN_IMPL", env)
    if env_paged:
        no_attn_env.setenv("LOCALAI_PAGED_ATTN_IMPL", env_paged)
    for paged in (True, False):
        want = _jax_accepts(requested, paged)
        try:
            tops.resolve_attn_impl(requested)
            if paged:
                tops.resolve_attn_impl(requested, paged=True)
            got = ""
        except ValueError as e:
            got = str(e)
        assert got == want


def test_resolved_value_and_precedence(no_attn_env):
    assert tops.resolve_attn_impl("auto") == "auto"
    no_attn_env.setenv("LOCALAI_ATTN_IMPL", "xla")
    no_attn_env.setenv("LOCALAI_PAGED_ATTN_IMPL", "pallas")
    assert tops.resolve_attn_impl("") == "xla"
    assert tops.resolve_attn_impl("auto", paged=True) == "pallas"
    assert tops.resolve_attn_impl("pallas_interpret") == "pallas_interpret"
    assert tops.resolve_attn_impl("pallas_interpret",
                                  paged=True) == "pallas_interpret"


def _tiny_runner(**kw):
    _, _, cfg_t, params_t = _group_model(3)
    return ModelRunner(cfg_t, params_t, device="cpu", **dict(RUNNER_KW, **kw))


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("value", ["auto", "pallas", "pallas_interpret",
                                   "xla"])
def test_accepted_values_leave_the_runner_on_its_path(no_attn_env, value,
                                                      paged):
    r = _tiny_runner(attn_impl=value, paged=paged)
    assert r.attn_impl == "torch"
    assert r.paged_attn_impl == ("torch" if paged else "")


@pytest.mark.parametrize("where,message", [
    ("engine", "unknown attention impl 'bogus'"),
    ("LOCALAI_ATTN_IMPL", "unknown attention impl 'bogus'"),
    ("LOCALAI_PAGED_ATTN_IMPL", "unknown paged attention impl 'bogus'")])
def test_bogus_value_is_refused_at_load(no_attn_env, tmp_path, where,
                                        message):
    """From the model YAML's ``engine.attn_impl`` or either variable, the
    port's load raises the JAX package's message."""
    engine = {"dtype": "float32", "kv_dtype": "float32", "spec": False}
    if where == "engine":
        engine["attn_impl"] = "bogus"
    else:
        no_attn_env.setenv(where, "bogus")
    (tmp_path / "m.yaml").write_text(
        '{"name": "m", "model": "debug:tiny", "context_size": 128, '
        f'"engine": {__import__("json").dumps(engine)}}}')
    mcfg = load_config_file(tmp_path / "m.yaml")
    assert mcfg.engine.attn_impl == ("bogus" if where == "engine"
                                     else "auto")
    with pytest.raises(ValueError, match=message):
        build_runner(mcfg, AppConfig(device="cpu"))


def test_xla_logs_one_line_at_load(no_attn_env, caplog):
    with caplog.at_level(logging.INFO,
                         logger=trunner.__name__):
        _tiny_runner(attn_impl="xla")
    lines = [r.getMessage() for r in caplog.records
             if "attn_impl 'xla'" in r.getMessage()]
    assert len(lines) == 1 and "one attention path per device" in lines[0]
    caplog.clear()
    with caplog.at_level(logging.INFO,
                         logger=trunner.__name__):
        _tiny_runner(attn_impl="pallas")
    assert not [r for r in caplog.records
                if "attn_impl" in r.getMessage()]


def test_self_extend_does_not_read_the_setting(no_attn_env):
    """As on the JAX package, self-extend overrides the setting with its
    own attend: a bogus value is not read there."""
    r = _tiny_runner(attn_impl="bogus", paged=False, ga_n=2, ga_w=32)
    assert r.attn_impl == "plain"
