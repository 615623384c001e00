"""Paged runner and sampler of the PyTorch port against the JAX package.

The port's ModelRunner and the JAX ``ModelRunner(paged=True,
attn_impl="xla", kv_dtype="float32")`` get the same weights and prompts
and must produce byte-identical greedy tokens (float32 on the CPU): one
prompt spans several prefill chunks, one crosses a block edge, one is
short. The port's decode runs the same call as on the card: the paged
attention wrapper, which takes its plain version for CPU tensors. The
same holds for quantized serving: int8 weights with an int8 KV pool and
int4 weights with an int4 pool (quantized by each package from the same
float32 weights; debug:small's 128-aligned widths make every decode
matmul eligible for the w8/w4 kernel wrappers, which take their plain
versions on the CPU).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.engine import sampling as jsmp  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models import quant as jq  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu_torch.engine import sampling as tsmp  # noqa: E402
from localai_tpu_torch.engine.runner import (  # noqa: E402
    NAN_TOKEN,
    ModelRunner,
)
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models import quant as tq  # noqa: E402
from localai_tpu_torch.ops import qmatmul as tqm  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

RUNNER_KW = dict(num_slots=4, max_ctx=160, prefill_buckets=[32],
                 kv_dtype="float32", kv_block_tokens=16, prefill_chunk=32)
PROMPTS = [
    list(b"the quick brown fox jumps over the lazy dog, and again it jumps"),
    list(b"0123456789abcdefg"),        # 17 tokens: crosses a 16-row block
    list(b"hi"),
]
_MODELS: dict = {}


def _model(preset):
    """(JAX cfg, JAX params, port cfg, port params), built once per preset."""
    if preset not in _MODELS:
        cfg_j = dataclasses.replace(J_PRESETS[preset], dtype="float32")
        params_j = jl.init_params(jax.random.key(0), cfg_j)
        cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
        params_t = tl.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        cfg_t, device="cpu")
        _MODELS[preset] = (cfg_j, params_j, cfg_t, params_t)
    return _MODELS[preset]


def _greedy(runner, prompts, steps=10):
    slots, seqs = [], []
    for p in prompts:
        s = runner.acquire_slot()
        seqs.append([runner.admit(s, p, temperature=0.0)])
        slots.append(s)
    for _ in range(steps):
        toks = runner.step()
        for seq, s in zip(seqs, slots):
            seq.append(int(toks[s]))
    return slots, seqs


_JAX_TOKENS: dict = {}


def _jax_greedy(preset):
    if preset not in _JAX_TOKENS:
        cfg_j, params_j, _, _ = _model(preset)
        jr = JaxRunner(cfg_j, params_j, paged=True, attn_impl="xla",
                       **RUNNER_KW)
        _JAX_TOKENS[preset] = _greedy(jr, PROMPTS)[1]
    return _JAX_TOKENS[preset]


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_greedy_tokens_match_jax(preset):
    _, _, cfg_t, params_t = _model(preset)
    r = ModelRunner(cfg_t, params_t, device="cpu", **RUNNER_KW)
    assert r.paged_attn_impl == "torch"
    slots, seqs = _greedy(r, PROMPTS)
    assert seqs == _jax_greedy(preset)
    # allocator accounting: every block comes back at release (prompt
    # blocks may stay cached in the prefix pool)
    for s in slots:
        r.release(s)
    st = r.allocator.stats()
    assert st.used == 0 and st.free + st.cached == st.total
    assert r.allocator.check_invariants() == []
    assert not r.any_active and sorted(r.free_slots()) == [0, 1, 2, 3]
    assert int(r.block_tables.abs().sum()) == 0


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_greedy_tokens_match_jax(mode):
    """(int8 weights, int8 pool) and (int4 weights, int4 pool)."""
    cfg_j, params_j, cfg_t, params_t = _model("small")
    kw = dict(RUNNER_KW, kv_dtype=mode)
    jr = JaxRunner(cfg_j, jq.quantize_params(params_j, mode), paged=True,
                   attn_impl="xla", **kw)
    want = _greedy(jr, PROMPTS)[1]
    qparams = tq.quantize_params(params_t, mode, device="cpu")
    r = ModelRunner(cfg_t, qparams, device="cpu", **kw)
    assert r.kv.k_scale is not None and len(r.kv.stacked()) == 4
    before = (tqm.w8_matmul.launches, tqm.w4_matmul.launches)
    _, seqs = _greedy(r, PROMPTS)
    assert seqs == want
    # the CPU runs the plain versions: no kernel launch is counted
    assert (tqm.w8_matmul.launches, tqm.w4_matmul.launches) == before


def test_prefix_blocks_are_shared_and_reproduce():
    _, _, cfg_t, params_t = _model("tiny")
    r = ModelRunner(cfg_t, params_t, device="cpu", **RUNNER_KW)
    prompt = PROMPTS[0]
    s1 = r.acquire_slot()
    first = r.admit(s1, prompt, temperature=0.0)
    r.release(s1)
    s2 = r.acquire_slot()
    again = r.admit(s2, prompt, temperature=0.0)
    assert r.last_prefill_path == "paged_shared"
    assert r.last_prefix_reused == 16 * ((len(prompt) - 1) // 16)
    assert again == first


def test_nan_row_reports_sentinel_for_its_slot_only():
    _, _, cfg_t, params_t = _model("tiny")
    r = ModelRunner(cfg_t, params_t, device="cpu", **RUNNER_KW)
    slots, _ = _greedy(r, PROMPTS[1:], steps=1)
    bad = np.zeros(cfg_t.vocab_size, np.float32)
    bad[3] = np.nan
    r.set_bias(slots[0], bad)
    toks = r.step()
    assert toks[slots[0]] == NAN_TOKEN and toks[slots[1]] >= 0


def test_step_n_matches_single_steps():
    _, _, cfg_t, params_t = _model("tiny")
    a = ModelRunner(cfg_t, params_t, device="cpu", **RUNNER_KW)
    b = ModelRunner(cfg_t, params_t, device="cpu", **RUNNER_KW)
    sa, _ = _greedy(a, PROMPTS, steps=0)
    _greedy(b, PROMPTS, steps=0)
    rows = a.step_n(4)
    singles = np.stack([b.step() for _ in range(4)])
    assert rows.shape == (4, 4)
    np.testing.assert_array_equal(rows[:, sa], singles[:, sa])


@pytest.mark.parametrize("entry", [
    "runner", "params_from_numpy", "init_paged_cache", "resume_mask",
    "rope_table", "sampling_params", "load_llama_params", "resolve_model",
    "quantize_params"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    """With no device named, the port asks for the card and raises when
    there is none; it never moves to the CPU on its own."""
    from localai_tpu_torch.engine import kvcache as tkvc
    from localai_tpu_torch.models import loader as tloader
    from localai_tpu_torch.models import registry as treg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, cfg_t, params_t = _model("tiny")
    calls = {
        "runner": lambda: ModelRunner(cfg_t, params_t, **RUNNER_KW),
        "params_from_numpy": lambda: tl.params_from_numpy(
            {"embed": np.zeros((cfg_t.vocab_size, cfg_t.hidden_size),
                               np.float32)}, cfg_t),
        "init_paged_cache": lambda: tkvc.init_paged_cache(cfg_t, 3, 16),
        "resume_mask": lambda: tkvc.resume_mask(cfg_t, 4, 0, 16),
        "rope_table": lambda: tl.rope_table(cfg_t, 16),
        "sampling_params": lambda: tsmp.SamplingParams.init(2),
        "load_llama_params": lambda: tloader.load_llama_params(tmp_path),
        "resolve_model": lambda: treg.resolve_model("debug:tiny"),
        "quantize_params": lambda: tq.quantize_params(params_t, "int8"),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def _params(S, **kw):
    p = tsmp.SamplingParams.init(S, device="cpu")
    for s in range(S):
        p.set_slot(s, **kw)
    return p


def test_greedy_ties_take_the_first_index_like_jax():
    logits = np.zeros((2, 300), np.float32)
    logits[0, [7, 40, 299]] = 3.0
    logits[1, [250, 5]] = 1.0
    counts = np.zeros((2, 300), np.int32)
    jp = jsmp.SamplingParams.init(2)
    jp = jp.with_slot(0, temperature=0.0).with_slot(1, temperature=0.0)
    jt, _ = jsmp.sample(jnp.asarray(logits), jp, jnp.asarray(counts),
                        jax.random.split(jax.random.key(0), 2))
    tt = tsmp.sample(torch.from_numpy(logits), _params(2, temperature=0.0),
                     torch.from_numpy(counts), [None, None])
    assert tt.tolist() == np.asarray(jt).tolist() == [7, 5]


def test_penalties_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 50)).astype(np.float32)
    counts = rng.integers(0, 3, (3, 50)).astype(np.int32)
    kw = dict(repeat_penalty=1.3, presence_penalty=0.4,
              frequency_penalty=0.2)
    jp = jsmp.SamplingParams.init(3)
    for s in range(3):
        jp = jp.with_slot(s, **kw)
    want = jsmp.apply_penalties(jnp.asarray(logits), jnp.asarray(counts), jp)
    got = tsmp.apply_penalties(torch.from_numpy(logits),
                               torch.from_numpy(counts), _params(3, **kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_seeded_sampling_reproduces_its_own_stream():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(2, 500)).astype(np.float32))
    counts = torch.zeros((2, 500), dtype=torch.int32)
    params = _params(2, temperature=1.0, top_k=50, top_p=0.9)

    def draws(seed):
        gens = [torch.Generator().manual_seed(seed),
                torch.Generator().manual_seed(seed + 1)]
        return [tsmp.sample(logits, params, counts, gens).tolist()
                for _ in range(20)]

    a, b = draws(3), draws(3)
    assert a == b
    assert a != draws(4)
    # every draw lies inside the top-50 candidate pool of its row
    top = torch.topk(logits, 50).indices
    for row in a:
        for s in range(2):
            assert row[s] in top[s].tolist()


def test_top_k_one_is_greedy_and_counts_update():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    counts = torch.zeros((3, 64), dtype=torch.int32)
    params = _params(3, temperature=0.7, top_k=1)
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    toks = tsmp.sample(logits, params, counts, gens)
    assert toks.tolist() == torch.argmax(logits, -1).tolist()
    tsmp.update_counts(counts, toks, torch.tensor([True, False, True]))
    assert counts.sum().item() == 2 and counts[1].sum().item() == 0
    tsmp.count_prompt_tokens(counts, 1, torch.tensor([4, 4, 9, 1]), 3)
    assert counts[1, 4].item() == 2 and counts[1, 9].item() == 1
    assert counts[1].sum().item() == 3
