"""Self-extend (group attention) of the PyTorch port against the JAX package.

The port's ``engine.selfextend`` and the self-extend paths of its
contiguous runner (``ga_n`` > 1: an unroped cache, every attention site
through the plain self-extend attend, never K2 or K3) get the same
weights and prompts as the JAX package's runner with the same
``ga_n``/``ga_w`` and must give the same greedy tokens (float32 on the
CPU), within the window and past a shortened trained context, on float32
and int8 caches. Prefill logits agree within 1e-5 (float32: both sides
compute the same float32 products, only the order of summation
differs); the attend agrees with a dense numpy reference within 2e-4 as
the JAX package's own test holds it, and computing it in query chunks
gives one pass's output within 1e-6. The manager takes the contiguous
layout, lifts the context, turns speculation off, and the spec engine
refuses a self-extend target. Inputs come from a numpy seed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.engine import kvcache as jkvc  # noqa: E402
from localai_tpu.engine import selfextend as jse  # noqa: E402
from localai_tpu.engine.runner import ModelRunner as JaxRunner  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu_torch.config.app_config import AppConfig  # noqa: E402
from localai_tpu_torch.config.model_config import ModelConfig  # noqa: E402
from localai_tpu_torch.engine import kvcache as tkvc  # noqa: E402
from localai_tpu_torch.engine import selfextend as tse  # noqa: E402
from localai_tpu_torch.engine.runner import ModelRunner  # noqa: E402
from localai_tpu_torch.engine.scheduler import GenRequest  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.spec import build_spec_engine  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401
from test_torch_runner import _model  # noqa: E402

PROMPT = list(range(1, 40))
# a prompt past the shortened trained context (64) of LONG_CFG
LONG = [(i * 7) % 512 for i in range(100)]


def _runners(cfg_j, params_j, cfg_t, params_t, **kw):
    """(JAX runner, port runner) on the same weights, contiguous."""
    kw = {"num_slots": 2, "max_ctx": 128, "prefill_buckets": [64],
          "kv_dtype": "float32", **kw}
    return (JaxRunner(cfg_j, params_j, **kw),
            ModelRunner(cfg_t, params_t, paged=False, device="cpu", **kw))


def _greedy(runner, prompt, n):
    s = runner.acquire_slot()
    out = [runner.admit(s, list(prompt), temperature=0.0)]
    while len(out) < n:
        out.append(int(runner.step()[s]))
    return out


def _tiny(max_pos=None):
    cfg_j, params_j, cfg_t, params_t = _model("tiny")
    if max_pos:
        cfg_j = dataclasses.replace(cfg_j, max_position_embeddings=max_pos)
        cfg_t = dataclasses.replace(cfg_t, max_position_embeddings=max_pos)
    return cfg_j, params_j, cfg_t, params_t


def test_identity_within_window():
    """Shorter than ga_w, self-extend is plain attention: the port's
    self-extend runner gives the plain runner's and the JAX self-extend
    runner's greedy tokens, through its plain attend."""
    cfg_j, params_j, cfg_t, params_t = _tiny()
    jr, tr = _runners(cfg_j, params_j, cfg_t, params_t, ga_n=4, ga_w=128)
    assert tr.attn_impl == "plain"
    base = ModelRunner(cfg_t, params_t, paged=False, device="cpu",
                       num_slots=2, max_ctx=128, prefill_buckets=[64],
                       kv_dtype="float32")
    got = _greedy(tr, PROMPT, 12)
    assert got == _greedy(base, PROMPT, 12) == _greedy(jr, PROMPT, 12)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_serves_past_trained_context(kv):
    """ga_n=4 admits a prompt longer than max_position_embeddings (64
    here) and decodes on: the same greedy tokens as the JAX package's
    runner on a float32 and on a scaled int8 cache, whose export carries
    the scales and the raw-RoPE mark."""
    cfg_j, params_j, cfg_t, params_t = _tiny(max_pos=64)
    kw = dict(max_ctx=256, prefill_buckets=[64, 128, 256], kv_dtype=kv,
              ga_n=4, ga_w=32)
    jr, tr = _runners(cfg_j, params_j, cfg_t, params_t, **kw)
    got = _greedy(tr, LONG, 10)
    assert got == _greedy(jr, LONG, 10)
    assert all(0 <= t < cfg_t.vocab_size for t in got)
    # grouped positions stay inside the trained window
    eff = tr.ga_w - tr.ga_w // tr.ga_n + (len(LONG) + 10) // tr.ga_n
    assert eff < cfg_t.max_position_embeddings
    exported = tr.export_prefix(0)
    assert str(exported["kv_rope"]) == "raw"
    assert ("k_scale" in exported) == (kv == "int8")


def test_resume_prefill_matches_jax():
    """A second prompt sharing the first's prefix resumes past it (the
    resume site of the attend): equal tokens on both packages."""
    cfg_j, params_j, cfg_t, params_t = _tiny(max_pos=64)
    kw = dict(max_ctx=256, prefill_buckets=[64, 128, 256], ga_n=4, ga_w=32)
    jr, tr = _runners(cfg_j, params_j, cfg_t, params_t, **kw)
    second = LONG[:80] + [3, 1, 4, 1, 5]
    for r in (jr, tr):
        s = r.acquire_slot()
        r.admit(s, LONG, temperature=0.0)
        r.release(s)
    outs = []
    for r in (jr, tr):
        s = r.acquire_slot(0)
        toks = [r.admit(0, second, resident=LONG, temperature=0.0)]
        assert r.last_prefill_path == "resume"
        toks += [int(r.step()[0]) for _ in range(6)]
        outs.append(toks)
    assert outs[0] == outs[1]


def _jax_prefill_logits(cfg, params, ids, ga_n, ga_w, bucket):
    rope = jl.rope_table(cfg, bucket)
    tokens = jnp.zeros((1, bucket), jnp.int32).at[0, :len(ids)].set(
        jnp.asarray(ids, jnp.int32))
    pos = jnp.arange(bucket, dtype=jnp.int32)
    shape = (cfg.num_layers, 1, cfg.num_kv_heads, bucket, cfg.hd)
    kv = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    attend = jse.build_attend(cfg, rope, ga_n, ga_w, pos[None], pos)
    hidden, _ = jl.forward(
        cfg, params, tokens, pos[None],
        jkvc.prefill_write(jnp.int32(0), jnp.zeros((), jnp.int32)), kv,
        jkvc.prefill_mask(cfg, bucket, jnp.int32(len(ids))),
        jse.identity_rope(rope), attn=attend)
    return np.asarray(jl.logits_from_hidden(cfg, params, hidden[0]))


def test_prefill_logits_match_jax():
    """The fresh-prefill site in float32: every real row's logits within
    1e-5 of the JAX package's, past the trained context."""
    cfg_j, params_j, cfg_t, params_t = _tiny(max_pos=64)
    ga_n, ga_w, bucket = 4, 32, 128
    want = _jax_prefill_logits(cfg_j, params_j, LONG, ga_n, ga_w, bucket)
    r = ModelRunner(cfg_t, params_t, paged=False, device="cpu",
                    num_slots=1, max_ctx=bucket, prefill_buckets=[bucket],
                    kv_dtype="float32", ga_n=ga_n, ga_w=ga_w)
    tokens = torch.zeros((1, bucket), dtype=torch.int32)
    tokens[0, :len(LONG)] = torch.tensor(LONG)
    pos = torch.arange(bucket, dtype=torch.int32)[None]
    with torch.no_grad():
        hidden, _ = tl.forward(cfg_t, params_t, tokens, pos,
                               tkvc.chunk_write, None, None, r.rope,
                               attn=r._prefill_attn(len(LONG), bucket))
        got = tl.logits_from_hidden(cfg_t, params_t, hidden[0]).numpy()
    n = len(LONG)
    np.testing.assert_allclose(got[:n], want[:n], atol=1e-5, rtol=1e-5)


def _attend_inputs(cfg, T, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, T, cfg.num_heads, cfg.hd)).astype(np.float32)
    k = rng.normal(size=(1, cfg.num_kv_heads, T, cfg.hd)).astype(np.float32)
    v = rng.normal(size=(1, cfg.num_kv_heads, T, cfg.hd)).astype(np.float32)
    return q, k, v


def test_attend_matches_dense_reference_and_jax():
    """The attend against a dense numpy reference (per-pair position
    remapping, as the JAX package's test builds it) and against the JAX
    attend on the same inputs."""
    cfg_j, _, cfg_t, _ = _tiny()
    ga_n, ga_w, T = 2, 8, 24
    q, k, v = _attend_inputs(cfg_t, T)
    rope_t = tl.rope_table(cfg_t, T, device="cpu")
    pos = torch.arange(T)
    mask = tkvc.prefill_mask(cfg_t, T, T, "cpu")
    ours = tse.build_attend(cfg_t, rope_t, ga_n, ga_w, pos[None], pos)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask).numpy()
    rope_j = jl.rope_table(cfg_j, T)
    jpos = jnp.arange(T, dtype=jnp.int32)
    jout = np.asarray(jse.build_attend(cfg_j, rope_j, ga_n, ga_w,
                                       jpos[None], jpos)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jkvc.prefill_mask(cfg_j, T, jnp.int32(T))))
    np.testing.assert_allclose(ours, jout, atol=1e-5, rtol=1e-5)

    cos_t, sin_t = (t.numpy() for t in rope_t)

    def rot(x, p):
        half = cfg_t.hd // 2
        c, s = cos_t[p], sin_t[p]
        x1, x2 = x[..., :half], x[..., half:]
        return np.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], -1)

    g = cfg_t.num_heads // cfg_t.num_kv_heads
    shift = ga_w - ga_w // ga_n
    ref = np.zeros((T, cfg_t.num_heads, cfg_t.hd), np.float32)
    for h in range(cfg_t.num_heads):
        kv_h = h // g
        scores = np.full((T, T), -1e30, np.float32)
        for i in range(T):
            for j in range(i + 1):
                if i - j < ga_w:
                    qi, kj = rot(q[0, i, h], i), rot(k[0, kv_h, j], j)
                else:
                    qi = rot(q[0, i, h], i // ga_n + shift)
                    kj = rot(k[0, kv_h, j], j // ga_n)
                scores[i, j] = qi @ kj / np.sqrt(cfg_t.hd)
        p = np.exp(scores - scores.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        ref[:, h] = p @ v[0, kv_h]
    np.testing.assert_allclose(ours[0], ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("rows", [1, 5, 16])
def test_query_chunks_equal_one_pass(rows, monkeypatch):
    """Chunks of query rows (the long-prompt path) give the one-pass
    output, past the window and past the trained context."""
    _, _, cfg_t, _ = _tiny(max_pos=32)
    ga_n, ga_w, T = 4, 8, 48
    q, k, v = (torch.from_numpy(a) for a in _attend_inputs(cfg_t, T, 5))
    rope = tl.rope_table(cfg_t, T, device="cpu")
    pos = torch.arange(T)
    mask = tkvc.prefill_mask(cfg_t, T, 40, "cpu")
    # SCORE_BYTES sized to one f32 score set of T rows, then of ``rows``
    row_bytes = 4 * cfg_t.num_heads * T
    monkeypatch.setattr(tse, "SCORE_BYTES", T * row_bytes)
    one = tse.build_attend(cfg_t, rope, ga_n, ga_w, pos[None], pos)(
        q, k, v, mask)
    monkeypatch.setattr(tse, "SCORE_BYTES", rows * row_bytes)
    chunked = tse.build_attend(cfg_t, rope, ga_n, ga_w, pos[None], pos)(
        q, k, v, mask)
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_ga_w_divisibility_and_layout_validated():
    _, _, cfg_t, params_t = _tiny()
    kw = dict(num_slots=2, max_ctx=128, prefill_buckets=[64],
              device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        ModelRunner(cfg_t, params_t, paged=False, ga_n=3, ga_w=64, **kw)
    with pytest.raises(ValueError, match="self-extend"):
        ModelRunner(cfg_t, params_t, paged=True, ga_n=2, ga_w=64, **kw)
    runner = ModelRunner(cfg_t, params_t, paged=False, ga_n=2, ga_w=64,
                         **kw)
    assert runner.attn_impl == "plain"


def test_manager_layout_context_and_spec():
    """grp_attn_n in a YAML reaches the runner: the contiguous layout,
    the context lifted to max_position_embeddings x grp_attn_n,
    speculation off (the default would turn it on for a paged engine),
    a served request; the spec engine refuses a self-extend target."""
    from localai_tpu_torch.models.manager import build_serving_model

    mcfg = ModelConfig.from_dict({
        "name": "se", "model": "debug:tiny", "context_size": 1024,
        "engine": {"max_slots": 2, "prefill_buckets": [64],
                   "dtype": "float32", "kv_dtype": "float32",
                   "grp_attn_n": 2, "grp_attn_w": 64}})
    sm = build_serving_model(mcfg, AppConfig(device="cpu"))
    try:
        assert (sm.runner.ga_n, sm.runner.ga_w) == (2, 64)
        assert not sm.runner.paged and sm.scheduler.spec is None
        # debug:tiny trains at 512; ga_n=2 allows 1024
        assert sm.runner.max_ctx == 1024
        h = sm.scheduler.submit(GenRequest(prompt=PROMPT, max_new_tokens=4,
                                           temperature=0.0))
        h.result(timeout=120)
        assert h.finish_reason in ("stop", "length")
        with pytest.raises(ValueError, match="self-extend"):
            build_spec_engine(sm.runner)
    finally:
        sm.scheduler.shutdown()
