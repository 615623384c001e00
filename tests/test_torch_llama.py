"""Llama trunk of the PyTorch port held against the JAX package on the CPU.

Same inputs (numpy seed) and the same weights (JAX ``init_params``, carried
across with ``params_from_numpy``) go through both ``forward``s; prefill
logits must agree within atol/rtol 2e-4 in float32, the tolerance of
tests/test_llama_torch.py (summation order differs between XLA's and
PyTorch's CPU matmuls).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.engine import kvcache as jkvc  # noqa: E402
from localai_tpu.models import llama as jl  # noqa: E402
from localai_tpu.models import loader as jloader  # noqa: E402
from localai_tpu.models.registry import DEBUG_PRESETS as J_PRESETS  # noqa: E402
from localai_tpu_torch.engine import kvcache as tkvc  # noqa: E402
from localai_tpu_torch.models import llama as tl  # noqa: E402
from localai_tpu_torch.models import loader as tloader  # noqa: E402
from localai_tpu_torch.models.registry import (  # noqa: E402
    DEBUG_PRESETS as T_PRESETS,
)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run tiny shapes: one intra-op thread is
    fastest, and torch's OpenMP pool spinning on every core would slow the
    other test workers running beside them. Imported by the other port
    test modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carried(cfg_j, seed=0):
    """(JAX params, port config, port params) with identical weights."""
    params_j = jl.init_params(jax.random.key(seed), cfg_j)
    tree = jax.tree.map(np.asarray, params_j)
    cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg_j))
    return params_j, cfg_t, tl.params_from_numpy(tree, cfg_t, "cpu")


def write_hf_checkpoint(path, cfg, params_j):
    """Write JAX llama params as an HF safetensors checkpoint dir (the
    layout both packages' loaders read)."""
    st = pytest.importorskip("safetensors.numpy")
    tree = jax.tree.map(np.asarray, params_j)
    lay = tree["layers"]
    names = {
        "input_layernorm.weight": ("attn_norm", False),
        "self_attn.q_proj.weight": ("wq", True),
        "self_attn.k_proj.weight": ("wk", True),
        "self_attn.v_proj.weight": ("wv", True),
        "self_attn.o_proj.weight": ("wo", True),
        "post_attention_layernorm.weight": ("mlp_norm", False),
        "mlp.gate_proj.weight": ("w_gate", True),
        "mlp.up_proj.weight": ("w_up", True),
        "mlp.down_proj.weight": ("w_down", True),
    }
    if cfg.attention_bias:
        names.update({f"self_attn.{x}_proj.bias": (f"b{x}", False)
                      for x in "qkv"})
    out = {"model.embed_tokens.weight": tree["embed"],
           "model.norm.weight": tree["final_norm"],
           "lm_head.weight": tree["lm_head"].T}
    for i in range(cfg.num_layers):
        for hf, (key, tr) in names.items():
            a = lay[key][i]
            out[f"model.layers.{i}.{hf}"] = a.T if tr else a
    path.mkdir(parents=True, exist_ok=True)
    st.save_file({k: np.ascontiguousarray(v, np.float32)
                  for k, v in out.items()}, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "attention_bias": cfg.attention_bias,
        "tie_word_embeddings": False}))
    return path


@pytest.mark.parametrize("name", sorted(J_PRESETS))
def test_presets_match_jax(name):
    assert dataclasses.asdict(T_PRESETS[name]) == dataclasses.asdict(
        J_PRESETS[name])
    assert T_PRESETS[name].hd == J_PRESETS[name].hd


@pytest.mark.parametrize("hf", [
    {"vocab_size": 1000, "hidden_size": 128, "num_hidden_layers": 3,
     "num_attention_heads": 4, "num_key_value_heads": 2},
    {"model_type": "qwen2", "hidden_size": 64, "num_attention_heads": 4,
     "sliding_window": 128, "head_dim": 32,
     "rope_scaling": {"rope_type": "yarn", "factor": 2.0}},
])
def test_from_hf_matches_jax(hf):
    assert dataclasses.asdict(tl.LlamaConfig.from_hf(hf)) == \
        dataclasses.asdict(jl.LlamaConfig.from_hf(hf))


@pytest.mark.parametrize("scaling", [
    None,
    {"type": "linear", "factor": 2.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
    {"rope_type": "yarn", "factor": 4.0,
     "original_max_position_embeddings": 64},
], ids=["default", "linear", "llama3", "yarn"])
def test_rope_table_matches_jax(scaling):
    cfg = jl.LlamaConfig(hidden_size=256, num_heads=4, rope_theta=500000.0,
                         rope_scaling=scaling)
    cos_j, sin_j = jl.rope_table(cfg, 64, freq_scale=0.5)
    cfg_t = tl.LlamaConfig(**dataclasses.asdict(cfg))
    cos_t, sin_t = tl.rope_table(cfg_t, 64, freq_scale=0.5, device="cpu")
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)


def _cfg(kind):
    if kind in ("tiny", "small"):
        return dataclasses.replace(J_PRESETS[kind], dtype="float32")
    base = jl.LlamaConfig(vocab_size=128, hidden_size=64,
                          intermediate_size=96, num_layers=2, num_heads=4,
                          num_kv_heads=2, max_position_embeddings=64,
                          dtype="float32")
    if kind == "bias":
        return dataclasses.replace(base, attention_bias=True)
    return dataclasses.replace(base, sliding_window=5)


@pytest.mark.parametrize("kind", ["tiny", "small", "bias", "window"])
def test_prefill_logits_match_jax(kind):
    cfg_j = _cfg(kind)
    params_j, cfg_t, params_t = carried(cfg_j, seed=3)
    rng = np.random.default_rng(11)
    B, T = 2, 13
    tokens = rng.integers(0, cfg_j.vocab_size, (B, T)).astype(np.int32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    mask_j = jnp.broadcast_to(jkvc.resume_mask(cfg_j, T, 0, T), (B, T, T))
    mask_t = tkvc.resume_mask(cfg_t, T, 0, T, device="cpu").expand(B, T, T)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))

    def write_j(kv, k, v):
        return kv, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)

    def write_t(kv, k, v):
        return kv, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)

    h_j, _ = jl.forward(cfg_j, params_j, jnp.asarray(tokens),
                        jnp.asarray(positions), write_j, None, mask_j,
                        jl.rope_table(cfg_j, 32))
    logits_j = np.asarray(jl.logits_from_hidden(cfg_j, params_j, h_j))
    h_t, _ = tl.forward(cfg_t, params_t, torch.from_numpy(tokens),
                        torch.from_numpy(positions.copy()), write_t, None,
                        mask_t, tl.rope_table(cfg_t, 32, device="cpu"))
    logits_t = tl.logits_from_hidden(cfg_t, params_t, h_t).numpy()
    assert np.isfinite(logits_t).all()
    np.testing.assert_allclose(logits_t, logits_j, **TOL)


def test_params_from_numpy_carries_bf16_bits():
    cfg_j = J_PRESETS["tiny"]                       # bfloat16 weights
    params_j = jl.init_params(jax.random.key(1), cfg_j)
    tree = jax.tree.map(np.asarray, params_j)
    assert tree["embed"].dtype.name == "bfloat16"
    params_t = tl.params_from_numpy(tree, tl.LlamaConfig(
        **dataclasses.asdict(cfg_j)), device="cpu")
    assert params_t["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params_t["layers"]["wq"].float().numpy(),
        tree["layers"]["wq"].astype(np.float32))


def test_init_params_shapes_and_seed():
    cfg = dataclasses.replace(T_PRESETS["tiny"], dtype="float32")
    a = tl.init_params(cfg, torch.Generator().manual_seed(5))
    b = tl.init_params(cfg, torch.Generator().manual_seed(5))
    shapes = tl.param_shapes(cfg)
    assert tuple(a["embed"].shape) == shapes["embed"]
    assert tuple(a["layers"]["w_down"].shape) == shapes["layers"]["w_down"]
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert torch.all(a["final_norm"] == 1)


@pytest.mark.parametrize("bias", [False, True])
def test_safetensors_loader_matches_jax(tmp_path, bias):
    cfg_j = dataclasses.replace(_cfg("bias"), attention_bias=bias)
    params_j = jl.init_params(jax.random.key(2), cfg_j)
    ckpt = write_hf_checkpoint(tmp_path / "ckpt", cfg_j, params_j)
    cfg_jl, pj = jloader.load_llama_params(ckpt, dtype="float32")
    cfg_tl, pt = tloader.load_llama_params(ckpt, dtype="float32",
                                           device="cpu")
    assert dataclasses.asdict(cfg_tl) == dataclasses.asdict(cfg_jl)
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    assert len(flat_j) == sum(len(v) if isinstance(v, dict) else 1
                              for v in pt.values())
    for path, leaf in flat_j:
        node = pt
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("bias", [False, True])
def test_written_checkpoint_loads_back_on_both_packages(tmp_path, bias):
    """``write_llama_checkpoint`` writes the HF layout both loaders read:
    the port's weights come back bit for bit, and the JAX package reads
    the same values and config."""
    cfg_t = dataclasses.replace(T_PRESETS["tiny"], dtype="float32",
                                attention_bias=bias)
    params = tl.init_params(cfg_t, torch.Generator().manual_seed(4),
                                "cpu")
    ckpt = tloader.write_llama_checkpoint(tmp_path / "ckpt", cfg_t, params)
    cfg_back, back = tloader.load_llama_params(ckpt, dtype="float32",
                                               device="cpu")
    assert dataclasses.replace(cfg_back, dtype="float32") == cfg_t
    for k, v in params.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            got = back[k] if kk is None else back[k][kk]
            assert torch.equal(got, vv), (k, kk)
    cfg_j, pj = jloader.load_llama_params(ckpt, dtype="float32")
    assert cfg_j.num_layers == cfg_t.num_layers
    np.testing.assert_array_equal(np.asarray(pj["layers"]["wq"]),
                                  params["layers"]["wq"].numpy())
