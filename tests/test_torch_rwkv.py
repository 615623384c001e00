"""The PyTorch port's RWKV (v4) against the JAX package's
``models/rwkv.py``, and its serving through the recurrent facade, on the
CPU.

The checks of ``tests/test_torch_mamba.py`` (its helpers), for RWKV:
parameters drawn by the JAX package with every vector, decay, bonus and
mix weight noised, carried across by ``params_from_numpy``; in float32,
prefill logits within 1e-4 of the largest at prompt lengths 1, 3, 16, 17
and 40 with the five state tensors of every layer; the reference's
bucketed, length-gated prefill against the port's of the true length; the decode step against the
prefill at the next position; 16 greedy tokens equal; a checkpoint
directory loaded by both, in float32 and in bfloat16 (the reference's
float32 vectors, decay and bonus; its promotions); a chat over the port's
HTTP server equal to the JAX package's serving facade.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("yaml")
pytest.importorskip("tokenizers")

import jax  # noqa: E402

from localai_tpu.models import rwkv as jrw  # noqa: E402
from localai_tpu_torch.models import rwkv as trw  # noqa: E402
from test_torch_mamba import (  # noqa: E402
    chat_matches_the_reference,
    check_bf16,
    check_bucketed,
    check_checkpoint,
    check_greedy,
    check_prefill,
    check_states_own_their_storage,
    check_step,
)


def test_config_from_hf_equals_the_reference():
    for hf in ({"hidden_size": 4096, "attention_hidden_size": 4096,
                "intermediate_size": 16384, "num_hidden_layers": 32,
                "vocab_size": 50277},
               {}, {"hidden_size": 64, "attention_hidden_size": None,
                    "intermediate_size": None, "eos_token_id": None}):
        assert trw.RwkvConfig.from_hf(hf).__dict__ == \
            jrw.RwkvConfig.from_hf(hf).__dict__


def test_fresh_state_equals_the_reference():
    cfg = trw.DEBUG_CONFIG
    ours = trw._init_state(cfg, 2, "cpu")
    ref = jrw._init_state(jrw.RwkvConfig(**cfg.__dict__), 2)
    assert len(ours) == len(ref) == cfg.num_layers
    for a, b in zip(ours, ref):
        for f in ("ffn_shift", "attn_shift", "num", "den", "mx"):
            x, y = getattr(a, f), np.asarray(getattr(b, f))
            assert x.dtype == torch.float32 and tuple(x.shape) == y.shape
            assert np.array_equal(x.numpy(), y)
    assert float(ours[0].mx[0, 0]) == float(np.float32(-1e38))


def test_wkv_step_equals_the_reference():
    rng = np.random.default_rng(0)
    args = [rng.standard_normal((2, 8)).astype(np.float32) * s
            for s in (1, 1, 3, 3, 1, 1, 1)]
    args[2] = args[2] - 1e38 * (rng.random((2, 8)) < 0.3)
    want = jrw._wkv_step(*args)
    got = trw._wkv_step(*map(torch.from_numpy, args))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("L", [1, 3, 16, 17, 40])
def test_prefill_logits_and_states_equal_the_reference(L):
    check_prefill("rwkv", L)


@pytest.mark.parametrize("length,bucket", [(3, 16), (11, 16), (16, 16),
                                           (17, 32)])
def test_bucketed_prefill_equals_the_true_length(length, bucket):
    check_bucketed("rwkv", length, bucket)


@pytest.mark.parametrize("L", [1, 2, 8])
def test_step_equals_the_prefill_at_the_next_position(L):
    check_step("rwkv", L)


def test_prefill_states_own_their_storage():
    check_states_own_their_storage("rwkv")


@pytest.mark.parametrize("prompt", [[], [7], [5, 9, 11], list(range(1, 30))],
                         ids=["empty", "one", "three", "long"])
def test_greedy_tokens_equal_the_reference(prompt):
    check_greedy("rwkv", prompt)


def test_checkpoint_dir_loads_as_the_reference(tmp_path):
    check_checkpoint(tmp_path, "rwkv")


def test_bf16_dtypes_follow_the_reference(tmp_path):
    check_bf16(tmp_path, "rwkv", trw.keeps_float32)


def test_debug_preset_and_init_params():
    lm = trw.resolve_rwkv("debug:rwkv-tiny", seed=1, device="cpu")
    jcfg = jrw.RwkvConfig(vocab_size=512, hidden_size=64,
                          attention_hidden_size=64, intermediate_size=128,
                          num_layers=2, eos_token_id=257)
    assert lm.cfg.__dict__ == jcfg.__dict__
    ref = {k: np.asarray(v) for k, v in
           jrw.init_params(jax.random.key(0), jcfg).items()}
    assert set(lm.params) == set(ref)
    for k, v in lm.params.items():
        assert tuple(v.shape) == ref[k].shape, k
        if ref[k].std() == 0:          # the constants are the reference's
            np.testing.assert_allclose(v.numpy(), ref[k])
    b = trw.init_params(lm.cfg, torch.Generator().manual_seed(0), "cpu",
                        dtype="bfloat16")
    assert b["rwkv.blocks.0.attention.time_decay"].dtype == torch.float32
    assert b["rwkv.blocks.0.ln1.weight"].dtype == torch.float32
    assert b["rwkv.blocks.0.attention.time_mix_key"].dtype == torch.bfloat16
    assert b["head.weight"].dtype == torch.bfloat16


def test_chat_over_http_matches_the_reference(tmp_path):
    chat_matches_the_reference(tmp_path, "rwkv")
