"""The port's MusicGen-class generator against the JAX package's, on the
CPU.

Both packages take the same tiny random ``transformers`` checkpoints
(``MusicgenForCausalLM`` and ``EncodecModel`` at ``tests/test_musicgen.py``'s
widths) through their ``*_from_torch`` adapters, or the JAX package's
debug-preset trees carried across (``from_numpy``). Tolerances: LM
logits and EnCodec audio within 1e-4 (float32); greedy codes equal code
for code. The port samples from ``torch.Generator``s, so sampled codes
are its own; greedy decoding (``temperature <= 0``) is compared.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.audio import musicgen as jmg  # noqa: E402
from localai_tpu_torch.audio import musicgen as tmg  # noqa: E402
from test_musicgen import CFG, torch_encodec, torch_lm  # noqa: E402,F401
from test_torch_llama import one_torch_thread  # noqa: E402,F401

TOL = 1e-4
TCFG = tmg.MusicgenConfig(**vars(CFG))


def _state(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x) if hasattr(x, "shape")
                        else x, tree)


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("cross", [True, False], ids=["memory", "no-memory"])
def test_lm_forward_matches(torch_lm, cross, offset):
    state = _state(torch_lm)
    ref = jmg.lm_params_from_torch(state, CFG)
    ours = tmg.lm_params_from_torch(state, TCFG, "cpu")
    rng = np.random.default_rng(0)
    codes = rng.integers(0, CFG.vocab_size + 1, (CFG.num_codebooks, 9))
    memory = rng.normal(size=(5, CFG.hidden_size)).astype(np.float32)
    want = np.asarray(jmg.lm_forward(
        CFG, ref, jnp.asarray(codes), jnp.asarray(memory) if cross else None,
        offset=offset))
    got = tmg.lm_forward(TCFG, ours, torch.from_numpy(codes),
                         torch.from_numpy(memory) if cross else None,
                         offset=offset)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("masked", [True, False])
def test_greedy_codes_equal(torch_lm, masked):
    """The delay-pattern sampler at temperature 0: the port's frames-long
    run gives the codes of the JAX package's bucket, code for code."""
    state = _state(torch_lm)
    ref = jmg.lm_params_from_torch(state, CFG)
    ours = tmg.lm_params_from_torch(state, TCFG, "cpu")
    rng = np.random.default_rng(1)
    memory = rng.normal(size=(8, CFG.hidden_size)).astype(np.float32)
    mask = np.arange(8) < 5
    frames = 13
    want = np.asarray(jmg.generate_codes(
        CFG, ref, jnp.asarray(memory), jax.random.key(0), frames=16,
        temperature=0.0, memory_mask=jnp.asarray(mask) if masked else None
    ))[:, :frames]
    got = tmg.generate_codes(
        TCFG, ours, torch.from_numpy(memory), frames=frames,
        temperature=0.0,
        memory_mask=torch.from_numpy(mask) if masked else None)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_codes_follow_the_generator(torch_lm):
    """Sampling draws from the generator: one seed repeats its codes,
    every code lies in the vocabulary, and a codebook stays BOS-free."""
    ours = tmg.lm_params_from_torch(_state(torch_lm), TCFG, "cpu")
    memory = torch.randn(4, CFG.hidden_size, generator=torch.Generator()
                         .manual_seed(0))

    def run(seed):
        return tmg.generate_codes(
            TCFG, ours, memory, frames=10, temperature=1.0, top_k=8,
            generator=torch.Generator().manual_seed(seed))

    a = run(7)
    assert torch.equal(a, run(7))
    assert a.shape == (CFG.num_codebooks, 10)
    assert int(a.min()) >= 0 and int(a.max()) < CFG.vocab_size


def test_encodec_decode_matches(torch_encodec):
    state = _state(torch_encodec)
    ref = jmg.encodec_params_from_torch(state, CFG)
    ours = tmg.encodec_params_from_torch(state, TCFG, "cpu")
    codes = np.random.default_rng(2).integers(
        0, CFG.vocab_size, (CFG.num_codebooks, 11))
    want = np.asarray(jmg.encodec_decode(CFG, ref, jnp.asarray(codes)))
    got = tmg.encodec_decode(TCFG, ours, torch.from_numpy(codes))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_generator_carried_across_generates_the_same_audio():
    """The serving engine (the debug preset's widths: 4 codebooks, SEANet
    8/5/4) with the JAX package's weights: greedy codes equal and the
    peak-normalised audio within 1e-4; then the port's own seeded preset
    generates finite audio of the asked length."""
    ref = jmg.MusicGenerator()
    ours = tmg.MusicGenerator(device="cpu")
    ours.lm = tmg.from_numpy(_numpy_tree(ref.lm), "cpu")
    ours.dec = tmg.from_numpy(_numpy_tree(ref.dec), "cpu")
    ours.text_embed = torch.from_numpy(np.asarray(ref.text_embed))
    mem_ref, mask_ref = ref.text_memory("rain on a tin roof")
    mem, mask = ours.text_memory("rain on a tin roof")
    # the sinusoids round apart by a few float32 ulps (XLA folds constants)
    np.testing.assert_allclose(mem.numpy(), np.asarray(mem_ref), atol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_ref))
    want = ref.generate("rain on a tin roof", 0.3, temperature=0.0)
    got = ours.generate("rain on a tin roof", 0.3, temperature=0.0)
    assert got.shape == want.shape == (4800,)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    own = tmg.MusicGenerator(device="cpu").generate("birdsong", 0.5)
    assert own.shape == (8000,) and np.isfinite(own).all()
    assert 0.69 < np.abs(own).max() <= 0.7 + 1e-6


def test_init_params_follow_the_jax_shapes():
    lm, dec = tmg.init_params(tmg.MusicgenConfig(), 0, "cpu")
    jlm, jdec = jmg.init_params(jax.random.key(0), jmg.MusicgenConfig())
    shapes = jax.tree.map(lambda x: tuple(x.shape) if hasattr(x, "shape")
                          else x, (jlm, jdec))
    ours = jax.tree.map(lambda x: tuple(x.shape) if hasattr(x, "shape")
                        else x, (lm, dec))
    assert _listed(ours) == _listed(shapes)


def _listed(tree):
    if isinstance(tree, dict):
        return {k: _listed(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not all(
            isinstance(x, int) for x in tree):
        return [_listed(v) for v in tree]
    return tree
