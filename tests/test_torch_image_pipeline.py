"""The port's diffusion pipeline against the JAX package's, on the CPU.

``generate`` end to end on the SD-1 layout for each step rule (txt2img),
img2img at strength 0.5 from an init image that is shrunk on one axis and
grown on the other, a ControlNet with a control image, and the SDXL layout
with an empty negative prompt (zero conditioning) and with a negative one
(the API's ``a|b``). Both packages hold the same float32 weights (the
JAX package's trees carried across); the port is fed the JAX package's
``jax.random`` draws, repeated here with its key splits (the first latent
draw, then one per ancestral step). The final latents agree within 1e-4
of their largest value, the uint8 pixels within 1. Also ``bucket_dim``,
``tokenize_clip``, SDXL's ``_tokenize2`` and the antialiased linear
resize against ``jax.image.resize``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.image import clip as jclip  # noqa: E402
from localai_tpu.image import pipeline as jpipe  # noqa: E402
from localai_tpu.image import schedulers as jsch  # noqa: E402
from localai_tpu.image import unet as junet  # noqa: E402
from localai_tpu.image import vae as jvae  # noqa: E402
from localai_tpu.utils.tokenizer import ByteTokenizer as JaxBytes  # noqa: E402
from localai_tpu_torch.image import clip as tclip  # noqa: E402
from localai_tpu_torch.image import controlnet as tcn  # noqa: E402
from localai_tpu_torch.image import pipeline as tpipe  # noqa: E402
from localai_tpu_torch.image import unet as tunet  # noqa: E402
from localai_tpu_torch.image import vae as tvae  # noqa: E402
from localai_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402
from test_torch_image_models import (  # noqa: E402
    CLIP1,
    CLIP2,
    SD1_UNET,
    SDXL_UNET,
    VAE,
    close,
    jax_cfg,
    pair,
)
from test_torch_llama import one_torch_thread  # noqa: E402,F401

STEPS = 3


def _pipelines(sdxl: bool):
    """(JAX pipeline, port pipeline) over one set of float32 weights."""
    ucfg = SDXL_UNET if sdxl else SD1_UNET
    ju, tu = pair(tunet.init_params, ucfg, 21)
    jv, tv = pair(tvae.init_params, VAE, 22)
    jt, tt = pair(tclip.init_params, CLIP1, 23)
    jkw, tkw = {}, {}
    if sdxl:
        jt2, tt2 = pair(tclip.init_params, CLIP2, 24)
        jkw = dict(text2_cfg=jax_cfg(jclip.CLIPTextConfig, CLIP2),
                   text2_params=jt2)
        tkw = dict(text2_cfg=CLIP2, text2_params=tt2)
    j = jpipe.DiffusionPipeline(
        jax_cfg(junet.UNetConfig, ucfg), ju, jax_cfg(jvae.VAEConfig, VAE), jv,
        jax_cfg(jclip.CLIPTextConfig, CLIP1), jt, JaxBytes(), **jkw)
    t = tpipe.DiffusionPipeline(ucfg, tu, VAE, tv, CLIP1, tt,
                                ByteTokenizer(), device="cpu", **tkw)
    if not sdxl:
        draw = lambda c, s, d: tcn.init_params(  # noqa: E731
            c, s, d, cond_channels=(8, 16))
        jc, tc = pair(draw, ucfg, 25)
        j.controlnet_cfg, j.controlnet_params = jax_cfg(
            junet.UNetConfig, ucfg), jc
        t.controlnet_cfg, t.controlnet_params = ucfg, tc
    return j, t


@pytest.fixture(scope="module")
def sd1():
    return _pipelines(False)


@pytest.fixture(scope="module")
def sdxl():
    return _pipelines(True)


def _jax_draws(seed: int, shape_nhwc, ancestral_steps: int):
    """The JAX package's draws for ``seed``, in its key-split order, as
    NCHW arrays."""
    rng = jax.random.key(seed)
    rng, nkey = jax.random.split(rng)
    out = [jax.random.normal(nkey, shape_nhwc, jnp.float32)]
    for _ in range(ancestral_steps):
        rng, k = jax.random.split(rng)
        out.append(jax.random.normal(k, shape_nhwc, jnp.float32))
    return [np.asarray(a).transpose(0, 3, 1, 2) for a in out]


def _run(pipes, *, seed=5, scheduler="euler", size=64, init=None,
         strength=0.75, control=None, **kw):
    j, t = pipes
    captured = []
    decode = j._decode
    j._decode = lambda x: (captured.append(np.asarray(x)), decode(x))[1]
    try:
        want = j.generate("a red fox", width=size, height=size,
                          steps=STEPS, seed=seed, scheduler=scheduler,
                          init_image=init, strength=strength,
                          control_image=control, **kw)
    finally:
        j._decode = decode
    rule, _ = jsch.resolve(scheduler)
    start = 0 if init is None else min(STEPS - 1,
                                       int(STEPS * (1.0 - strength)))
    n_anc = (STEPS - start) if rule in jsch.ANCESTRAL_RULES else 0
    lat = size // VAE.downscale
    noise = _jax_draws(seed, (1, lat, lat, 4), n_anc)
    got = t.generate("a red fox", width=size, height=size, steps=STEPS,
                     seed=seed, scheduler=scheduler, init_image=init,
                     strength=strength, control_image=control, noise=noise,
                     **kw)
    close(got.latents.numpy().transpose(0, 2, 3, 1), captured[0])
    assert got.image.shape == want.image.shape == (size, size, 3)
    diff = np.abs(got.image.astype(int) - want.image.astype(int))
    assert diff.max() <= 1, diff.max()
    assert got.seed == want.seed == seed
    return got


@pytest.mark.parametrize("scheduler", ["euler", "ddim", "k_euler_a",
                                       "dpmpp_2m"])
def test_txt2img_matches_for_each_rule(sd1, scheduler):
    _run(sd1, scheduler=scheduler, negative_prompt="blurry")


def test_img2img_at_half_strength_matches(sd1):
    init = np.random.default_rng(3).integers(0, 256, (48, 80, 3), np.uint8)
    _run(sd1, scheduler="euler_a", init=init, strength=0.5)


def test_control_image_matches(sd1):
    ctrl = np.random.default_rng(4).integers(0, 256, (96, 50, 3), np.uint8)
    _run(sd1, scheduler="dpmpp_2m", control=ctrl, control_scale=0.6)


@pytest.mark.parametrize("negative", ["", "watermark"],
                         ids=["empty-negative", "negative"])
def test_sdxl_matches(sdxl, negative):
    _run(sdxl, scheduler="euler_a", negative_prompt=negative)


def test_sdxl_empty_negative_is_zero_conditioning(sdxl):
    _, t = sdxl
    cond = t._prepare_cond("a fox", "", 64, 64)
    assert not cond["context"][0].any() and not cond["pooled"][0].any()
    assert cond["context"][1].abs().sum() > 0
    assert cond["time_ids"].tolist() == [[64, 64, 0, 0, 64, 64]] * 2


def test_fed_noise_of_another_shape_is_refused(sd1):
    _, t = sd1
    with pytest.raises(ValueError, match="fed noise"):
        t.generate("x", steps=1, seed=1, width=64, height=64,
                   noise=[np.zeros((1, 4, 8, 8))])


def test_seeded_generation_repeats_and_seed_none_draws_one(sd1):
    _, t = sd1
    kw = dict(steps=1, width=64, height=64)
    a = t.generate("x", seed=9, scheduler="euler_a", **kw)
    b = t.generate("x", seed=9, scheduler="euler_a", **kw)
    assert np.array_equal(a.image, b.image)
    c = t.generate("x", seed=None, **kw)
    assert 0 <= c.seed < 2 ** 31 - 1


# ---------------------------------------------------------------------------
# host helpers


@pytest.mark.parametrize("v", [-5, 0, 1, 63, 64, 65, 100, 511, 512, 513,
                               1024, 2047, 2048, 2049, 9999])
def test_bucket_dim_matches(v):
    assert tpipe.bucket_dim(v) == jpipe.bucket_dim(v)


@pytest.mark.parametrize("text", ["", "a cat", "x" * 40, "héllo wörld"])
def test_tokenize_clip_and_tokenize2_match(sdxl, text):
    j, t = sdxl
    np.testing.assert_array_equal(
        tpipe.tokenize_clip(ByteTokenizer(), CLIP1, text),
        jpipe.tokenize_clip(JaxBytes(), jax_cfg(jclip.CLIPTextConfig, CLIP1),
                            text))
    np.testing.assert_array_equal(t._tokenize2(text), j._tokenize2(text))


@pytest.mark.parametrize("src,dst", [((48, 80), (64, 64)),
                                     ((64, 64), (64, 64)),
                                     ((17, 300), (128, 64)),
                                     ((512, 512), (64, 192))])
def test_resize_linear_matches_jax_image_resize(src, dst):
    img = np.random.default_rng(5).random((1, *src, 3), np.float32) * 255
    want = jax.image.resize(jnp.asarray(img), (1, *dst, 3), "linear")
    got = tpipe.resize_linear(torch.from_numpy(
        img.transpose(0, 3, 1, 2).copy()), *dst)
    close(got.numpy().transpose(0, 2, 3, 1), want, tol=1e-5)
