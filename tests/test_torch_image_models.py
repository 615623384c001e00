"""The port's image models against the JAX package's, on the CPU.

The CLIP text encoder (``quick_gelu`` and ``gelu``, ``clip_skip``,
``encode_sdxl``'s projected pooled output), the UNet on the SD-1 layout
and on the SDXL layout (transformer depth 1 and 2 by level, heads per
level, the text_time MLP, ControlNet's residuals), the ControlNet pass and
the VAE's decode and encode (the posterior's mean, and a sample with the
JAX package's draw fed in) at debug widths in float32. Each tree is drawn
once (seeded; every leaf perturbed, so gains and biases are not 1 and 0),
handed to the JAX package in its layout (HWIO convs) and carried back with
``image.loader.from_jax_params``. Inputs come from a numpy seed.
Tolerance: the largest absolute error within 1e-4 of the largest output.

The helpers here (configs, trees, ``to_jax``) are shared by the other
image test files.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.image import clip as jclip  # noqa: E402
from localai_tpu.image import controlnet as jcn  # noqa: E402
from localai_tpu.image import unet as junet  # noqa: E402
from localai_tpu.image import vae as jvae  # noqa: E402
from localai_tpu_torch.image import clip as tclip  # noqa: E402
from localai_tpu_torch.image import controlnet as tcn  # noqa: E402
from localai_tpu_torch.image import unet as tunet  # noqa: E402
from localai_tpu_torch.image import vae as tvae  # noqa: E402
from localai_tpu_torch.image.loader import (  # noqa: E402
    from_jax_params,
    map_tree,
)
from test_torch_llama import one_torch_thread  # noqa: E402,F401

TOL = 1e-4

# chip_smoke's debug-width layouts (its card = CPU phase runs the same):
# SD-1 (1x1 proj_in, one encoder, two blocks a transformer) and SDXL (no
# attention at level 0, 1 / 2 blocks by level, heads per level, the
# text_time MLP over encoder 2's pooled 24 + 6 x 8)
LAYOUTS = chip_smoke._image_layouts()
SD1_UNET = LAYOUTS["sd1"]["unet"]
SDXL_UNET = LAYOUTS["sdxl"]["unet"]
CLIP1 = LAYOUTS["sdxl"]["text"]
CLIP2 = LAYOUTS["sdxl"]["text2"]
VAE = LAYOUTS["sd1"]["vae"]
perturbed = chip_smoke._perturbed


def jax_cfg(cls, cfg):
    """The JAX package's config with the port config's shared fields."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(cfg).items()
                  if k in names})


def to_jax(tree):
    """A port tree in the JAX package's layout: numpy float32, conv
    kernels OIHW → HWIO."""
    def conv(t):
        a = t.float().numpy()
        return jnp.asarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)
    return map_tree(tree, conv)


def pair(draw, cfg, seed):
    """(JAX tree, port tree carried back from it) of one drawn tree."""
    jtree = to_jax(perturbed(draw(cfg, seed, "cpu"), seed + 100))
    return jtree, from_jax_params(jtree, "cpu")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1e-6)
    assert err <= tol * scale, (err, scale)


def tokens(seed, cfg, B=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size - 1, size=(B, cfg.max_length))
    ids[:, -3:] = cfg.eos_token_id            # the end token, highest id
    return ids.astype(np.int32)


# ---------------------------------------------------------------------------
# CLIP


@pytest.mark.parametrize("cfg", [CLIP1, CLIP2], ids=["quick_gelu", "gelu"])
@pytest.mark.parametrize("clip_skip", [0, 2])
def test_clip_hidden_states_match(cfg, clip_skip):
    jp, tp = pair(tclip.init_params, cfg, 1)
    ids = tokens(2, cfg)
    want = jclip.forward(jax_cfg(jclip.CLIPTextConfig, cfg), jp,
                         jnp.asarray(ids), clip_skip=clip_skip)
    got = tclip.forward(cfg, tp, torch.from_numpy(ids).long(),
                        clip_skip=clip_skip)
    close(got.numpy(), want)


def test_clip_encode_sdxl_matches_with_the_projection():
    jp, tp = pair(tclip.init_params, CLIP2, 3)
    assert "text_projection" in tp
    ids = tokens(4, CLIP2)
    ids[0, 5] = CLIP2.eos_token_id   # the first end token is the argmax
    jh, jpool = jclip.encode_sdxl(jax_cfg(jclip.CLIPTextConfig, CLIP2), jp,
                                  jnp.asarray(ids))
    th, tpool = tclip.encode_sdxl(CLIP2, tp, torch.from_numpy(ids).long())
    close(th.numpy(), jh)
    close(tpool.numpy(), jpool)
    assert tpool.shape == (2, 24)


# ---------------------------------------------------------------------------
# UNet and ControlNet


def _unet_inputs(cfg, seed, hw=16):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(2, hw, hw, 4)).astype(np.float32)
    ts = np.asarray([999.0, 17.5], np.float32)
    ctx = rng.normal(size=(2, 7, cfg.context_dim)).astype(np.float32)
    pooled = rng.normal(size=(2, 24)).astype(np.float32)
    tids = np.asarray([[64, 48, 0, 0, 64, 48]] * 2, np.float32)
    return lat, ts, ctx, pooled, tids


def _residuals(cfg, seed, hw=16):
    """ControlNet-shaped residuals, one per skip, then the mid one
    (NHWC)."""
    rng = np.random.default_rng(seed)
    mc = cfg.model_channels
    shapes, size = [(hw, mc)], hw
    for lvl, mult in enumerate(cfg.channel_mult):
        shapes += [(size, mc * mult)] * cfg.num_res_blocks
        if lvl != len(cfg.channel_mult) - 1:
            size //= 2
            shapes.append((size, mc * mult))
    down = [rng.normal(size=(2, s, s, c)).astype(np.float32) * 0.3
            for s, c in shapes]
    mid = rng.normal(size=(2, size, size, mc * cfg.channel_mult[-1])
                     ).astype(np.float32) * 0.3
    return down, mid


@pytest.mark.parametrize("layout", ["sd1", "sdxl"])
@pytest.mark.parametrize("control", [False, True],
                         ids=["plain", "residuals"])
def test_unet_eps_matches(layout, control):
    cfg = SD1_UNET if layout == "sd1" else SDXL_UNET
    jp, tp = pair(tunet.init_params, cfg, 5)
    lat, ts, ctx, pooled, tids = _unet_inputs(cfg, 6)
    extra_j, extra_t = {}, {}
    if cfg.addition_embed:
        extra_j = dict(pooled_text=jnp.asarray(pooled),
                       time_ids=jnp.asarray(tids))
        extra_t = dict(pooled_text=torch.from_numpy(pooled),
                       time_ids=torch.from_numpy(tids))
    if control:
        down, mid = _residuals(cfg, 7)
        extra_j.update(down_residuals=[jnp.asarray(d) for d in down],
                       mid_residual=jnp.asarray(mid))
        extra_t.update(down_residuals=[nchw(d) for d in down],
                       mid_residual=nchw(mid))
    want = junet.forward(jax_cfg(junet.UNetConfig, cfg), jp,
                         jnp.asarray(lat), jnp.asarray(ts),
                         jnp.asarray(ctx), **extra_j)
    got = tunet.forward(cfg, tp, nchw(lat), torch.from_numpy(ts),
                        torch.from_numpy(ctx), **extra_t)
    close(nhwc(got), want)


@pytest.mark.parametrize("layout", ["sd1", "sdxl"])
def test_controlnet_residuals_match(layout):
    cfg = SD1_UNET if layout == "sd1" else SDXL_UNET
    draw = lambda c, s, d: tcn.init_params(c, s, d,  # noqa: E731
                                           cond_channels=(8, 16, 24))
    jp, tp = pair(draw, cfg, 8)
    lat, ts, ctx, pooled, tids = _unet_inputs(cfg, 9)
    img = np.random.default_rng(10).random((2, 64, 64, 3), np.float32)
    kw_j = kw_t = {}
    if cfg.addition_embed:
        kw_j = dict(pooled_text=jnp.asarray(pooled),
                    time_ids=jnp.asarray(tids))
        kw_t = dict(pooled_text=torch.from_numpy(pooled),
                    time_ids=torch.from_numpy(tids))
    jd, jm = jcn.forward(jax_cfg(junet.UNetConfig, cfg), jp,
                         jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(ctx),
                         jnp.asarray(img), conditioning_scale=0.7, **kw_j)
    td, tm = tcn.forward(cfg, tp, nchw(lat), torch.from_numpy(ts),
                         torch.from_numpy(ctx), nchw(img),
                         conditioning_scale=0.7, **kw_t)
    assert len(td) == len(jd) == len(tp["zero_convs"])
    for a, b in zip(td, jd):
        close(nhwc(a), b)
    close(nhwc(tm), jm)


def test_conv_padding_is_xla_same_on_odd_sizes():
    """A stride-2 "SAME" conv pads (0, 1) on an even axis and (1, 1) on
    an odd one, as XLA does."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 3, 5, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    for h, wd in ((8, 8), (9, 7), (5, 6)):
        x = rng.normal(size=(1, h, wd, 5)).astype(np.float32)
        want = junet.conv2d(jnp.asarray(x), {"w": w, "b": b}, stride=2)
        got = tunet.conv2d(nchw(x), {"w": torch.from_numpy(
            w.transpose(3, 2, 0, 1).copy()), "b": torch.from_numpy(b)},
            stride=2)
        close(nhwc(got), want)


# ---------------------------------------------------------------------------
# VAE


def test_vae_decode_matches():
    jp, tp = pair(tvae.init_params, VAE, 11)
    lat = np.random.default_rng(12).normal(size=(1, 8, 8, 4)).astype(
        np.float32)
    want = jvae.decode(jax_cfg(jvae.VAEConfig, VAE), jp, jnp.asarray(lat))
    got = tvae.decode(VAE, tp, nchw(lat))
    assert got.shape == (1, 3, 16, 16)
    close(nhwc(got), want)


@pytest.mark.parametrize("sample", [False, True], ids=["mean", "sample"])
def test_vae_encode_matches(sample):
    jp, tp = pair(tvae.init_params, VAE, 13)
    img = np.random.default_rng(14).uniform(
        -1, 1, size=(1, 16, 16, 3)).astype(np.float32)
    rng = jax.random.key(3) if sample else None
    want = jvae.encode(jax_cfg(jvae.VAEConfig, VAE), jp, jnp.asarray(img),
                       rng=rng)
    noise = (nchw(np.asarray(jax.random.normal(rng, (1, 8, 8, 4))))
             if sample else None)
    got = tvae.encode(VAE, tp, nchw(img), noise=noise)
    close(nhwc(got), want)


def test_from_jax_params_is_exact_and_keeps_dtypes():
    """bfloat16 leaves cross bit for bit and stay bfloat16; conv kernels
    come back OIHW; None levels stay None."""
    tree = tunet.init_params(SD1_UNET, 0, "cpu")
    jtree = map_tree(to_jax(tree), lambda a: a.astype(
        jnp.bfloat16) if a.ndim > 1 else a)
    back = from_jax_params(jtree, "cpu")
    w = back["down"][0]["res"][0]["conv1"]["w"]
    assert w.dtype == torch.bfloat16 and w.shape == (32, 32, 3, 3)
    assert torch.equal(w, tree["down"][0]["res"][0]["conv1"]["w"].to(
        torch.bfloat16))
    assert back["down"][0]["res"][0]["norm1"]["g"].dtype == torch.float32
    sdxl = from_jax_params(to_jax(tunet.init_params(SDXL_UNET, 0, "cpu")),
                           "cpu")
    assert sdxl["down"][0]["attn"] is None
    assert [len(a["blocks"]) for a in sdxl["down"][1]["attn"]] == [1]
    assert len(sdxl["mid"]["attn"]["blocks"]) == 2
