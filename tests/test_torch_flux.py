"""The port's FLUX pipeline against the JAX package's, on the CPU.

T5's encoder (with and without a key mask), the MMDiT's rotary
embeddings, timestep embedding and sigma schedule, its forward pass with
the distilled guidance on and off, the latent packing, and whole
``generate`` runs of the ``debug:flux-tiny`` preset (txt2img and img2img
at strength 0.5) fed the JAX package's ``jax.random`` draw: both packages
hold the same float32 weights (the JAX package's trees carried across
with ``image.loader.from_jax_params``; the VAE and CLIP configs set to
float32). Tolerances: T5 states and the velocity within 1e-4 of the
largest output, the embeddings and sigmas within 1e-6, latents within
1e-4 of their largest value, uint8 pixels within 1.

A tiny FLUX directory written by the port (``transformer/``,
``text_encoder_2/`` in two shards, a Unigram ``tokenizer_2`` with a
``Precompiled`` charsmap, a scheduler config with
``use_dynamic_shifting: false, shift: 1.0``) loads in both packages
through ``resolve_image_model``: the MMDiT and T5 trees equal, the
token rows equal, the schedule's settings equal, and the latents of a
fed-noise ``generate`` within 2e-3 of their largest value (the VAE and
CLIP run in the JAX package's bfloat16 there). A VAE without quant
convs (the published FLUX layout) is refused by both alike, ``POST
/v1/images/generations`` on ``debug:flux-tiny`` answers on both HTTP
servers alike, and a ControlNet on a FLUX model is refused at load by
name (the JAX package fails with an AttributeError).
"""

import base64
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

import chip_smoke  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from localai_tpu.image import flux as jflux  # noqa: E402
from localai_tpu.image import mmdit as jmm  # noqa: E402
from localai_tpu.image import pipeline as jpipe  # noqa: E402
from localai_tpu.image import t5 as jt5  # noqa: E402
from localai_tpu_torch.image import clip as tclip  # noqa: E402
from localai_tpu_torch.image import flux as tflux  # noqa: E402
from localai_tpu_torch.image import loader as tload  # noqa: E402
from localai_tpu_torch.image import mmdit as tmm  # noqa: E402
from localai_tpu_torch.image import t5 as tt5  # noqa: E402
from localai_tpu_torch.image import vae as tvae  # noqa: E402
from localai_tpu_torch.image.pipeline import resolve_image_model  # noqa: E402
from localai_tpu_torch.utils.tokenizer import ByteTokenizer  # noqa: E402
from test_torch_image_models import close, jax_cfg  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

TOL = 1e-4


def carried(tree):
    """A JAX tree as float32 numpy (for the JAX side) and its port twin."""
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return (jax.tree.map(jnp.asarray, f32),
            tload.from_jax_params(f32, "cpu"))


def port_cfg(cls, cfg, **over):
    names = {f.name for f in dataclasses.fields(cls)}
    d = {k: tuple(v) if isinstance(v, list) else v
         for k, v in dataclasses.asdict(cfg).items() if k in names}
    return cls(**{**d, **over})


@pytest.fixture(scope="module")
def pipes():
    """(JAX, port) FLUX pipelines over ``debug:flux-tiny``'s JAX weights,
    every config in float32."""
    j = jflux.debug_flux_pipeline()
    vcfg = dataclasses.replace(j.vae_cfg, dtype="float32")
    ccfg = dataclasses.replace(j.clip_cfg, dtype="float32")
    jp, tp = carried(j.params)
    jv, tv = carried(j.vae_params)
    jc, tc = carried(j.clip_params)
    jt, tt = carried(j.t5_params)
    jpipe_ = jflux.FluxPipeline(j.cfg, jp, vcfg, jv, ccfg, jc,
                                j.clip_tokenizer, j.t5_cfg, jt,
                                j.t5_tokenizer, default_steps=3)
    tpipe = tflux.FluxPipeline(
        port_cfg(tmm.FluxConfig, j.cfg), tp,
        port_cfg(tvae.VAEConfig, vcfg), tv,
        port_cfg(tclip.CLIPTextConfig, ccfg), tc, ByteTokenizer(),
        port_cfg(tt5.T5Config, j.t5_cfg), tt, ByteTokenizer(),
        default_steps=3, device="cpu")
    return jpipe_, tpipe


# ---------------------------------------------------------------------------
# T5

T5_CFG = tt5.T5Config(vocab_size=300, d_model=48, d_kv=8, d_ff=96,
                      num_layers=3, num_heads=6,
                      relative_attention_num_buckets=16,
                      relative_attention_max_distance=32)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_t5_encode_matches(masked):
    jparams, params = carried(jax.tree.map(
        np.asarray, chip_smoke._perturbed(tt5.init_params(T5_CFG, 4, "cpu"),
                                          5)))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, T5_CFG.vocab_size, (2, 40)).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones((2, 40), bool)
        mask[0, 25:] = False
        mask[1, 33:] = False
    want = jt5.encode(jax_cfg(jt5.T5Config, T5_CFG), jparams,
                      jnp.asarray(ids),
                      None if mask is None else jnp.asarray(mask))
    got = tt5.encode(T5_CFG, params, torch.from_numpy(ids.astype(np.int64)),
                     None if mask is None else torch.from_numpy(mask))
    close(got.numpy(), np.asarray(want))


def test_t5_buckets_match():
    rel = np.arange(-300, 301)[None, :]
    for nb, md in ((32, 128), (8, 16)):
        want = np.asarray(jt5._relative_buckets(jnp.asarray(rel), nb, md))
        got = tt5.relative_buckets(torch.from_numpy(rel), nb, md).numpy()
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the MMDiT

MM_CFG = tmm.FluxConfig(in_channels=16, num_layers=2, num_single_layers=3,
                        attention_head_dim=16, num_attention_heads=3,
                        joint_attention_dim=40, pooled_projection_dim=24,
                        axes_dims_rope=(4, 6, 6))


def test_rope_timestep_and_sigmas_match():
    ids = np.zeros((37, 3), np.float32)
    ids[:, 1] = np.arange(37) // 6
    ids[:, 2] = np.arange(37) % 6
    ids[:5] = 0
    jcfg = jax_cfg(jmm.FluxConfig, MM_CFG)
    for a, b in zip(tmm.rope_3d(MM_CFG, torch.from_numpy(ids)),
                    jmm.rope_3d(jcfg, jnp.asarray(ids))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    # at sigma's scale within 1e-6; at the pipeline's sigma * 1000 within
    # the float32 spacing of the largest angle: XLA's float32 exp is not
    # correctly rounded (14 of the 128 frequencies differ from torch's by
    # an ulp), and an ulp of a frequency moves an angle near 1000 by about
    # that spacing
    t = np.array([0.0, 0.25, 0.731, 1.0], np.float32)
    for scale, tol in ((1.0, 1e-6), (1000.0, np.spacing(np.float32(1e3)))):
        np.testing.assert_allclose(
            tmm.timestep_embedding(torch.from_numpy(t * scale)).numpy(),
            np.asarray(jmm.timestep_embedding(jnp.asarray(t * scale))),
            atol=tol, rtol=0)
    for kw in ({}, {"dynamic": False, "shift": 1.0},
               {"dynamic": False, "shift": 3.0}):
        for steps, n in ((4, 4096), (28, 1024), (1, 256)):
            assert np.array_equal(tmm.flow_sigmas(steps, n, **kw),
                                  jmm.flow_sigmas(steps, n, **kw))


@pytest.mark.parametrize("guidance", [True, False], ids=["guidance",
                                                          "no-guidance"])
def test_mmdit_forward_matches(guidance):
    cfg = dataclasses.replace(MM_CFG, guidance_embeds=guidance)
    jparams, params = carried(jax.tree.map(np.asarray, chip_smoke._perturbed(
        tmm.init_params(cfg, 6, "cpu"), 7, std=0.02)))
    rng = np.random.default_rng(8)
    img = rng.normal(size=(2, 20, 16)).astype(np.float32)
    txt = rng.normal(size=(2, 7, 40)).astype(np.float32)
    pooled = rng.normal(size=(2, 24)).astype(np.float32)
    ts = np.array([0.9, 0.3], np.float32)
    img_ids = np.zeros((20, 3), np.float32)
    img_ids[:, 1] = np.arange(20) // 5
    img_ids[:, 2] = np.arange(20) % 5
    txt_ids = np.zeros((7, 3), np.float32)
    g = np.array([3.5, 1.0], np.float32) if guidance else None
    want = jmm.forward(jax_cfg(jmm.FluxConfig, cfg), jparams,
                       *map(jnp.asarray, (img, txt, pooled, ts, img_ids,
                                          txt_ids)),
                       guidance=None if g is None else jnp.asarray(g))
    got = tmm.forward(cfg, params, *map(torch.from_numpy, (
        img, txt, pooled, ts, img_ids, txt_ids)),
        guidance=None if g is None else torch.from_numpy(g))
    close(got.numpy(), np.asarray(want))


def test_param_shapes_and_init_match_the_jax_layout():
    shapes = tmm.param_shapes(MM_CFG)
    want = jmm.param_shapes(jax_cfg(jmm.FluxConfig, MM_CFG))
    assert shapes == want
    tree = tmm.init_params(MM_CFG, 0, "cpu")
    assert float(tree["double"]["qn_x"].min()) == 1.0
    assert float(tree["single"]["mod_b"].abs().max()) == 0.0
    assert 0.015 < float(tree["double"]["wq_x"].std()) < 0.025


# ---------------------------------------------------------------------------
# the pipeline


def test_pack_is_the_jax_layout_and_unpack_its_inverse():
    rng = np.random.default_rng(9)
    z = rng.normal(size=(1, 6, 8, 10)).astype(np.float32)       # NCHW
    packed = tflux.pack(torch.from_numpy(z))
    # the JAX package's _encode_img_fn packing, from NHWC
    x = z.transpose(0, 2, 3, 1).reshape(1, 4, 2, 5, 2, 6)
    want = x.transpose(0, 1, 3, 5, 2, 4).reshape(1, 20, 24)
    assert np.array_equal(packed.numpy(), want)
    assert np.array_equal(tflux.unpack(packed, 6, 8, 10).numpy(), z)


def _jax_noise(seed: int, n_img: int, c: int) -> np.ndarray:
    return np.asarray(jax.random.normal(jax.random.key(seed),
                                        (1, n_img, c), jnp.float32))


def _run(pipes, size=64, seed=5, **kw):
    j, t = pipes
    captured = []
    decode = j._decode
    j._decode = lambda x, h, w: (captured.append(np.asarray(x)),
                                 decode(x, h=h, w=w))[1]
    try:
        want = j.generate("a red fox", width=size, height=size, seed=seed,
                          **kw)
    finally:
        j._decode = decode
    lat = size // t.vae_cfg.downscale
    noise = _jax_noise(seed, (lat // 2) ** 2, 4 * t.vae_cfg.latent_channels)
    got = t.generate("a red fox", width=size, height=size, seed=seed,
                     noise=noise, **kw)
    close(got.latents.numpy(), captured[0])
    assert got.image.shape == want.image.shape == (size, size, 3)
    diff = np.abs(got.image.astype(int) - want.image.astype(int))
    assert diff.max() <= 1, diff.max()
    assert got.seed == want.seed == seed
    return got


def test_generate_matches(pipes):
    _run(pipes, cfg_scale=2.0)


def test_img2img_at_half_strength_matches(pipes):
    init = np.random.default_rng(10).integers(0, 256, (80, 48, 3), np.uint8)
    _run(pipes, init_image=init, strength=0.5, steps=4)


def test_fed_noise_of_another_shape_is_refused(pipes):
    with pytest.raises(ValueError, match="fed noise"):
        pipes[1].generate("x", width=64, height=64,
                          noise=np.zeros((1, 3, 16), np.float32))


def test_seeded_generation_repeats(pipes):
    t = pipes[1]
    a = t.generate("a", width=64, height=64, seed=3, steps=2)
    b = t.generate("a", width=64, height=64, seed=3, steps=2)
    assert np.array_equal(a.image, b.image)
    assert t.generate("a", width=64, height=64, steps=1).seed >= 0


def test_debug_preset_matches_the_jax_preset():
    """``debug:flux-tiny``: the JAX package's configs, tree shapes and
    defaults; the weights are the port's own draw."""
    j = jflux.debug_flux_pipeline()
    t = resolve_image_model("debug:flux-tiny", device="cpu")
    assert t.cfg == port_cfg(tmm.FluxConfig, j.cfg)
    assert t.t5_cfg == port_cfg(tt5.T5Config, j.t5_cfg)
    assert t.vae_cfg == port_cfg(tvae.VAEConfig, j.vae_cfg)
    assert t.clip_cfg == port_cfg(tclip.CLIPTextConfig, j.clip_cfg)
    shapes = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: tuple(a.shape), tree)
    assert shapes(jax.tree.map(np.asarray, j.t5_params)) == \
        shapes(t.t5_params)
    assert (t.default_steps, t.default_guidance, t.max_t5_len) == (
        j.default_steps, j.default_guidance, j.max_t5_len)
    out = t.generate("a fox", width=64, height=64, seed=1)
    assert out.image.shape == (64, 64, 3)


# ---------------------------------------------------------------------------
# a FLUX directory

DIR_MMDIT = dataclasses.replace(MM_CFG, in_channels=64,
                                joint_attention_dim=48,
                                pooled_projection_dim=32)
DIR_VAE = tvae.VAEConfig(base_channels=32, channel_mult=(1, 2),
                         num_res_blocks=1, latent_channels=16,
                         scaling_factor=0.3611, dtype="float32")
DIR_CLIP = tclip.CLIPTextConfig(vocab_size=600, hidden_size=32,
                                intermediate_size=64, num_layers=2,
                                num_heads=4, max_length=12,
                                eos_token_id=599, dtype="float32")


def write_flux_dir(root, *, shift: dict, quant_convs: bool = True,
                   tokenizer: bool = True):
    t5 = chip_smoke._perturbed(tt5.init_params(T5_CFG, 11, "cpu"), 12)
    vae_hf = {**tload.vae_hf_config(DIR_VAE), "shift_factor": 0.1159,
              "use_quant_conv": quant_convs,
              "use_post_quant_conv": quant_convs}
    vae = tvae.init_params(DIR_VAE, 13, "cpu")
    tload.write_diffusers_pipeline(
        root, vae=(DIR_VAE, vae), configs={"vae": vae_hf},
        text=(DIR_CLIP, tclip.init_params(DIR_CLIP, 14, "cpu")),
        transformer=(DIR_MMDIT, chip_smoke._perturbed(
            tmm.init_params(DIR_MMDIT, 15, "cpu"), 16, std=0.02)),
        t5=(T5_CFG, t5), t5_shards=2, dtype="float32")
    if not quant_convs:
        # the published FLUX VAE: no quant_conv / post_quant_conv tensors
        from localai_tpu_torch.models.loader import (
            read_safetensors_index,
            read_tensor,
            write_safetensors,
        )
        f = root / "vae" / "diffusion_pytorch_model.safetensors"
        idx = read_safetensors_index(f)
        keep = {k: read_tensor(v) for k, v in idx.items()
                if "quant_conv" not in k}
        write_safetensors(f, [(k, tuple(v.shape), v.dtype,
                               (lambda v=v: v)) for k, v in keep.items()])
    (root / "scheduler").mkdir(exist_ok=True)
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": "FlowMatchEulerDiscreteScheduler", **shift}))
    size = chip_smoke.CLIP_VOCAB
    try:
        chip_smoke.CLIP_VOCAB = DIR_CLIP.vocab_size
        chip_smoke.write_clip_tokenizer(root / "tokenizer")
    finally:
        chip_smoke.CLIP_VOCAB = size
    if tokenizer:
        chip_smoke.write_t5_tokenizer(root / "tokenizer_2", pieces=240,
                                      extra_ids=7)
    return root


@pytest.fixture(scope="module")
def flux_dir(tmp_path_factory):
    return write_flux_dir(tmp_path_factory.mktemp("flux") / "flux",
                          shift={"use_dynamic_shifting": False,
                                 "shift": 1.0})


def test_flux_directory_loads_and_generates_alike(flux_dir):
    j = jpipe.resolve_image_model(str(flux_dir))
    t = resolve_image_model(str(flux_dir), device="cpu",
                            lora_adapter="dropped", lora_scale=0.3)
    assert isinstance(t, tflux.FluxPipeline)
    assert sorted(p.name for p in (flux_dir / "text_encoder_2").glob(
        "*.safetensors")) == ["model-00001-of-00002.safetensors",
                              "model-00002-of-00002.safetensors"]
    for mine, theirs in ((t.params, j.params), (t.t5_params, j.t5_params)):
        flat_j = jax.tree_util.tree_flatten_with_path(theirs)[0]
        for path, a in flat_j:
            node = mine
            for k in path:
                node = node[k.key]
            assert np.array_equal(node.numpy(), np.asarray(a)), path
    assert (t.dynamic_shift, t.shift) == (j.dynamic_shift, j.shift) == (
        False, 1.0)
    assert (t.vae_shift, t.vae_scale) == (j.vae_shift, j.vae_scale)
    for text in ("a red fox in ｆｕｌｌ width", "café  é́", ""):
        assert np.array_equal(t._tokenize_t5(text), j._tokenize_t5(text))
        assert np.array_equal(t._tokenize_clip(text), j._tokenize_clip(text))
    captured = []
    decode = j._decode
    j._decode = lambda x, h, w: (captured.append(np.asarray(x)),
                                 decode(x, h=h, w=w))[1]
    want = j.generate("a red fox", width=64, height=64, seed=4, steps=3)
    got = t.generate("a red fox", width=64, height=64, seed=4, steps=3,
                     noise=_jax_noise(4, 256, 64))
    close(got.latents.numpy(), captured[0], tol=2e-3)
    assert got.image.shape == want.image.shape == (64, 64, 3)


def test_vae_without_quant_convs_is_refused_alike(tmp_path):
    """A limit of the reference the port keeps: the published FLUX VAE
    (``use_quant_conv: false``) has no quant_conv tensors, which both
    loaders read unconditionally."""
    d = write_flux_dir(tmp_path / "flux", shift={}, quant_convs=False)
    with pytest.raises(KeyError, match="quant_conv"):
        jpipe.resolve_image_model(str(d))
    with pytest.raises(KeyError, match="quant_conv"):
        resolve_image_model(str(d), device="cpu")


def test_tokenizer_2_fallbacks(tmp_path):
    """No tokenizer files: the byte tokenizer, as the JAX package's
    ``AutoTokenizer`` failure gives; a component the port's reader lacks
    is refused at load, by name."""
    assert type(tflux.load_t5_tokenizer(tmp_path)).__name__ == \
        "ByteTokenizer"
    (tmp_path / "tokenizer.json").write_text(json.dumps({
        "model": {"type": "Unigram", "unk_id": 0, "vocab": [["a", 0.0]]},
        "normalizer": {"type": "Nmt"}}))
    with pytest.raises(ValueError, match="Nmt"):
        tflux.load_t5_tokenizer(tmp_path)


# ---------------------------------------------------------------------------
# serving


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from localai_tpu_torch.api.server import APIServer
    from localai_tpu_torch.config.app_config import AppConfig
    from localai_tpu_torch.config.loader import ConfigLoader
    from localai_tpu_torch.models.manager import ModelManager
    from test_api import _ServerThread, make_state

    root = tmp_path_factory.mktemp("flux-serve")
    models = root / "models"
    models.mkdir()
    (models / "flux.yaml").write_text(yaml.safe_dump(
        {"name": "flux", "backend": "diffusers", "model": "debug:flux-tiny",
         "diffusers": {"steps": 2, "cfg_scale": 2.5}}))
    (models / "fluxcn.yaml").write_text(yaml.safe_dump(
        {"name": "fluxcn", "backend": "diffusers",
         "model": "debug:flux-tiny",
         "diffusers": {"control_net": "some-controlnet"}}))
    loader = ConfigLoader(models)
    loader.load_from_path()
    manager = ModelManager(AppConfig(model_path=str(models), device="cpu",
                                     image_path=str(root / "port")), loader)
    port = APIServer(manager, "127.0.0.1", 0).start()
    state = make_state(models)
    state.config.image_path = str(root / "jax")
    ref = _ServerThread(state)
    yield {"port": port.url, "ref": ref.base, "manager": manager}
    ref.stop()
    port.shutdown()


def test_images_route_answers_alike(servers):
    from localai_tpu_torch.utils import png
    from test_torch_images_api import GEN, _post

    body = {"model": "flux", "prompt": "a lighthouse|ignored",
            "size": "63x45", "response_format": "b64_json", "seed": 7}
    answers = []
    for base in (servers["port"], servers["ref"]):
        status, out = _post(base + GEN, body)
        assert status == 200, out
        assert set(out) == {"id", "created", "data"}
        assert [set(d) for d in out["data"]] == [{"b64_json"}]
        answers.append(png.decode(base64.b64decode(
            out["data"][0]["b64_json"])).shape)
    assert answers == [(45, 63, 3)] * 2
    sm = servers["manager"].get_image("flux")
    assert isinstance(sm.pipeline, tflux.FluxPipeline)
    assert (sm.pipeline.default_steps, sm.pipeline.default_guidance) == (
        2, 2.5)


def test_controlnet_on_flux_is_refused_by_name(servers):
    assert not hasattr(jflux.FluxPipeline, "attach_controlnet")
    with pytest.raises(ValueError, match="ControlNet.*FLUX"):
        servers["manager"].get_image("fluxcn")
