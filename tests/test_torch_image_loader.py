"""The port's diffusers-layout loader against the JAX package's, on the
CPU.

SD-1 and SDXL directories (``text_encoder_2/`` and ``tokenizer_2/``, a
linear ``proj_in``, per-level transformer depth) written by the port's
``write_diffusers_pipeline`` from seeded trees, in float32 and in
float16: both packages load them, and every parameter is equal bit for
bit after the JAX package's cast (matrices to bfloat16, vectors float32).
A LoRA in the kohya layout and in the diffusers/peft layout (linear, 3x3
and 1x1 conv targets, text-encoder targets, alpha present and missing)
merges to the JAX package's weights bit for bit, a ControlNet directory
loads alike, a bfloat16 directory (which the JAX package's numpy reader
cannot open) round-trips exactly on the port, and a FLUX layout and
``debug:flux-tiny`` route to the FLUX pipeline.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("safetensors")
pytest.importorskip("transformers")

from localai_tpu.image import controlnet as jcn  # noqa: E402
from localai_tpu.image import loader as jload  # noqa: E402
from localai_tpu.image import lora as jlora  # noqa: E402
from localai_tpu_torch.image import clip as tclip  # noqa: E402
from localai_tpu_torch.image import controlnet as tcn  # noqa: E402
from localai_tpu_torch.image import loader as tload  # noqa: E402
from localai_tpu_torch.image import lora as tlora  # noqa: E402
from localai_tpu_torch.image import unet as tunet  # noqa: E402
from localai_tpu_torch.image import vae as tvae  # noqa: E402
from localai_tpu_torch.image.pipeline import resolve_image_model  # noqa: E402
from localai_tpu_torch.models.loader import write_safetensors  # noqa: E402
from test_torch_clip_tokenizer import write_clip_tokenizer  # noqa: E402
from test_torch_image_models import (  # noqa: E402
    CLIP1,
    CLIP2,
    SD1_UNET,
    SDXL_UNET,
    VAE,
    perturbed,
)
from test_torch_llama import one_torch_thread  # noqa: E402,F401


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_trees_equal(port, ref, path="") -> None:
    """A port tree (OIHW) equal bit for bit to a JAX package tree (HWIO),
    dtype included."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (path, set(port) ^ set(ref))
        for k in ref:
            assert_trees_equal(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_trees_equal(a, b, f"{path}[{i}]")
    elif ref is None:
        assert port is None, path
    else:
        want = np.asarray(ref)
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        t = port.detach().cpu()
        got = (t.view(torch.int16) if t.dtype == torch.bfloat16
               else t).numpy()
        assert str(t.dtype).split(".")[1] == str(want.dtype), (
            path, t.dtype, want.dtype)
        assert np.array_equal(got, _bits(want)), path


def _trees(sdxl: bool, seed: int = 0):
    ucfg = SDXL_UNET if sdxl else SD1_UNET
    out = {"unet": (ucfg, perturbed(tunet.init_params(ucfg, seed, "cpu"),
                                    seed + 1)),
           "vae": (VAE, perturbed(tvae.init_params(VAE, seed + 2, "cpu"),
                                  seed + 3)),
           "text": (CLIP1, perturbed(tclip.init_params(CLIP1, seed + 4,
                                                       "cpu"), seed + 5))}
    if sdxl:
        out["text2"] = (CLIP2, perturbed(
            tclip.init_params(CLIP2, seed + 6, "cpu"), seed + 7))
    return out


def _write(root, sdxl: bool, dtype=None, seed: int = 0):
    trees = _trees(sdxl, seed)
    tload.write_diffusers_pipeline(root, dtype=dtype, **trees)
    write_clip_tokenizer(root / "tokenizer")
    if sdxl:
        write_clip_tokenizer(root / "tokenizer_2", pad="!")
    return trees


@pytest.mark.parametrize("dtype", [None, "float16"], ids=["f32", "f16"])
@pytest.mark.parametrize("sdxl", [False, True], ids=["sd1", "sdxl"])
def test_both_packages_load_the_same_parameters(tmp_path, sdxl, dtype):
    _write(tmp_path, sdxl, dtype)
    ours = resolve_image_model(str(tmp_path), device="cpu")
    ref = jload.load_diffusers_pipeline(tmp_path)
    assert ours.is_sdxl == ref.is_sdxl == sdxl
    assert_trees_equal(ours.unet_params, ref.unet_params, "unet")
    assert_trees_equal(ours.vae_params, ref.vae_params, "vae")
    assert_trees_equal(ours.text_params, ref.text_params, "text")
    for f in ("in_channels", "model_channels", "channel_mult",
              "num_res_blocks", "attn_levels", "num_heads",
              "heads_per_level", "context_dim", "addition_embed",
              "addition_time_embed_dim", "transformer_depth"):
        assert getattr(ours.unet_cfg, f) == getattr(ref.unet_cfg, f), f
    assert ours.unet_cfg.depth_per_level == (
        SDXL_UNET.depth_per_level if sdxl else ())
    assert ours.vae_cfg.__dict__ == ref.vae_cfg.__dict__
    assert ours.text_cfg.max_length == ref.text_cfg.max_length
    if sdxl:
        assert_trees_equal(ours.text2_params, ref.text2_params, "text2")
        assert "text_projection" in ours.text2_params
        for text in ("A photo of a CAT, 4k!", "", "x" * 50):
            np.testing.assert_array_equal(ours._tokenize2(text),
                                          ref._tokenize2(text))
    for text in ("A photo of a CAT, 4k!", "", "naïve café 1984"):
        np.testing.assert_array_equal(ours._tokenize(text),
                                      ref._tokenize(text))


def test_bfloat16_directory_round_trips_exactly(tmp_path):
    trees = _write(tmp_path, True, "bfloat16")
    ours = resolve_image_model(str(tmp_path), device="cpu")
    want = tload._to_device(trees["unet"][1], "bfloat16", "cpu")
    got = ours.unet_params
    w, g = (want["mid"]["attn"]["blocks"][1]["attn2"]["wk"],
            got["mid"]["attn"]["blocks"][1]["attn2"]["wk"])
    assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    # a vector written in bf16 loads as float32 of the bf16 value
    b = trees["unet"][1]["conv_in"]["b"].to(torch.bfloat16).float()
    assert torch.equal(got["conv_in"]["b"], b)
    # SDXL's linear proj_in was written as [out, in]
    from localai_tpu_torch.models.loader import read_safetensors_index
    idx = read_safetensors_index(
        tmp_path / "unet" / "diffusion_pytorch_model.safetensors")
    assert idx["mid_block.attentions.0.proj_in.weight"][4] == (64, 64)


# ---------------------------------------------------------------------------
# LoRA


def _lora_file(path, layout: str, rank: int = 3, seed: int = 0):
    """A LoRA over SD1_UNET / CLIP1's modules, in ``layout``."""
    rng = np.random.default_rng(seed)
    # (component, module, in, out, kernel) — a 1x1 proj_in, a 3x3 conv, a
    # linear projection of the UNet, two of the text encoder
    mods = [("unet", "down_blocks.0.attentions.0.transformer_blocks.1."
             "attn1.to_q", 32, 32, None),
            ("unet", "down_blocks.0.attentions.0.proj_in", 32, 32, 1),
            ("unet", "mid_block.resnets.0.conv1", 64, 64, 3),
            ("unet", "up_blocks.0.attentions.1.transformer_blocks.0."
             "ff.net.2", 256, 64, None),
            ("te", "text_model.encoder.layers.1.self_attn.v_proj", 48, 48,
             None),
            ("te", "text_model.encoder.layers.2.mlp.fc1", 48, 96, None)]
    tensors = {}
    for i, (comp, mod, cin, cout, k) in enumerate(mods):
        down = rng.normal(size=(rank, cin) + ((k, k) if k else ())) * 0.1
        up = rng.normal(size=(cout, rank) + ((1, 1) if k else ())) * 0.1
        alpha = None if i == 2 else float(rank * (i + 1)) / 2
        if layout == "kohya":
            key = f"lora_{comp}_{mod.replace('.', '_')}"
            tensors[f"{key}.lora_down.weight"] = down
            tensors[f"{key}.lora_up.weight"] = up
            if alpha is not None:
                tensors[f"{key}.alpha"] = np.float32(alpha)
        else:
            pre = "unet." if comp == "unet" else "text_encoder."
            tensors[f"{pre}{mod}.lora_A.weight"] = down
            tensors[f"{pre}{mod}.lora_B.weight"] = up
            if alpha is not None:
                tensors[f"{pre}{mod}.alpha"] = np.float32(alpha)
    write_safetensors(path, [
        (name, tuple(np.shape(a)), torch.float32,
         (lambda a=a: torch.tensor(np.asarray(a, np.float32))))
        for name, a in tensors.items()])
    return len(mods)


@pytest.mark.parametrize("layout", ["kohya", "peft"])
def test_lora_merges_to_the_jax_weights(tmp_path, layout):
    _write(tmp_path, False)
    n = _lora_file(tmp_path / "lora.safetensors", layout)
    tcfg, tun = tload.load_unet(tmp_path / "unet")
    _, tte = tload.load_text_encoder(tmp_path / "text_encoder")
    _, jun = jload.load_unet(tmp_path / "unet")
    _, jte = jload.load_text_encoder(tmp_path / "text_encoder")
    before = tun["mid"]["res1"]["conv1"]["w"].clone()
    assert tlora.apply_lora(tun, tte, tmp_path / "lora.safetensors",
                            scale=0.8) == n
    assert jlora.apply_lora(jun, jte, tmp_path / "lora.safetensors",
                            scale=0.8) == n
    assert not torch.equal(before, tun["mid"]["res1"]["conv1"]["w"])
    assert_trees_equal(tun, jun, "unet")
    assert_trees_equal(tte, jte, "text")


def test_lora_through_the_loader_and_wrong_shapes(tmp_path):
    _write(tmp_path, False)
    _lora_file(tmp_path / "lora.safetensors", "kohya")
    ours = resolve_image_model(str(tmp_path), device="cpu",
                               lora_adapter=str(tmp_path /
                                                "lora.safetensors"),
                               lora_scale=0.5)
    ref = jload.load_diffusers_pipeline(
        tmp_path, lora_adapter=str(tmp_path / "lora.safetensors"),
        lora_scale=0.5)
    assert_trees_equal(ours.unet_params, ref.unet_params, "unet")
    assert_trees_equal(ours.text_params, ref.text_params, "text")
    # a LoRA of another architecture raises instead of corrupting weights
    write_safetensors(tmp_path / "bad.safetensors", [
        (f"lora_unet_mid_block_resnets_0_conv1.{p}.weight", s, torch.float32,
         (lambda s=s: torch.ones(s)))
        for p, s in (("lora_down", (2, 7, 3, 3)),
                     ("lora_up", (64, 2, 1, 1)))])
    _, tun = tload.load_unet(tmp_path / "unet")
    with pytest.raises(ValueError, match="does not match"):
        tlora.apply_lora(tun, None, tmp_path / "bad.safetensors")
    with pytest.raises(ValueError, match="no LoRA layers"):
        write_safetensors(tmp_path / "empty.safetensors", [
            ("x", (1,), torch.float32, lambda: torch.ones(1))])
        tlora.apply_lora(tun, None, tmp_path / "empty.safetensors")


# ---------------------------------------------------------------------------
# ControlNet, FLUX


@pytest.mark.parametrize("sdxl", [False, True], ids=["sd1", "sdxl"])
def test_controlnet_directory_loads_alike(tmp_path, sdxl):
    cfg = SDXL_UNET if sdxl else SD1_UNET
    tree = perturbed(tcn.init_params(cfg, 3, "cpu", cond_channels=(8, 16)),
                     4)
    tload.write_controlnet(tmp_path / "cn", cfg, tree, linear_proj=sdxl)
    tcfg, ours = tcn.resolve_controlnet("cn", tmp_path)
    jcfg, ref = jcn.resolve_controlnet("cn", tmp_path)
    assert_trees_equal(ours, ref, "controlnet")
    assert tcfg.heads_per_level == jcfg.heads_per_level
    hf = json.loads((tmp_path / "cn" / "config.json").read_text())
    assert hf["conditioning_embedding_out_channels"] == [8, 16]


def test_flux_layouts_route_to_flux(tmp_path):
    """``debug:flux-tiny`` and a ``transformer/`` layout load as FLUX
    pipelines (a LoRA dropped, as the JAX package drops it), the config
    loads, and a ref with no layout is still a ``FileNotFoundError``
    (the FLUX directory itself: tests/test_torch_flux.py)."""
    from localai_tpu_torch.config.model_config import ModelConfig
    from localai_tpu_torch.image.flux import FluxPipeline

    pipe = resolve_image_model("debug:flux-tiny", device="cpu",
                               lora_adapter="x", lora_scale=0.5)
    assert isinstance(pipe, FluxPipeline) and pipe.ref == "debug:flux-tiny"
    assert ModelConfig.from_dict({"name": "f", "backend": "diffusers",
                                  "model": "debug:flux-tiny"}).model == \
        "debug:flux-tiny"
    flux = tmp_path / "flux"
    (flux / "transformer").mkdir(parents=True)
    (flux / "model_index.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="config.json"):
        resolve_image_model(str(flux), device="cpu")
    with pytest.raises(FileNotFoundError):
        resolve_image_model("missing", tmp_path, device="cpu")
