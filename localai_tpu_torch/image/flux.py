"""FLUX-class text→image: the rectified-flow MMDiT, two text encoders
(CLIP's pooled output and T5's sequence) and a 16-channel VAE.

Port of ``localai_tpu/image/flux.py`` (diffusers' ``FluxPipeline``),
served behind the same ``/v1/images/generations`` route through
``image.pipeline.resolve_image_model``. FLUX is guidance-distilled: no
CFG batch, the guidance rides the embedding, so ``cfg_scale`` maps onto
it and ``negative_prompt`` and ``scheduler`` are ignored, as there. The
latents are packed 2x2 patches, channel-major ``(C, ph, pw)`` as
diffusers' ``_pack_latents``; unpacking is the exact inverse. The JAX
package jits one velocity program per latent size; the port runs the
same ops eagerly on one device, the card unless the caller asks for the
CPU, inside ``utils.device.full_f32`` (TF32 off) since the MMDiT and T5
are float32 there. The noise comes from a CPU ``torch.Generator`` seeded
with the request's seed; ``generate(noise=...)`` takes the draw instead
(the tests feed it the JAX package's ``jax.random`` draw).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from localai_tpu_torch.image import clip as clip_mod
from localai_tpu_torch.image import mmdit
from localai_tpu_torch.image import t5 as t5_mod
from localai_tpu_torch.image import vae as vae_mod
from localai_tpu_torch.image.pipeline import (
    GenerationResult,
    bucket_dim,
    resize_linear,
    tokenize_clip,
)
from localai_tpu_torch.utils.device import full_f32, resolve_device

log = logging.getLogger(__name__)


class FluxPipeline:
    """One loaded FLUX-class model (MMDiT + VAE + CLIP + T5) on one
    device."""

    def __init__(self, cfg, params, vae_cfg, vae_params,
                 clip_cfg, clip_params, clip_tokenizer,
                 t5_cfg, t5_params, t5_tokenizer, *,
                 vae_shift: float = 0.0, vae_scale: float = 1.0,
                 default_steps: int = 4, default_guidance: float = 3.5,
                 max_t5_len: int = 128, ref: str = "",
                 dynamic_shift: bool = True, shift: float = 1.0,
                 default_cfg_scale: Optional[float] = None,
                 default_scheduler: str = "", clip_skip: int = 0,
                 device: str | torch.device = "cuda"):
        # the last three keep ModelConfig.diffusers' parity with the UNet
        # pipeline: cfg_scale is the distilled guidance; scheduler and
        # clip_skip have no FLUX meaning and are ignored
        if default_cfg_scale is not None:
            default_guidance = default_cfg_scale
        del default_scheduler, clip_skip
        self.cfg = cfg
        self.params = params
        self.vae_cfg = vae_cfg
        self.vae_params = vae_params
        self.clip_cfg = clip_cfg
        self.clip_params = clip_params
        self.clip_tokenizer = clip_tokenizer
        self.t5_cfg = t5_cfg
        self.t5_params = t5_params
        self.t5_tokenizer = t5_tokenizer
        self.vae_shift = vae_shift
        self.vae_scale = vae_scale
        self.default_steps = default_steps
        self.default_guidance = default_guidance
        self.dynamic_shift = dynamic_shift
        self.shift = shift
        self.max_t5_len = max_t5_len
        self.ref = ref
        self.device = resolve_device(device)

    # -- the model calls ------------------------------------------------

    def _ids(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows.astype(np.int64)).to(self.device)

    def _encode(self, clip_tokens: np.ndarray, t5_tokens: np.ndarray
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(CLIP's pooled output [1, P], T5's states [1, T, D])."""
        _, pooled = clip_mod.encode_sdxl(self.clip_cfg, self.clip_params,
                                         self._ids(clip_tokens))
        txt = t5_mod.encode(self.t5_cfg, self.t5_params,
                            self._ids(t5_tokens))
        return pooled, txt

    def _velocity(self, latents, txt, pooled, sigma: float,
                  guidance: float, img_ids, txt_ids) -> torch.Tensor:
        B = latents.shape[0]
        full = lambda v: torch.full((B,), v, dtype=torch.float32,  # noqa
                                    device=latents.device)
        return mmdit.forward(self.cfg, self.params, latents, txt, pooled,
                             full(sigma), img_ids, txt_ids,
                             guidance=full(guidance))

    def _encode_img(self, img: torch.Tensor) -> torch.Tensor:
        """img [1, 3, H, W] in [-1, 1] → packed model-space latent tokens
        [1, (h/2)(w/2), 4 Cz], the exact inverse of ``_decode``'s unpack:
        ``vae.encode`` gives the raw latents times the VAE config's
        scaling factor; FLUX's model space is (raw - shift) * scale."""
        z_raw = (vae_mod.encode(self.vae_cfg, self.vae_params, img)
                 / self.vae_cfg.scaling_factor)
        zm = (z_raw - self.vae_shift) * self.vae_scale      # [1, Cz, h, w]
        return pack(zm)

    def _decode(self, packed: torch.Tensor, h: int, w: int) -> np.ndarray:
        """packed [1, (h/2)(w/2), 4 Cz] → [H, W, 3] uint8 (``h``, ``w``
        are latent dims)."""
        x = unpack(packed, self.vae_cfg.latent_channels, h, w)
        z = x / self.vae_scale + self.vae_shift
        img = vae_mod.decode(self.vae_cfg, self.vae_params, z)
        img = torch.clamp((img + 1.0) * 127.5, 0, 255).to(torch.uint8)
        return img.permute(0, 2, 3, 1).cpu().numpy()[0]

    # -- host API -------------------------------------------------------

    def _tokenize_clip(self, text: str) -> np.ndarray:
        return tokenize_clip(self.clip_tokenizer, self.clip_cfg, text)

    def _tokenize_t5(self, text: str) -> np.ndarray:
        """[1, max_t5_len]: the ids, then </s> (1), padded with 0."""
        T = self.max_t5_len
        ids = list(self.t5_tokenizer.encode(text))[: T - 1] + [1]
        row = np.zeros((1, T), np.int32)
        row[0, : len(ids)] = ids
        return row

    def generate(
        self,
        prompt: str,
        *,
        negative_prompt: str = "",     # FLUX is distilled: ignored
        width: int = 512,
        height: int = 512,
        steps: Optional[int] = None,
        cfg_scale: Optional[float] = None,   # the distilled guidance
        seed: Optional[int] = None,
        scheduler: str = "",           # always the rectified flow
        init_image: Optional[np.ndarray] = None,     # [H, W, 3] uint8
        strength: float = 0.75,
        noise: Optional[np.ndarray] = None,
        **_,
    ) -> GenerationResult:
        """One image. ``noise`` [1, (h/2)(w/2), 4 Cz], when given, replaces
        the generator's draw."""
        del negative_prompt, scheduler
        steps = int(steps or self.default_steps)
        guidance = self.default_guidance if cfg_scale is None else cfg_scale
        width, height = bucket_dim(width), bucket_dim(height)
        ds = self.vae_cfg.downscale
        h, w = height // ds, width // ds        # latent dims (even)
        seed = int(seed) if seed is not None else int(
            np.random.SeedSequence().entropy % (2 ** 31))
        n_img = (h // 2) * (w // 2)
        cz = self.vae_cfg.latent_channels
        shape = (1, n_img, 4 * cz)
        if noise is not None:
            x = torch.from_numpy(np.array(noise, np.float32))
            if tuple(x.shape) != shape:
                raise ValueError(f"fed noise of shape {tuple(x.shape)} "
                                 f"where {shape} is drawn")
        else:
            x = torch.randn(shape, generator=torch.Generator()
                            .manual_seed(seed))
        dev = self.device
        with torch.inference_mode(), full_f32():
            pooled, txt = self._encode(self._tokenize_clip(prompt),
                                       self._tokenize_t5(prompt))
            ids = np.zeros((n_img, 3), np.float32)
            ids[:, 1] = np.arange(n_img) // (w // 2)
            ids[:, 2] = np.arange(n_img) % (w // 2)
            img_ids = torch.from_numpy(ids).to(dev)
            txt_ids = torch.zeros((txt.shape[1], 3), dtype=torch.float32,
                                  device=dev)
            x = x.to(dev)
            sigmas = mmdit.flow_sigmas(steps, n_img,
                                       dynamic=self.dynamic_shift,
                                       shift=self.shift)
            i0 = 0
            if init_image is not None:
                # rectified-flow img2img (diffusers' FluxImg2ImgPipeline
                # scale_noise): start at (1 - s) z0 + s noise and run the
                # last int(steps * strength) steps
                run = max(1, min(steps, int(steps * strength)))
                i0 = steps - run
                img = torch.from_numpy(np.asarray(init_image, np.float32)
                                       ).to(dev) / 127.5 - 1.0
                img = resize_linear(img.permute(2, 0, 1)[None], height,
                                    width)
                z0 = self._encode_img(img)
                s0 = float(sigmas[i0])
                x = (1.0 - s0) * z0 + s0 * x
            for i in range(i0, steps):
                v = self._velocity(x, txt, pooled, float(sigmas[i]),
                                   float(guidance), img_ids, txt_ids)
                x = x + (float(sigmas[i + 1]) - float(sigmas[i])) * v
            image = self._decode(x, h, w)
        return GenerationResult(image=image, seed=seed, latents=x)


def pack(z: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] latents → [B, (h/2)(w/2), 4 C] tokens, channel-major
    (C, ph, pw) within a token."""
    B, C, h, w = z.shape
    x = z.reshape(B, C, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, (h // 2) * (w // 2), 4 * C)


def unpack(x: torch.Tensor, C: int, h: int, w: int) -> torch.Tensor:
    """The exact inverse of :func:`pack`."""
    B = x.shape[0]
    x = x.reshape(B, h // 2, w // 2, C, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B, C, h, w)


# ---------------------------------------------------------------------------
# the debug preset

DEBUG_CONFIGS = dict(
    mmdit=mmdit.FluxConfig(
        in_channels=16, num_layers=2, num_single_layers=2,
        attention_head_dim=16, num_attention_heads=4,
        joint_attention_dim=32, pooled_projection_dim=64,
        guidance_embeds=True, axes_dims_rope=(4, 6, 6)),
    vae=vae_mod.VAEConfig(base_channels=32, channel_mult=(1, 2),
                          num_res_blocks=1, latent_channels=4),
    clip=clip_mod.CLIPTextConfig(
        vocab_size=258, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, max_length=16, eos_token_id=257),
    t5=t5_mod.T5Config(
        vocab_size=258, d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=16),
)


def debug_flux_pipeline(seed: int = 0, device: str | torch.device = "cuda",
                        **defaults) -> FluxPipeline:
    """``debug:flux-tiny``: the JAX package's tiny FLUX (64x64 output;
    fast on the CPU) with random weights from ``torch.Generator``s seeded
    with ``seed`` to ``seed + 3``, byte tokenizers for both encoders."""
    from localai_tpu_torch.utils.tokenizer import ByteTokenizer

    c = DEBUG_CONFIGS
    defaults.setdefault("default_steps", 2)
    return FluxPipeline(
        c["mmdit"], mmdit.init_params(c["mmdit"], seed, device),
        c["vae"], vae_mod.init_params(c["vae"], seed + 1, device),
        c["clip"], clip_mod.init_params(c["clip"], seed + 2, device),
        ByteTokenizer(),
        c["t5"], t5_mod.init_params(c["t5"], seed + 3, device),
        ByteTokenizer(), ref="debug:flux-tiny", device=device, **defaults)


# ---------------------------------------------------------------------------
# loading

def load_flux_pipeline(d: str | Path, device: str | torch.device = "cuda",
                       **defaults) -> FluxPipeline:
    """The diffusers FLUX layout: ``transformer/`` (MMDiT) ``vae/``
    ``text_encoder/`` (CLIP) ``text_encoder_2/`` (T5) ``tokenizer/``
    ``tokenizer_2/`` and ``scheduler/``. Each leaf goes to ``device`` and
    takes its dtype there, one at a time (stacked leaves filled layer by
    layer), so the file's tree and the cast tree never sit on the device
    together."""
    from localai_tpu_torch.image.loader import (
        _load_clip_tokenizer,
        _to_device,
        load_mmdit,
        load_text_encoder,
        load_vae,
    )

    d = Path(d)
    device = resolve_device(device)
    cfg = mmdit.FluxConfig.from_hf(
        json.loads((d / "transformer" / "config.json").read_text()))
    vae_cfg, vae_params = load_vae(d / "vae")
    vae_json = json.loads((d / "vae" / "config.json").read_text())
    clip_cfg, clip_params = load_text_encoder(d / "text_encoder")
    clip_tok = _load_clip_tokenizer(d / "tokenizer")
    t5_tok = load_t5_tokenizer(d / "tokenizer_2")
    params = load_mmdit(d / "transformer", cfg, device)
    t5_cfg, t5_params = t5_mod.load_hf_t5(d / "text_encoder_2", device)
    # the scheduler config decides the sigma shift: schnell declares
    # use_dynamic_shifting false and shift 1.0, dev dynamic shifting
    sched: dict = {}
    sched_path = d / "scheduler" / "scheduler_config.json"
    if sched_path.exists():
        try:
            sched = json.loads(sched_path.read_text())
        except ValueError:
            log.warning("unreadable scheduler_config.json in %s", d)
    defaults.setdefault(
        "dynamic_shift", bool(sched.get("use_dynamic_shifting", True)))
    defaults.setdefault("shift", float(sched.get("shift", 1.0)))
    log.info("loaded FLUX pipeline from %s (dim %d, %d+%d blocks) on %s",
             d, cfg.dim, cfg.num_layers, cfg.num_single_layers, device)
    return FluxPipeline(
        cfg, params,
        vae_cfg, _to_device(vae_params, vae_cfg.dtype, device),
        clip_cfg, _to_device(clip_params, clip_cfg.dtype, device),
        clip_tok, t5_cfg, t5_params, t5_tok,
        vae_shift=vae_json.get("shift_factor", 0.0) or 0.0,
        vae_scale=vae_json.get("scaling_factor", 1.0) or 1.0,
        ref=str(d), device=device, **defaults)


def load_t5_tokenizer(d: Path):
    """``tokenizer_2/``: its ``tokenizer.json``, or a T5 ``spiece.model``
    with ``tokenizer_config.json`` (``utils.tokenizer.HFTokenizer``, whose
    ``encode`` is the JAX package's ``AutoTokenizer(text,
    add_special_tokens=False).input_ids``). Where ``AutoTokenizer`` itself
    fails for want of tokenizer files, the byte tokenizer with the JAX
    package's warning; a component the port's reader lacks is refused at
    load, by name."""
    from localai_tpu_torch.utils.tokenizer import (
        SPM_FILES,
        ByteTokenizer,
        HFTokenizer,
    )

    d = Path(d)
    names = ("tokenizer.json", "tokenizer_config.json") + SPM_FILES
    if not any((d / n).exists() for n in names):
        log.warning("T5 tokenizer load failed (no tokenizer files in %s); "
                    "using byte tokenizer", d)
        return ByteTokenizer()
    return HFTokenizer(d)
