"""Latent-diffusion pipeline: text→image and image→image.

Port of ``localai_tpu/image/pipeline.py``: classifier-free guidance as one
UNet call over the batch [uncond; cond], a host loop over the sampler's
steps, the VAE decode clipped to uint8, img2img through the VAE encoder,
ControlNet guidance in the same batch, SDXL's two text encoders with its
pooled text and size/crop time ids, and image sizes bucketed to multiples
of 64. The JAX package jits one step program per latent size; the port
runs the same ops eagerly, on the card unless the caller asks for the
CPU. Noise comes from a ``torch.Generator`` on the CPU seeded with the
request's seed (so the card and the CPU draw alike); ``generate`` also
takes the draws as an argument (the first latent draw, then one per
ancestral step), which is how the tests feed it the JAX package's
``jax.random`` draws. The init and control images are resized with
:func:`resize_linear`, ``jax.image.resize(..., "linear")``: a triangle
kernel widened by the scale factor when shrinking (antialiased).
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from localai_tpu_torch.image import clip as clip_mod
from localai_tpu_torch.image import schedulers as sch
from localai_tpu_torch.image import unet as unet_mod
from localai_tpu_torch.image import vae as vae_mod
from localai_tpu_torch.utils.device import full_f32, resolve_device

@dataclasses.dataclass
class GenerationResult:
    image: np.ndarray                       # [H, W, 3] uint8
    seed: int
    latents: Optional[torch.Tensor] = None  # the final latents [1, L, h, w]


def bucket_dim(v: int, lo: int = 64, quantum: int = 64,
               hi: int = 2048) -> int:
    """Round a requested image dimension up to the size-bucket quantum."""
    v = max(lo, min(v, hi))
    return ((v + quantum - 1) // quantum) * quantum


def tokenize_clip(tokenizer, text_cfg, text: str) -> np.ndarray:
    """[1, max_length] int32 CLIP token row, eos-padded (the SD primary
    text-encoder convention)."""
    T = text_cfg.max_length
    eos = text_cfg.eos_token_id
    ids = list(tokenizer.encode(text))[: T - 1]
    row = np.full((1, T), eos, np.int32)
    row[0, : len(ids)] = ids
    return row


def _triangle_weights(in_size: int, out_size: int,
                      device: torch.device) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` for the linear kernel with
    antialiasing: [in, out] float32."""
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=f32, device=device) + 0.5)
                * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32,
                                          device=device)[:, None]).abs()
    x = x / kernel_scale
    w = torch.clamp(1 - x.abs(), min=0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(img: torch.Tensor, height: int, width: int
                  ) -> torch.Tensor:
    """``jax.image.resize(img, ..., "linear")`` over the two spatial axes
    of a float [B, C, H, W] tensor (an axis of unchanged size is left
    alone, as there)."""
    B, C, H, W = img.shape
    if H != height:
        img = torch.einsum("bchw,hk->bckw", img,
                           _triangle_weights(H, height, img.device))
    if W != width:
        img = torch.einsum("bchw,wk->bchk", img,
                           _triangle_weights(W, width, img.device))
    return img


class DiffusionPipeline:
    """One loaded diffusion model (UNet + VAE + text encoder(s) +
    tokenizer(s)) on one device."""

    def __init__(self, unet_cfg, unet_params, vae_cfg, vae_params,
                 text_cfg, text_params, tokenizer, *,
                 text2_cfg=None, text2_params=None, tokenizer2=None,
                 default_scheduler: str = "euler",
                 default_steps: int = 15, default_cfg_scale: float = 7.0,
                 clip_skip: int = 0, ref: str = "",
                 device: str | torch.device = "cuda"):
        self.unet_cfg = unet_cfg
        self.unet_params = unet_params
        self.vae_cfg = vae_cfg
        self.vae_params = vae_params
        self.text_cfg = text_cfg
        self.text_params = text_params
        self.tokenizer = tokenizer
        # SDXL: a second text encoder and its tokenizer; the two hidden
        # states concatenate into the UNet's context and encoder 2's
        # projected pooled output feeds the text_time conditioning
        self.text2_cfg = text2_cfg
        self.text2_params = text2_params
        self.tokenizer2 = tokenizer2 or tokenizer
        self.default_scheduler = default_scheduler
        self.default_steps = default_steps
        self.default_cfg_scale = default_cfg_scale
        self.clip_skip = clip_skip
        self.ref = ref
        self.device = resolve_device(device)
        # ControlNet (optional): attach_controlnet()
        self.controlnet_cfg = None
        self.controlnet_params = None

    @property
    def is_sdxl(self) -> bool:
        return self.text2_params is not None and getattr(
            self.unet_cfg, "addition_embed", False)

    # -- the model calls ------------------------------------------------

    def _ids(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows.astype(np.int64)).to(self.device)

    def _encode_text(self, tokens: np.ndarray) -> torch.Tensor:
        return clip_mod.forward(self.text_cfg, self.text_params,
                                self._ids(tokens), clip_skip=self.clip_skip)

    def _encode_text_xl(self, tokens1: np.ndarray, tokens2: np.ndarray
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """SDXL: both encoders' penultimate states concatenated, and
        encoder 2's projected pooled output."""
        h1, _ = clip_mod.encode_sdxl(self.text_cfg, self.text_params,
                                     self._ids(tokens1))
        h2, pooled = clip_mod.encode_sdxl(self.text2_cfg, self.text2_params,
                                          self._ids(tokens2))
        return torch.cat([h1.float(), h2.float()], dim=-1), pooled.float()

    def _unet_step(self, x: torch.Tensor, sigma, t, cond: dict,
                   cfg_scale: float) -> torch.Tensor:
        """Batched CFG: one UNet call over [uncond; cond] (a ControlNet's
        residual pass rides the same batch) → the denoised estimate."""
        xin = sch.scale_model_input(x, sigma)
        both = torch.cat([xin, xin], dim=0)
        ts = torch.full((both.shape[0],), float(np.float32(t)),
                        dtype=torch.float32, device=x.device)
        down_res = mid_res = None
        if "control_image" in cond and self.controlnet_params is not None:
            from localai_tpu_torch.image import controlnet as cn

            down_res, mid_res = cn.forward(
                self.controlnet_cfg, self.controlnet_params, both, ts,
                cond["context"], cond["control_image"],
                conditioning_scale=cond["control_scale"],
                pooled_text=cond.get("pooled"),
                time_ids=cond.get("time_ids"))
        eps = unet_mod.forward(
            self.unet_cfg, self.unet_params, both, ts, cond["context"],
            pooled_text=cond.get("pooled"), time_ids=cond.get("time_ids"),
            down_residuals=down_res, mid_residual=mid_res)
        eps_u, eps_c = eps.chunk(2, dim=0)
        eps = eps_u + float(np.float32(cfg_scale)) * (eps_c - eps_u)
        return sch.denoised_from_eps(x, eps, sigma)

    def attach_controlnet(self, ref: str, model_path: str | Path = "models"):
        """Load a ControlNetModel beside this pipeline, on its device."""
        from localai_tpu_torch.image import controlnet as cn
        from localai_tpu_torch.image.loader import _to_device

        self.controlnet_cfg, params = cn.resolve_controlnet(ref, model_path)
        self.controlnet_params = _to_device(params, self.controlnet_cfg.dtype,
                                            self.device)
        return self

    def _decode(self, latents: torch.Tensor) -> np.ndarray:
        """Latents → [B, H, W, 3] uint8 (truncated, as ``astype``)."""
        img = vae_mod.decode(self.vae_cfg, self.vae_params,
                             latents / self.vae_cfg.scaling_factor)
        img = torch.clamp((img + 1.0) * 127.5, 0, 255).to(torch.uint8)
        return img.permute(0, 2, 3, 1).cpu().numpy()

    def _encode_img(self, img: torch.Tensor) -> torch.Tensor:
        return vae_mod.encode(self.vae_cfg, self.vae_params, img)

    # -- host API -------------------------------------------------------

    def _tokenize(self, text: str) -> np.ndarray:
        return tokenize_clip(self.tokenizer, self.text_cfg, text)

    def _tokenize2(self, text: str) -> np.ndarray:
        """SDXL's second (OpenCLIP) tokenizer pads with id 0 ("!"), not the
        end token: pad positions feed cross-attention, so the padding id
        is part of the trained conditioning. The end token stays the
        highest id, which the pooled embedding's argmax keys on."""
        T = self.text2_cfg.max_length
        eos = self.text2_cfg.eos_token_id
        ids = list(self.tokenizer2.encode(text))[: T - 1]
        if not ids or ids[-1] != eos:
            ids = ids[: T - 1] + [eos]
        row = np.zeros((1, T), np.int32)
        row[0, : len(ids)] = ids
        return row

    def _prepare_cond(self, prompt: str, negative: str,
                      width: int, height: int) -> dict:
        """The conditioning of every UNet step: the [uncond; cond]
        context, plus SDXL's pooled text and size/crop time ids."""
        toks = np.concatenate(
            [self._tokenize(negative or ""), self._tokenize(prompt)], axis=0)
        if not self.is_sdxl:
            return {"context": self._encode_text(toks)}
        toks2 = np.concatenate(
            [self._tokenize2(negative or ""), self._tokenize2(prompt)],
            axis=0)
        context, pooled = self._encode_text_xl(toks, toks2)
        if not negative:
            # SDXL base ships force_zeros_for_empty_prompt: an empty
            # negative conditions on zero embeddings, not on the encoded
            # empty string
            context[0] = 0.0
            pooled[0] = 0.0
        # micro-conditioning: (orig_h, orig_w, crop_t, crop_l, tgt_h, tgt_w)
        tid = torch.tensor([[height, width, 0, 0, height, width]] * 2,
                           dtype=torch.float32, device=self.device)
        return {"context": context, "pooled": pooled, "time_ids": tid}

    def _image_input(self, image: np.ndarray, height: int, width: int,
                     div: float, shift: float = 0.0) -> torch.Tensor:
        """[H, W, 3] uint8 → float [1, 3, height, width]: ``image / div +
        shift``, then resized."""
        x = torch.from_numpy(np.asarray(image, np.float32)).to(self.device)
        x = x / div
        if shift:
            x = x + shift
        return resize_linear(x.permute(2, 0, 1)[None], height, width)

    def generate(
        self,
        prompt: str,
        *,
        negative_prompt: str = "",
        width: int = 512,
        height: int = 512,
        steps: Optional[int] = None,
        cfg_scale: Optional[float] = None,
        seed: Optional[int] = None,
        scheduler: Optional[str] = None,
        init_image: Optional[np.ndarray] = None,     # [H, W, 3] uint8
        strength: float = 0.75,
        control_image: Optional[np.ndarray] = None,  # [H, W, 3] uint8
        control_scale: float = 1.0,
        noise: Optional[Sequence[np.ndarray]] = None,
    ) -> GenerationResult:
        """One image. ``noise``, when given, replaces the generator's
        draws: the first latent draw [1, L, h, w], then one draw of that
        shape per ancestral step."""
        rule, karras = sch.resolve(scheduler or self.default_scheduler)
        steps = int(steps or self.default_steps)
        guidance = float(
            self.default_cfg_scale if cfg_scale is None else cfg_scale)
        if seed is None or seed < 0:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        fed: Optional[Iterator] = iter(noise) if noise is not None else None
        gen = torch.Generator().manual_seed(seed)

        def draw(shape) -> torch.Tensor:
            if fed is not None:
                t = torch.from_numpy(np.array(next(fed), np.float32))
                if tuple(t.shape) != tuple(shape):
                    raise ValueError(f"fed noise of shape {tuple(t.shape)}"
                                     f" where {tuple(shape)} is drawn")
            else:
                t = torch.randn(shape, generator=gen)
            return t.to(self.device)

        ds = self.vae_cfg.downscale
        width, height = bucket_dim(width), bucket_dim(height)
        lw, lh = width // ds, height // ds
        L = self.vae_cfg.latent_channels
        f32 = self.unet_cfg.dtype == "float32"
        with torch.inference_mode(), (full_f32() if f32 else nullcontext()):
            cond = self._prepare_cond(prompt, negative_prompt, width, height)
            if control_image is not None and \
                    self.controlnet_params is not None:
                ci = self._image_input(control_image, height, width, 255.0)
                cond["control_image"] = torch.cat([ci, ci], dim=0)
                cond["control_scale"] = float(np.float32(control_scale))
            sigmas, timesteps = sch.build_sigmas(steps, karras=karras)

            x = draw((1, L, lh, lw))
            start = 0
            if init_image is not None:
                # img2img: start at sigma[start] around the encoded init
                # latents (strength 1.0 = full re-noise)
                start = min(steps - 1, int(steps * (1.0 - strength)))
                img = self._image_input(init_image, height, width, 127.5,
                                        -1.0)
                x = self._encode_img(img) + x * float(sigmas[start])
            else:
                x = x * float(sigmas[0])

            prev_denoised = None
            prev_sigma = None
            for i in range(start, steps):
                sigma, sigma_next = sigmas[i], sigmas[i + 1]
                denoised = self._unet_step(x, sigma, timesteps[i], cond,
                                           guidance)
                noise_i = (draw(tuple(x.shape))
                           if rule in sch.ANCESTRAL_RULES else None)
                x = sch.step(rule, x, denoised, sigma, sigma_next,
                             prev_denoised=prev_denoised,
                             prev_sigma=prev_sigma, noise=noise_i)
                prev_denoised, prev_sigma = denoised, sigma

            img = self._decode(x)[0]
        return GenerationResult(image=img, seed=seed, latents=x)


# ---------------------------------------------------------------------------
# resolution: ref → pipeline
# ---------------------------------------------------------------------------

_DEBUG_PRESETS = {
    # tiny: 64x64 output, seconds on the CPU — the test/debug preset
    "sd-tiny": dict(
        unet=unet_mod.UNetConfig(
            model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attn_levels=(0, 1), num_heads=4, context_dim=64,
        ),
        vae=vae_mod.VAEConfig(
            base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
        ),
        text=clip_mod.CLIPTextConfig(
            vocab_size=258, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, max_length=16, eos_token_id=257,
        ),
    ),
}


def _debug_pipeline(name: str, seed: int = 0,
                    device: str | torch.device = "cuda",
                    **defaults) -> DiffusionPipeline:
    """A preset's random weights from ``torch.Generator``s seeded with
    ``seed``, ``seed + 1`` and ``seed + 2``."""
    from localai_tpu_torch.utils.tokenizer import ByteTokenizer

    preset = _DEBUG_PRESETS[name]
    return DiffusionPipeline(
        preset["unet"], unet_mod.init_params(preset["unet"], seed, device),
        preset["vae"], vae_mod.init_params(preset["vae"], seed + 1, device),
        preset["text"], clip_mod.init_params(preset["text"], seed + 2,
                                             device),
        ByteTokenizer(), ref=f"debug:{name}", device=device, **defaults)


def resolve_image_model(ref: str, model_path: str | Path = "models",
                        device: str | torch.device = "cuda", **defaults):
    """ref → a loaded pipeline on ``device``:

    * ``debug:sd-tiny``: the random-weight preset (tests);
    * ``debug:flux-tiny``: the FLUX-class random-weight preset
      (``image.flux``);
    * a FLUX layout (an MMDiT under ``transformer/``, T5 under
      ``text_encoder_2/``): ``image.flux.FluxPipeline``, without a LoRA
      (``lora_adapter`` / ``lora_scale`` dropped, as the JAX package
      drops them);
    * a diffusers-layout dir (model_index.json + unet/ vae/ text_encoder/
      tokenizer/): an SD-1.x, SD-2.x or SDXL checkpoint."""
    if ref.startswith("debug:"):
        name = ref.split(":", 1)[1]
        defaults.pop("lora_adapter", None)
        defaults.pop("lora_scale", None)
        if name == "flux-tiny":
            from localai_tpu_torch.image.flux import debug_flux_pipeline

            return debug_flux_pipeline(device=device, **defaults)
        if name not in _DEBUG_PRESETS:
            raise ValueError(f"unknown debug image preset {name!r}; have "
                             f"{sorted(_DEBUG_PRESETS) + ['flux-tiny']}")
        return _debug_pipeline(name, device=device, **defaults)
    for cand in (Path(ref), Path(model_path) / ref):
        if (cand / "transformer").is_dir():
            from localai_tpu_torch.image.flux import load_flux_pipeline

            defaults.pop("lora_adapter", None)
            defaults.pop("lora_scale", None)
            return load_flux_pipeline(cand, device=device, **defaults)
        if (cand / "model_index.json").exists() or (cand / "unet").is_dir():
            from localai_tpu_torch.image.loader import load_diffusers_pipeline

            return load_diffusers_pipeline(cand, device=device, **defaults)
    raise FileNotFoundError(
        f"image model ref {ref!r} not found (looked for a diffusers layout "
        f"under {ref} and {Path(model_path) / ref})")
