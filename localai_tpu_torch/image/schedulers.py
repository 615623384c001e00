"""Diffusion samplers in sigma space.

Port of ``localai_tpu/image/schedulers.py``: the same scheduler names
(four step rules plus the Karras sigma option), the same host-side numpy
schedules, and the per-step update as torch ops on the latents. All rules
share the epsilon-prediction convention x = x0 + sigma * eps, with the
model input scaled by 1/sqrt(1 + sigma^2) (the k-diffusion
parameterization). The sigmas are host scalars; each coefficient is formed
in float32, as the JAX package forms it from ``jnp.float32`` scalars, and
the ancestral rule takes its fresh noise as an argument (the pipeline
draws it, or a test feeds the JAX package's draws).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# alias → (rule, karras)
_ALIASES = {
    "ddim": ("ddim", False),
    "pndm": ("ddim", False),
    "unipc": ("dpmpp_2m", False),
    "euler": ("euler", False),
    "euler_a": ("euler_a", False),
    "heun": ("euler", False),
    "lms": ("euler", False),
    "k_lms": ("euler", True),
    "dpm_2": ("euler", False),
    "k_dpm_2": ("euler", True),
    "dpm_2_a": ("euler_a", False),
    "k_dpm_2_a": ("euler_a", True),
    "dpmpp_2m": ("dpmpp_2m", False),
    "k_dpmpp_2m": ("dpmpp_2m", True),
    "dpmpp_sde": ("euler_a", False),
    "k_dpmpp_sde": ("euler_a", True),
    "dpmpp_2m_sde": ("dpmpp_2m", False),
    "k_dpmpp_2m_sde": ("dpmpp_2m", True),
    "k_euler": ("euler", True),
    "k_euler_a": ("euler_a", True),
}

ANCESTRAL_RULES = ("euler_a",)


def resolve(name: Optional[str]) -> tuple[str, bool]:
    """Scheduler name → (step rule, use_karras_sigmas)."""
    if not name:
        return "euler", False
    key = name.strip().lower()
    if key in _ALIASES:
        return _ALIASES[key]
    if key.startswith("k_") and key[2:] in _ALIASES:
        return _ALIASES[key[2:]][0], True
    raise ValueError(f"unknown scheduler {name!r}; have {sorted(_ALIASES)}")


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """The training noise schedule (SD default: scaled_linear betas)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012

    def alphas_cumprod(self) -> np.ndarray:
        betas = np.linspace(
            self.beta_start ** 0.5, self.beta_end ** 0.5,
            self.num_train_timesteps, dtype=np.float64,
        ) ** 2
        return np.cumprod(1.0 - betas)

    def all_sigmas(self) -> np.ndarray:
        ac = self.alphas_cumprod()
        return np.sqrt((1 - ac) / ac)


def build_sigmas(
    steps: int,
    schedule: NoiseSchedule = NoiseSchedule(),
    karras: bool = False,
    rho: float = 7.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (sigmas [steps+1] desc ending at 0, timesteps [steps] f32):
    the timestep of each sigma interpolated into the training schedule
    (what the UNet's time embedding expects)."""
    all_sig = schedule.all_sigmas()
    if karras:
        smin, smax = all_sig[0], all_sig[-1]
        ramp = np.linspace(0, 1, steps)
        sigmas = (smax ** (1 / rho)
                  + ramp * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho
    else:
        idx = np.linspace(len(all_sig) - 1, 0, steps)
        sigmas = np.interp(idx, np.arange(len(all_sig)), all_sig)
    # sigma → (fractional) training timestep, via log-sigma interpolation
    log_all = np.log(all_sig)
    timesteps = np.interp(np.log(sigmas), log_all, np.arange(len(all_sig)))
    sigmas = np.append(sigmas, 0.0).astype(np.float32)
    return sigmas, timesteps.astype(np.float32)


def _f32(v) -> np.float32:
    return np.float32(v)


def scale_model_input(x: torch.Tensor, sigma) -> torch.Tensor:
    s = _f32(sigma)
    return x / float(np.sqrt(s * s + np.float32(1.0)))


def denoised_from_eps(x: torch.Tensor, eps: torch.Tensor,
                      sigma) -> torch.Tensor:
    return x - float(_f32(sigma)) * eps


def step(
    rule: str,
    x: torch.Tensor,            # current sample (x0 + sigma*eps convention)
    denoised: torch.Tensor,     # model's x0 estimate at sigma
    sigma,                      # current sigma (host scalar)
    sigma_next,                 # next sigma (0 at the last step)
    prev_denoised: Optional[torch.Tensor] = None,   # multistep rules
    prev_sigma=None,
    noise: Optional[torch.Tensor] = None,           # ancestral rules
) -> torch.Tensor:
    """One sampler update x(sigma) → x(sigma_next)."""
    s, sn = _f32(sigma), _f32(sigma_next)
    if rule == "euler":
        d = (x - denoised) / float(s)
        return x + d * float(sn - s)
    if rule == "ddim":
        # deterministic DDIM in sigma space: x' = x0 + (sn/s) * (x - x0)
        return denoised + (x - denoised) * float(sn / s)
    if rule == "euler_a":
        # the ancestral split of the step: a down-step, then fresh noise
        var_next = sn * sn
        up2 = var_next * (s * s - var_next) / max(s * s, _f32(1e-12))
        sigma_up = np.sqrt(max(up2, _f32(0.0)))
        sigma_down = np.sqrt(max(var_next - up2, _f32(0.0)))
        d = (x - denoised) / float(s)
        x = x + d * float(sigma_down - s)
        if noise is not None:
            x = x + noise * float(sigma_up)
        return x
    if rule == "dpmpp_2m":
        # DPM-Solver++ (2M) deterministic multistep (k-diffusion form);
        # sigma_next = 0 degenerates to x' = denoised
        def lam(v):
            return -np.log(max(_f32(v), _f32(1e-10)))

        l_cur, l_next = lam(s), lam(sn)
        h = _f32(l_next - l_cur)
        if prev_denoised is None or not sn > 0:
            d = denoised
        else:
            h_last = _f32(l_cur - lam(prev_sigma))
            r = _f32(h_last / h)
            a = _f32(1 + 1 / (2 * r))
            b = _f32(1 / (2 * r))
            d = float(a) * denoised - float(b) * prev_denoised
        ratio = _f32(sn / max(s, _f32(1e-10)))
        return float(ratio) * x - float(np.exp(-h) - _f32(1.0)) * d
    raise ValueError(f"unknown step rule {rule!r}")
