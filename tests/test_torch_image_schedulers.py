"""The port's diffusion samplers against the JAX package's, on the CPU.

Every scheduler alias resolves to the same (rule, karras) pair; the
host-side sigma schedules are equal within 1e-6 for 1–50 steps with
Karras sigmas on and off; one update of each step rule (``euler``,
``ddim``, ``euler_a`` with the noise fed in, ``dpmpp_2m`` first and
multistep, and each rule's last step to sigma 0) agrees within 1e-5 of
the largest output on seeded float32 latents.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from localai_tpu.image import schedulers as jsch  # noqa: E402
from localai_tpu_torch.image import schedulers as tsch  # noqa: E402
from test_torch_image_models import close  # noqa: E402
from test_torch_llama import one_torch_thread  # noqa: E402,F401

ALL_NAMES = sorted(jsch._ALIASES) + ["k_ddim", "k_euler_a", "", None,
                                     " Euler_A "]


@pytest.mark.parametrize("name", ALL_NAMES)
def test_aliases_resolve_alike(name):
    assert tsch.resolve(name) == jsch.resolve(name)


def test_alias_tables_are_equal_and_unknown_names_raise():
    assert tsch._ALIASES == jsch._ALIASES
    assert tsch.ANCESTRAL_RULES == jsch.ANCESTRAL_RULES
    for bad in ("warp_drive", "k_warp"):
        with pytest.raises(ValueError, match="unknown scheduler"):
            tsch.resolve(bad)


@pytest.mark.parametrize("karras", [False, True])
def test_sigma_schedules_match_for_1_to_50_steps(karras):
    for steps in range(1, 51):
        ts, tt = tsch.build_sigmas(steps, karras=karras)
        js, jt = jsch.build_sigmas(steps, karras=karras)
        assert ts.dtype == js.dtype == np.float32
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tt, jt, rtol=1e-6, atol=1e-6)
        assert ts[-1] == 0.0 and len(ts) == steps + 1


def _latents(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 4, 8, 8)).astype(np.float32)
            for _ in range(4)]


CASES = [("euler", False), ("ddim", False), ("euler_a", False),
         ("dpmpp_2m", False), ("dpmpp_2m", True)]


@pytest.mark.parametrize("last", [False, True], ids=["mid", "last"])
@pytest.mark.parametrize("rule,multistep", CASES,
                         ids=["euler", "ddim", "euler_a", "dpmpp_2m-first",
                              "dpmpp_2m-multistep"])
def test_each_rule_steps_alike(rule, multistep, last):
    """Step 3 of 6 (Karras sigmas), or the last one, to sigma 0."""
    sigmas, _ = jsch.build_sigmas(6, karras=True)
    i = 5 if last else 3
    sigma, sigma_next = sigmas[i], sigmas[i + 1]
    prev_sigma = sigmas[i - 1] if multistep else None
    x, den, prev, noise = _latents(i)
    want = jsch.step(
        rule, jnp.asarray(x), jnp.asarray(den), jnp.float32(sigma),
        jnp.float32(sigma_next),
        prev_denoised=jnp.asarray(prev) if multistep else None,
        prev_sigma=None if prev_sigma is None else jnp.float32(prev_sigma),
        noise=jnp.asarray(noise) if rule == "euler_a" else None)
    got = tsch.step(
        rule, torch.from_numpy(x), torch.from_numpy(den), sigma, sigma_next,
        prev_denoised=torch.from_numpy(prev) if multistep else None,
        prev_sigma=prev_sigma,
        noise=torch.from_numpy(noise) if rule == "euler_a" else None)
    close(got.numpy(), want, tol=1e-5)


def test_model_input_scale_and_denoised_match():
    x, eps = _latents(1)[:2]
    for sigma in (14.6146, 1.0, 0.0292):
        close(tsch.scale_model_input(torch.from_numpy(x), sigma).numpy(),
              jsch.scale_model_input(jnp.asarray(x), jnp.float32(sigma)),
              tol=1e-6)
        close(tsch.denoised_from_eps(torch.from_numpy(x),
                                     torch.from_numpy(eps), sigma).numpy(),
              jsch.denoised_from_eps(jnp.asarray(x), jnp.asarray(eps),
                                     jnp.float32(sigma)), tol=1e-6)


def test_unknown_rule_raises():
    x = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError, match="unknown step rule"):
        tsch.step("lms", x, x, 1.0, 0.5)
