"""Diffusion noise schedules and coefficient tables.

A copy of echoscene_tpu/core/schedules.py (NumPy only; the port cannot import
that package, whose `core/__init__.py` pulls in jax).  All schedule math is
done host-side in NumPy float64 (the reference's precision discipline,
diffusion_layout/diffusion_ddpm.py:133 and diffusion_shape/
ldm_diffusion_util.py:43-66) and then frozen into float32 tables, bit-equal
to the JAX package's; the samplers move them to the device once.

Two beta parameterisations exist in the reference and both are kept:
  * layout branch ("DDPM linear"): betas = linspace(b0, b1, T)
  * shape branch ("LDM linear"):   betas = linspace(sqrt(b0), sqrt(b1), T)**2
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np


def ddpm_linear_betas(beta_start: float, beta_end: float, timesteps: int) -> np.ndarray:
    """Layout-branch linear schedule (diffusion_ddpm.py:38-40)."""
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)


def ddpm_warmup_betas(beta_start: float, beta_end: float, timesteps: int,
                      warmup_frac: float) -> np.ndarray:
    """'warm0.1'/'warm0.2'/'warm0.5' schedules (diffusion_ddpm.py:41-55)."""
    betas = beta_end * np.ones(timesteps, dtype=np.float64)
    warmup_time = int(timesteps * warmup_frac)
    betas[:warmup_time] = np.linspace(beta_start, beta_end, warmup_time, dtype=np.float64)
    return betas


def ldm_linear_betas(linear_start: float, linear_end: float, timesteps: int) -> np.ndarray:
    """Shape-branch 'linear' schedule (ldm_diffusion_util.py:44-47): sqrt-space linspace squared."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps, dtype=np.float64) ** 2


def cosine_betas(timesteps: int, s: float = 8e-3, max_beta: float = 0.999) -> np.ndarray:
    """Improved-DDPM cosine schedule (ldm_diffusion_util.py:49-57)."""
    steps = np.arange(timesteps + 1, dtype=np.float64) / timesteps + s
    alphas = np.cos(steps / (1 + s) * math.pi / 2) ** 2
    alphas = alphas / alphas[0]
    betas = 1.0 - alphas[1:] / alphas[:-1]
    return np.clip(betas, 0, max_beta)


def get_betas(schedule_type: str, beta_start: float, beta_end: float,
              timesteps: int) -> np.ndarray:
    """Dispatch matching the layout branch's get_betas (diffusion_ddpm.py:38-84)."""
    if schedule_type == "linear":
        return ddpm_linear_betas(beta_start, beta_end, timesteps)
    if schedule_type.startswith("warm"):
        return ddpm_warmup_betas(beta_start, beta_end, timesteps, float(schedule_type[4:]))
    if schedule_type == "cosine":
        return cosine_betas(timesteps)
    raise NotImplementedError(schedule_type)


@dataclasses.dataclass(frozen=True)
class DiffusionTables:
    """All per-timestep coefficient tables used by training and ancestral sampling.

    Mirrors the buffers registered in GaussianDiffusion.__init__
    (diffusion_ddpm.py:138-166) and EchoToShape.register_schedule
    (echo2shape.py:174-227).  Everything is float32 `(T,)`.
    """
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def fixedlarge_log_variance(self) -> np.ndarray:
        """'fixedlarge' model-variance table (diffusion_ddpm.py:229-230)."""
        return np.log(
            np.concatenate([self.posterior_variance[1:2], self.betas[1:]])
        ).astype(np.float32)


def make_diffusion_tables(betas: np.ndarray, v_posterior: float = 0.0) -> DiffusionTables:
    betas = np.asarray(betas, dtype=np.float64)
    assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

    posterior_variance = ((1 - v_posterior) * betas * (1.0 - alphas_cumprod_prev)
                          / (1.0 - alphas_cumprod) + v_posterior * betas)
    # eps-parameterisation VLB weights (echo2shape.py:216-224)
    lvlb_weights = betas ** 2 / (
        2 * np.maximum(posterior_variance, 1e-20) * alphas * (1 - alphas_cumprod))
    lvlb_weights[0] = lvlb_weights[1]

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return DiffusionTables(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
        lvlb_weights=f32(lvlb_weights),
    )


def ddim_timesteps(num_ddim_steps: int, num_ddpm_steps: int,
                   method: Literal["uniform", "quad"] = "uniform") -> np.ndarray:
    """DDIM sub-schedule (ldm_diffusion_util.py:68-82), incl. the +1 shift."""
    if method == "uniform":
        c = max(1, num_ddpm_steps // num_ddim_steps)
        steps = np.asarray(list(range(0, num_ddpm_steps, c)))
    elif method == "quad":
        steps = ((np.linspace(0, np.sqrt(num_ddpm_steps * 0.8), num_ddim_steps)) ** 2).astype(int)
    else:
        raise NotImplementedError(method)
    # +1 shift per the reference (ldm_diffusion_util.py:79); clamp keeps the
    # table index valid when num_ddim_steps ~ num_ddpm_steps (test scale)
    steps = steps + 1
    return steps[steps < num_ddpm_steps]


def lambda_uniform_timesteps(num_steps: int, alphas_cumprod: np.ndarray) -> np.ndarray:
    """Timesteps uniform in half-log-SNR lambda = log(alpha/sigma).

    The natural spacing for exponential-integrator solvers (DPM-Solver++):
    uniform-t DDIM spacing concentrates almost no steps where the ODE is
    stiff, costing an order of magnitude in few-step accuracy (measured on
    the linear-Gaussian golden problem in tests/test_samplers.py).
    """
    ac = np.asarray(alphas_cumprod, dtype=np.float64)
    lam = 0.5 * (np.log(ac) - np.log1p(-ac))
    # exclude t=0 (the DDIM grid convention starts at 1, matching the
    # reference's +1 shift) and enforce STRICTLY decreasing indices while
    # walking ascending lambda targets — a naive nearest-index pick collapses
    # duplicates where lambda is steep, silently shortening the schedule and
    # producing a degenerate a_t == a_prev final row.
    targets = np.linspace(lam[-1], lam[1], num_steps)
    idxs = []
    prev = len(ac)
    for tgt in targets:
        i = int(np.argmin(np.abs(lam - tgt)))
        i = min(i, prev - 1)
        if i < 1:
            break
        idxs.append(i)
        prev = i
    # targets cluster where lambda is steep (low t); when the strictly-
    # decreasing walk exhausts that end, backfill with the smallest unused
    # indices so the requested step count is honored exactly
    if len(idxs) < num_steps:
        used = set(idxs)
        for i in range(1, len(ac)):
            if i not in used:
                idxs.append(i)
                if len(idxs) >= num_steps:
                    break
    return np.asarray(sorted(idxs), dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class DDIMTables:
    """Per-DDIM-step coefficients (ldm_diffusion_util.py:85-96)."""
    timesteps: np.ndarray      # (S,) int — DDPM timesteps fed to the denoiser
    alphas: np.ndarray         # (S,) alpha_cumprod at each step
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def ddim_tables(alphas_cumprod: np.ndarray, steps: np.ndarray, eta: float) -> DDIMTables:
    ac = np.asarray(alphas_cumprod, dtype=np.float64)
    alphas = ac[steps]
    alphas_prev = np.asarray([ac[0]] + ac[steps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return DDIMTables(
        timesteps=np.asarray(steps, dtype=np.int32),
        alphas=f32(alphas),
        alphas_prev=f32(alphas_prev),
        sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
        sigmas=f32(sigmas),
    )
