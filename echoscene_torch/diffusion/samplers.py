"""Reverse-chain integrators shared by both branches.

Port of echoscene_tpu/diffusion/samplers.py.  `ddim_chain` is the protocol
sampler of the shape branch (reference diffusion_shape/samplers/ddim.py:
127-262); `dpmpp_chain` is DPM-Solver++(2M), JAX's optional faster
integrator of the same probability-flow ODE (no reference counterpart;
config `sampler: dpmpp`).  Both walk the same `DDIMTables` sub-schedule, so
a sampler switch changes only the integrator.  JAX runs each chain as one
`lax.scan`; here each is a Python loop over the precomputed sub-schedule,
from the last step down to the first.  Chain math is f32, its per-step
scalars computed in f32 as JAX computes them; the denoiser may compute in
bf16 inside.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core.schedules import DDIMTables


def ddim_chain(denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               shape: Tuple[int, ...], tables: DDIMTables,
               x_T: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               device="cuda") -> torch.Tensor:
    """denoise_fn(x, t_vec) -> eps.  `x_T` is the initial noise (the shared
    grid of the consistency trick); drawn from `generator` when None."""
    if x_T is None:
        x_T = torch.randn(shape, generator=generator, device=device)
    x = x_T.to(device=device, dtype=torch.float32)
    stochastic = bool((tables.sigmas != 0.0).any())
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    for i in reversed(range(tables.num_steps)):
        a_t, a_prev = f32(tables.alphas[i]), f32(tables.alphas_prev[i])
        sqrt_1m_a, sigma = f32(tables.sqrt_one_minus_alphas[i]), f32(tables.sigmas[i])
        t_vec = torch.full((shape[0],), int(tables.timesteps[i]),
                           dtype=torch.long, device=device)
        e_t = denoise_fn(x, t_vec).float()
        pred_x0 = (x - sqrt_1m_a.item() * e_t) / torch.sqrt(a_t).item()
        dir_coef = torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0))
        x = torch.sqrt(a_prev).item() * pred_x0 + dir_coef.item() * e_t
        if stochastic:
            x = x + sigma.item() * torch.randn(
                x.shape, generator=generator, device=device)
    return x


def _half_log_snr(ac: torch.Tensor) -> torch.Tensor:
    """lambda = log(alpha / sigma), alpha = sqrt(ac), sigma = sqrt(1 - ac)."""
    return 0.5 * (torch.log(ac) - torch.log1p(-ac))


def dpmpp_chain(denoise_fn: Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor],
                shape: Tuple[int, ...], tables: DDIMTables,
                x_T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> torch.Tensor:
    """DPM-Solver++(2M): the deterministic second-order multistep solver in
    lambda space (Lu et al. 2022, arXiv:2211.01095, data prediction).  The
    first step has no history and is first order (JAX's `has_prev`, whose
    correction weight is 0 there).  `x_T` is drawn from `generator` when
    None."""
    if x_T is None:
        x_T = torch.randn(shape, generator=generator, device=device)
    x = x_T.to(device=device, dtype=torch.float32)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    prev_x0 = torch.zeros_like(x)
    prev_h = f32(1.0)
    has_prev = False
    for i in reversed(range(tables.num_steps)):
        a_t, a_p = f32(tables.alphas[i]), f32(tables.alphas_prev[i])
        sqrt_1m_a = f32(tables.sqrt_one_minus_alphas[i])
        t_vec = torch.full((shape[0],), int(tables.timesteps[i]),
                           dtype=torch.long, device=device)
        e_t = denoise_fn(x, t_vec).float()
        x0 = (x - sqrt_1m_a.item() * e_t) / torch.sqrt(a_t).item()
        h = _half_log_snr(a_p) - _half_log_snr(a_t)
        corr = 1.0 / (2.0 * (prev_h / h)) if has_prev else f32(0.0)
        d = (1.0 + corr).item() * x0 - corr.item() * prev_x0
        ratio = torch.sqrt(1.0 - a_p) / torch.sqrt(1.0 - a_t)
        step = torch.sqrt(a_p) * torch.expm1(-h)
        x = ratio.item() * x - step.item() * d
        prev_x0, prev_h, has_prev = x0, h, True
    return x


CHAINS = {"ddim": ddim_chain, "dpmpp": dpmpp_chain}
