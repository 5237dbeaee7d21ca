"""DDIM reverse chain (the protocol sampler of the shape branch).

Port of `ddim_chain` in echoscene_tpu/diffusion/samplers.py (reference
diffusion_shape/samplers/ddim.py:127-262).  JAX runs the chain as one
`lax.scan`; here it is a Python loop over the precomputed sub-schedule, from
the last DDIM step down to the first.  Chain math is f32; the denoiser may
compute in bf16 inside.  DPM-Solver++ is not ported yet.
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
