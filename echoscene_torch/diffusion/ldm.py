"""Shape-branch latent diffusion: the training loss and DDIM sampling.

Port of echoscene_tpu/diffusion/ldm.py (reference diffusion_shape/
echo2shape.py:149-331 and samplers/ddim.py:127-262): the forward process and
the eps loss with per-object timesteps (l_simple weight 1, the VLB only
logged), the DDIM and the lambda-uniform DPM-Solver++ sub-schedules, both
chains over (M, D, H, W, C) latents, and the shared initial noise of
consistency sampling (one grid repeated over all objects,
echo2shape.py:508-510).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.schedules import (DDIMTables, DiffusionTables, ddim_tables,
                              ddim_timesteps, lambda_uniform_timesteps)
from .ddpm import masked_mean
from .samplers import ddim_chain, dpmpp_chain


class ShapeDiffusion:
    def __init__(self, tables: DiffusionTables, l_simple_weight: float = 1.0,
                 original_elbo_weight: float = 0.0):
        self.t = tables
        self.num_timesteps = tables.num_timesteps
        self.l_simple_weight = l_simple_weight
        self.original_elbo_weight = original_elbo_weight
        self._on_device = {}

    def coef(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The (T,) table `name` gathered at t (on t's device, each table
        copied there once)."""
        key = (name, t.device)
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(getattr(self.t, name),
                                                   device=t.device)
        return self._on_device[key][t]

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        bc = (slice(None),) + (None,) * (x0.dim() - 1)
        return (self.coef("sqrt_alphas_cumprod", t)[bc] * x0
                + self.coef("sqrt_one_minus_alphas_cumprod", t)[bc] * noise)

    def p_losses(self, denoise_fn: Callable[[torch.Tensor, torch.Tensor],
                                            torch.Tensor],
                 z0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """z0, noise: (M, ...) latents; t: (M,); mask: (M,) object
        validity.  Returns (loss, diagnostics)."""
        out = denoise_fn(self.q_sample(z0, t, noise), t)
        return self.loss_terms(out, noise, t, mask)

    def loss_terms(self, eps: torch.Tensor, noise: torch.Tensor,
                   t: torch.Tensor, mask: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The eps loss of a prediction (the logvar table is all zeros,
        echo2shape.py:168-169)."""
        per_obj = ((eps - noise) ** 2).mean(dim=tuple(range(1, eps.dim())))
        loss_simple = masked_mean(per_obj, mask)
        loss_vlb = masked_mean(self.coef("lvlb_weights", t) * per_obj, mask)
        loss = (self.l_simple_weight * loss_simple
                + self.original_elbo_weight * loss_vlb)
        return loss, {"loss_total": loss, "loss_simple": loss_simple,
                      "loss_vlb": loss_vlb}

    def make_ddim_tables(self, num_steps: int, eta: float = 0.0) -> DDIMTables:
        steps = ddim_timesteps(num_steps, self.num_timesteps)
        return ddim_tables(self.t.alphas_cumprod, steps, eta)

    def make_dpmpp_tables(self, num_steps: int) -> DDIMTables:
        """Lambda-uniform sub-schedule, the spacing DPM-Solver++ wants."""
        steps = lambda_uniform_timesteps(num_steps, self.t.alphas_cumprod)
        return ddim_tables(self.t.alphas_cumprod, steps, 0.0)

    def ddim_sample_chain(self, denoise_fn, shape: Tuple[int, ...],
                          tables: DDIMTables,
                          x_T: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          device="cuda") -> torch.Tensor:
        return ddim_chain(denoise_fn, shape, tables, x_T=x_T,
                          generator=generator, device=device)

    def dpmpp_sample_chain(self, denoise_fn, shape: Tuple[int, ...],
                           tables: DDIMTables,
                           x_T: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None,
                           device="cuda") -> torch.Tensor:
        """DPM-Solver++(2M) over the same kind of sub-schedule."""
        return dpmpp_chain(denoise_fn, shape, tables, x_T=x_T,
                           generator=generator, device=device)

    @staticmethod
    def shared_noise(batch: int, item_shape: Tuple[int, ...],
                     generator: Optional[torch.Generator] = None,
                     device="cuda",
                     single: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One noise grid (drawn, or the given `single`, any shape that
        broadcasts to item_shape) repeated over the batch."""
        if single is None:
            single = torch.randn((1,) + tuple(item_shape), generator=generator,
                                 device=device)
        return single.to(device).float().expand((batch,) + tuple(item_shape))
