"""Shape-branch latent diffusion: the sampling half.

Port of echoscene_tpu/diffusion/ldm.py (reference diffusion_shape/
echo2shape.py:149-331 and samplers/ddim.py:127-262): the DDIM sub-schedule,
the DDIM chain over (M, D, H, W, C) latents, and the shared initial noise of
consistency sampling (one grid repeated over all objects,
echo2shape.py:508-510).  The training loss comes with the training slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.schedules import (DDIMTables, DiffusionTables, ddim_tables,
                              ddim_timesteps)
from .samplers import ddim_chain


class ShapeDiffusion:
    def __init__(self, tables: DiffusionTables):
        self.t = tables
        self.num_timesteps = tables.num_timesteps

    def make_ddim_tables(self, num_steps: int, eta: float = 0.0) -> DDIMTables:
        steps = ddim_timesteps(num_steps, self.num_timesteps)
        return ddim_tables(self.t.alphas_cumprod, steps, eta)

    def ddim_sample_chain(self, denoise_fn, shape: Tuple[int, ...],
                          tables: DDIMTables,
                          x_T: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          device="cuda") -> torch.Tensor:
        return ddim_chain(denoise_fn, shape, tables, x_T=x_T,
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
