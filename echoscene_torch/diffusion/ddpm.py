"""Layout-branch Gaussian diffusion: the sampling half.

Port of echoscene_tpu/diffusion/ddpm.py (reference diffusion_layout/
diffusion_ddpm.py:118-632): the eps -> x0 inversion, the
posterior mean and fixed variances, the full ancestral chain
(p_sample_loop_sg :330-345, a `lax.scan` in JAX, a Python loop here) and
`split_sample`.  The training losses come with the training slice.

Noise is injectable: JAX's random streams cannot be reproduced in torch, so
`sample_chain` takes the initial state and the per-step noise from the
caller (tests draw them with JAX's key splits), else draws from a
`torch.Generator`.  Noise is drawn at `noise_rows` rows and sliced, as in
JAX, so a compacted chain sees each row's noise unchanged.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.boxes import sincos_to_angle
from ..core.schedules import DiffusionTables


class LayoutDiffusion:
    """Stateless layout DDPM over (N, 8) box vectors; tables are f32."""

    def __init__(self, tables: DiffusionTables, model_mean_type: str = "eps",
                 model_var_type: str = "fixedsmall"):
        self.t = tables
        self.num_timesteps = tables.num_timesteps
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        if model_var_type == "fixedsmall":
            self._logvar = tables.posterior_log_variance_clipped
        elif model_var_type == "fixedlarge":
            self._logvar = tables.fixedlarge_log_variance()
        else:
            raise NotImplementedError(model_var_type)
        self._on_device = {}

    def _coef(self, table: np.ndarray, t: torch.Tensor,
              ndim: int) -> torch.Tensor:
        """table[t] broadcast to `ndim` dims; each table is copied to t's
        device once."""
        key = (id(table), t.device)
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(table, device=t.device)
        out = self._on_device[key][t]
        return out.reshape(out.shape[0], *((1,) * (ndim - 1)))

    def predict_xstart_from_eps(self, x_t, t, eps):
        return (self._coef(self.t.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t
                - self._coef(self.t.sqrt_recipm1_alphas_cumprod, t,
                             x_t.dim()) * eps)

    def q_posterior_mean(self, x0, x_t, t):
        return (self._coef(self.t.posterior_mean_coef1, t, x_t.dim()) * x0
                + self._coef(self.t.posterior_mean_coef2, t, x_t.dim()) * x_t)

    def model_log_variance(self, t, ndim):
        return self._coef(self._logvar, t, ndim)

    def sample_chain(self, denoise_fn: Callable[[torch.Tensor, torch.Tensor],
                                                torch.Tensor],
                     shape: Tuple[int, ...], clip_denoised: bool = False,
                     noise_rows: Optional[int] = None,
                     x_T: Optional[torch.Tensor] = None,
                     step_noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     device="cuda") -> torch.Tensor:
        """Full T-step ancestral chain.

        x_T: (noise_rows, ...) initial state; step_noise: (T, noise_rows, ...)
        noise in chain order (entry i belongs to t = T-1-i; the t = 0 entry
        is multiplied by 0).  Both are sliced to shape[0] rows; either is
        drawn from `generator` when None."""
        rows = shape[0]
        nshape = (max(noise_rows or rows, rows),) + tuple(shape[1:])
        draw = lambda: torch.randn(nshape, generator=generator, device=device)
        x = (draw() if x_T is None else x_T.to(device))[:rows].float()
        for i, t_scalar in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t_vec = torch.full((rows,), t_scalar, dtype=torch.long,
                               device=device)
            out = denoise_fn(x, t_vec).float()
            if self.model_mean_type == "eps":
                x_recon = self.predict_xstart_from_eps(x, t_vec, out)
            else:
                x_recon = out
            if clip_denoised:
                x_recon = x_recon.clamp(-1.0, 1.0)
            mean = self.q_posterior_mean(x_recon, x, t_vec)
            noise = draw() if step_noise is None else step_noise[i].to(device)
            if t_scalar > 0:
                std = torch.exp(0.5 * self.model_log_variance(t_vec, x.dim()))
                x = mean + std * noise[:rows].float()
            else:
                x = mean
        return x

    @staticmethod
    def split_sample(vec8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(N, 8) -> sizes / translations / angles (echo2layout.py:120-124)."""
        return {"sizes": vec8[:, 0:3], "translations": vec8[:, 3:6],
                "angles": sincos_to_angle(vec8[:, 6:8])}
