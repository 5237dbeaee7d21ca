"""Layout-branch Gaussian diffusion: training losses and ancestral sampling.

Port of echoscene_tpu/diffusion/ddpm.py (reference diffusion_layout/
diffusion_ddpm.py:118-632): the forward process, one shared timestep per
scene (get_loss_iter :600-603), the per-component MSE diagnostics
(diffusion_loss :451-477), the optional IoU collision loss (IoU_loss
:384-426, axis-aligned or the soft rotated overlap of core/box_overlap.py),
the variational bound in bits (vb_terms, prior_bpd, calc_bpd :375-548), the
eps -> x0 inversion, the posterior mean and fixed variances, the full
ancestral chain (p_sample_loop_sg :330-345, a `lax.scan` in JAX, a Python
loop here), JAX's few-step layout samplers (DDIM and DPM-Solver++ over a
sub-schedule, a capability the reference lacks) and `split_sample`.

Noise is injectable: JAX's random streams cannot be reproduced in torch, so
every function that draws takes its draws from the caller (tests draw them
with JAX's key splits), else draws from a `torch.Generator`.  Noise is drawn
at `noise_rows` rows and sliced, as in JAX, so a compacted chain sees each
row's noise unchanged.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.boxes import angle_to_sincos, descale_box_params, sincos_to_angle
from ..core.schedules import (DDIMTables, DiffusionTables, ddim_tables,
                              ddim_timesteps, lambda_uniform_timesteps)
from .samplers import CHAINS


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean()
    return (x * mask).sum() / mask.sum().clamp_min(1.0)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between diagonal Gaussians (diffusion_ddpm.py:89-94)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


class LayoutDiffusion:
    """Stateless layout DDPM over (N, 8) box vectors; tables are f32.

    loss_iou / iou_type / iou_stats: the optional IoU collision loss, its
    overlap ('aabb' exact axis-aligned, 'obb' the soft rotated overlap) and
    the 14-value box stats that descale predictions to world units."""

    def __init__(self, tables: DiffusionTables, model_mean_type: str = "eps",
                 model_var_type: str = "fixedsmall", loss_iou: bool = False,
                 iou_type: str = "aabb",
                 iou_stats: Optional[np.ndarray] = None):
        self.t = tables
        self.num_timesteps = tables.num_timesteps
        self.model_mean_type = model_mean_type
        self.model_var_type = model_var_type
        self.loss_iou = loss_iou
        self.iou_type = iou_type
        self.iou_stats = iou_stats
        if model_var_type == "fixedsmall":
            self._logvar = tables.posterior_log_variance_clipped
        elif model_var_type == "fixedlarge":
            self._logvar = tables.fixedlarge_log_variance()
        else:
            raise NotImplementedError(model_var_type)
        self._one_minus_ac = (1.0 - tables.alphas_cumprod).astype(np.float32)
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

    # --- training --------------------------------------------------------
    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        return (self._coef(self.t.sqrt_alphas_cumprod, t, x0.dim()) * x0
                + self._coef(self.t.sqrt_one_minus_alphas_cumprod, t,
                             x0.dim()) * noise)

    def scene_shared_timesteps(self, obj_to_scene: torch.Tensor,
                               num_scenes: int,
                               generator: Optional[torch.Generator] = None,
                               t_scene: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
        """One t per scene gathered to its objects (get_loss_iter :600-603);
        padded rows (obj_to_scene == num_scenes) take the extra slot.
        t_scene: the (num_scenes + 1,) draw, else drawn from `generator`."""
        dev = obj_to_scene.device
        if t_scene is None:
            t_scene = torch.randint(0, self.num_timesteps, (num_scenes + 1,),
                                    generator=generator, device=dev)
        return t_scene.to(dev)[obj_to_scene]

    def p_losses(self, denoise_fn: Callable[[torch.Tensor, torch.Tensor],
                                            torch.Tensor],
                 boxes7: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                 obj_mask: Optional[torch.Tensor] = None,
                 same_scene: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """boxes7: (N, 7) scaled boxes with the raw angle; noise: (N, 8).
        Returns (loss, diagnostics)."""
        x0 = torch.cat([boxes7[:, :6], angle_to_sincos(boxes7[:, 6:7])], -1)
        x_t = self.q_sample(x0, t, noise)
        target = noise if self.model_mean_type == "eps" else x0
        out = denoise_fn(x_t, t)
        sq = (target - out) ** 2
        diag = self.mse_terms(sq, obj_mask)
        total = masked_mean(sq.mean(-1), obj_mask)
        zero = total.new_zeros(())
        liou, mean_iou = zero, zero
        if self.loss_iou:
            liou, mean_iou = self.iou_loss(x_t, t, out, same_scene, obj_mask)
        diag.update({"loss.liou": liou, "loss.bbox_iou": mean_iou})
        return total + liou, diag

    @staticmethod
    def mse_terms(sq: torch.Tensor, obj_mask: Optional[torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Per-component masked MSE of (N, 8) squared errors
        (diffusion_loss :451-477)."""
        per = lambda a: masked_mean(a.mean(-1), obj_mask)
        return {"loss.size": per(sq[:, :3]), "loss.trans": per(sq[:, 3:6]),
                "loss.angle": per(sq[:, 6:8]), "loss.bbox": per(sq[:, :8])}

    def iou_loss(self, x_t, t, pred, same_scene, obj_mask):
        """IoU collision penalty (diffusion_ddpm.py:384-426): the predicted
        boxes descaled to world units, their pairwise same-scene overlap,
        weighted by alpha_cumprod(t).  Returns (loss, mean IoU)."""
        if self.model_mean_type == "eps":
            x_recon = self.predict_xstart_from_eps(x_t, t, pred)
        else:
            x_recon = pred
        if self.iou_stats is None:
            raise ValueError("loss_iou needs the box stats (iou_stats)")
        boxes = descale_box_params(x_recon[:, :6], self.iou_stats)
        if self.iou_type == "obb":
            from ..core.box_overlap import soft_rotated_iou_matrix
            yaw = sincos_to_angle(x_recon[:, 6:8])
            iou = soft_rotated_iou_matrix(torch.cat([boxes, yaw], -1))
        else:
            size, center = boxes[:, :3], boxes[:, 3:6]
            lo, hi = center - size / 2.0, center + size / 2.0
            inter_lo = torch.maximum(lo[:, None, :], lo[None, :, :])
            inter_hi = torch.minimum(hi[:, None, :], hi[None, :, :])
            inter = (inter_hi - inter_lo).clamp_min(0.0).prod(-1)
            vol = (hi - lo).clamp_min(0.0).prod(-1)
            union = vol[:, None] + vol[None, :] - inter
            iou = inter / union.clamp_min(1e-8)
        iou = torch.nan_to_num(iou)
        w = self._coef(self.t.alphas_cumprod, t, 2)
        pair = same_scene if same_scene is not None else iou.new_ones(())
        num = pair.sum().clamp_min(1.0)
        liou = (w * 0.5 * (iou + 1e-6) * pair).sum() / num
        return liou, (iou * pair).sum() / num

    # --- variational bound / bits-per-dim --------------------------------
    def q_mean_variance(self, x0, t):
        """q(x_t | x_0) moments (diffusion_ddpm.py:182-189)."""
        mean = self._coef(self.t.sqrt_alphas_cumprod, t, x0.dim()) * x0
        variance = self._coef(self._one_minus_ac, t, x0.dim())
        log_variance = self._coef(self.t.log_one_minus_alphas_cumprod, t,
                                  x0.dim())
        return mean, variance, log_variance

    def vb_terms(self, denoise_fn, x0, x_t, t, clip_denoised: bool = True):
        """Per-example KL[q(x_{t-1}|x_t,x_0) || p(x_{t-1}|x_t)] in bits
        (_vb_terms_bpd :375-383).  Returns (kl_b, pred_x0)."""
        true_mean = self.q_posterior_mean(x0, x_t, t)
        true_logvar = self._coef(self.t.posterior_log_variance_clipped, t,
                                 x_t.dim())
        out = denoise_fn(x_t, t)
        if self.model_mean_type == "eps":
            x_recon = self.predict_xstart_from_eps(x_t, t, out)
        else:
            x_recon = out
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        model_mean = self.q_posterior_mean(x_recon, x_t, t)
        kl = normal_kl(true_mean, true_logvar, model_mean,
                       self.model_log_variance(t, x_t.dim()))
        return kl.mean(dim=tuple(range(1, kl.dim()))) / math.log(2.0), x_recon

    def prior_bpd(self, x0):
        """KL[q(x_T|x_0) || N(0, I)] in bits (_prior_bpd :510-519)."""
        t = torch.full((x0.shape[0],), self.num_timesteps - 1,
                       dtype=torch.long, device=x0.device)
        qt_mean, _, qt_logvar = self.q_mean_variance(x0, t)
        kl = normal_kl(qt_mean, qt_logvar, torch.zeros_like(qt_mean),
                       torch.zeros_like(qt_logvar))
        return kl.mean(dim=tuple(range(1, kl.dim()))) / math.log(2.0)

    def calc_bpd(self, denoise_fn, x0, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 clip_denoised: bool = True) -> Dict[str, torch.Tensor]:
        """The full variational bound over every timestep (calc_bpd_loop
        :521-548).  noise: (T, B, ...) draws in loop order (entry i belongs
        to t = T-1-i), else drawn from `generator`.  Returns the scalars
        total_bpd / prior_bpd / vb_mean / mse_mean and the (T, B) terms."""
        b = x0.shape[0]
        dims = tuple(range(1, x0.dim()))
        vals, mses = [], []
        for i, t_scalar in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t_b = torch.full((b,), t_scalar, dtype=torch.long,
                             device=x0.device)
            eps = (torch.randn(x0.shape, generator=generator,
                               device=x0.device)
                   if noise is None else noise[i].to(x0.device))
            x_t = self.q_sample(x0, t_b, eps)
            kl_b, pred_x0 = self.vb_terms(denoise_fn, x0, x_t, t_b,
                                          clip_denoised)
            vals.append(kl_b)
            mses.append(((pred_x0 - x0) ** 2).mean(dim=dims))
        vals_tb, mse_tb = torch.stack(vals), torch.stack(mses)
        prior_b = self.prior_bpd(x0)
        total_b = vals_tb.sum(0) + prior_b
        return {"total_bpd": total_b.mean(), "prior_bpd": prior_b.mean(),
                "vb_mean": vals_tb.mean(), "mse_mean": mse_tb.mean(),
                "vb_terms": vals_tb, "mse_terms": mse_tb}

    # --- sampling --------------------------------------------------------
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

    def make_ddim_tables(self, num_steps: int, eta: float = 0.0
                         ) -> DDIMTables:
        """Sub-schedule of the fast DDIM layout sampler (the reference only
        runs the full ancestral chain for layouts)."""
        steps = ddim_timesteps(num_steps, self.num_timesteps)
        return ddim_tables(self.t.alphas_cumprod, steps, eta)

    def make_dpmpp_tables(self, num_steps: int) -> DDIMTables:
        """Lambda-uniform sub-schedule of the DPM-Solver++ layout sampler."""
        ac = self.t.alphas_cumprod
        return ddim_tables(ac, lambda_uniform_timesteps(num_steps, ac), 0.0)

    def sample_chain_fast(self, denoise_fn, shape: Tuple[int, ...],
                          tables: DDIMTables, method: str = "ddim",
                          x_T: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          device="cuda") -> torch.Tensor:
        """Few-step layout sampling, `method` "ddim" or "dpmpp" (eps
        parameterisation only)."""
        if self.model_mean_type != "eps":
            raise ValueError(f"the fast layout samplers need eps "
                             f"parameterisation, got {self.model_mean_type}")
        return CHAINS[method](denoise_fn, shape, tables, x_T=x_T,
                              generator=generator, device=device)

    @staticmethod
    def split_sample(vec8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(N, 8) -> sizes / translations / angles (echo2layout.py:120-124)."""
        return {"sizes": vec8[:, 0:3], "translations": vec8[:, 3:6],
                "angles": sincos_to_angle(vec8[:, 6:8])}
