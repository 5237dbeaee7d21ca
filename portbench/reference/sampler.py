"""DPM-Solver++(2M) in plain float64 PyTorch: the benchmark's reference for
the sampling chains (Lu et al. 2022, arXiv:2211.01095, data prediction,
the deterministic second-order multistep solver).

The sub-schedule is uniform in the half-log-SNR lambda = log(alpha /
sigma) over the DDPM grid without t = 0, each target taken at its nearest
timestep below the last one taken, the steps left short filled with the
smallest unused timesteps.  Step c of a chain (c = 0 first, at the noisiest
timestep) goes from a_t = alpha_bar(t_c) to a_p = alpha_bar(t_{c+1}) (at
the last step alpha_bar(0)):

    x0_c = (x_c - sqrt(1 - a_t) eps_c) / sqrt(a_t)
    h_c = lambda(a_p) - lambda(a_t)
    D = (1 + r) x0_c - r x0_{c-1},  r = h_c / (2 h_{c-1})  (r = 0 at c = 0)
    x_{c+1} = sqrt(1 - a_p) / sqrt(1 - a_t) x_c - sqrt(a_p) expm1(-h_c) D
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def layout_alphas_cumprod(cfg: Dict) -> np.ndarray:
    d = cfg["layout_branch"]["diffusion_kwargs"]
    betas = np.linspace(d["beta_start"], d["beta_end"], d["time_num"],
                        dtype=np.float64)
    return np.cumprod(1.0 - betas)


def shape_alphas_cumprod(cfg: Dict) -> np.ndarray:
    m = cfg["shape_branch"]["model"]
    betas = np.linspace(m["linear_start"] ** 0.5, m["linear_end"] ** 0.5,
                        m["timesteps"], dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def half_log_snr(ac) -> np.ndarray:
    ac = np.asarray(ac, np.float64)
    return 0.5 * (np.log(ac) - np.log1p(-ac))


def timesteps(ac: np.ndarray, num: int) -> np.ndarray:
    """The sub-schedule, ascending (module docstring)."""
    lam = half_log_snr(ac)
    picked: List[int] = []
    below = len(ac)
    for target in np.linspace(lam[-1], lam[1], num):
        i = min(int(np.argmin(np.abs(lam - target))), below - 1)
        if i < 1:
            break
        picked.append(i)
        below = i
    for i in range(1, len(ac)):
        if len(picked) >= num:
            break
        if i not in picked:
            picked.append(i)
    return np.asarray(sorted(picked), np.int64)


class Chain:
    """The per-step scalars of one chain: `t[c]`, the timestep fed to the
    denoiser at step c, and the update's coefficients."""

    def __init__(self, ac: np.ndarray, num: int):
        steps = timesteps(ac, num)
        a_t = ac[steps][::-1]
        a_p = np.concatenate([[ac[0]], ac[steps[:-1]]])[::-1]
        self.t = steps[::-1].copy()
        self.h = half_log_snr(a_p) - half_log_snr(a_t)
        self.a_t, self.a_p = a_t, a_p

    def __len__(self) -> int:
        return len(self.t)

    def x0(self, c: int, x: torch.Tensor, eps: torch.Tensor,
           dtype=torch.float64) -> torch.Tensor:
        a = float(self.a_t[c])
        return ((x.to(dtype) - (1.0 - a) ** 0.5 * eps.to(dtype))
                / a ** 0.5).to(dtype)

    def update(self, c: int, x: torch.Tensor, eps: torch.Tensor,
               prev_x0: Optional[torch.Tensor],
               dtype=torch.float64) -> torch.Tensor:
        """x_{c+1} from x_c, eps_c and (c > 0) x0_{c-1}, every operation in
        `dtype`."""
        a_t, a_p, h = (float(v) for v in (self.a_t[c], self.a_p[c],
                                          self.h[c]))
        x0 = self.x0(c, x, eps, dtype)
        if c == 0:
            d = x0
        else:
            r = h / (2.0 * float(self.h[c - 1]))
            d = ((1.0 + r) * x0 - r * prev_x0.to(dtype)).to(dtype)
        ratio = ((1.0 - a_p) / (1.0 - a_t)) ** 0.5
        return (ratio * x.to(dtype)
                - (a_p ** 0.5 * np.expm1(-h)) * d).to(dtype)


def run_chain(chain: Chain, denoise: Callable[[torch.Tensor, torch.Tensor],
                                               torch.Tensor],
              x_T: torch.Tensor) -> torch.Tensor:
    """The whole chain from x_T: the denoiser in its own precision, the
    chain's arithmetic in float64."""
    x = x_T.double()
    prev = None
    for c in range(len(chain)):
        t = torch.full((x.shape[0],), int(chain.t[c]), dtype=torch.long,
                       device=x.device)
        eps = denoise(x.float(), t).double()
        nxt = chain.update(c, x, eps, prev)
        prev = chain.x0(c, x, eps)
        x = nxt
    return x
