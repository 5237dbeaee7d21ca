"""MLP builder with mask-aware batch normalisation.

Port of echoscene_tpu/nn/mlp.py (reference model/layers.py:21-38 build_mlp:
Linear [+ BatchNorm1d] [+ ReLU] per layer, the final layer's norm/activation
gated by `final_nonlinearity`).  Batches are padded to static shapes, so
plain BatchNorm1d would fold padding rows into its statistics;
MaskedBatchNorm weights the moments by the row mask instead.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import Linear


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over rows where mask == 1 (torch momentum 0.1 == flax
    momentum 0.9, eps 1e-5, unbiased running variance).  Statistics and the
    normalisation run in f32; the output keeps the input dtype.  Parameter
    and buffer names are BatchNorm1d's."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        if self.training:
            if mask is None:
                mask = torch.ones(x.shape[0], device=x.device)
            m = mask.float()[:, None]
            n = m.sum().clamp_min(1.0)
            mean = (xf * m).sum(0) / n
            var = (((xf - mean) ** 2) * m).sum(0) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class MLP(nn.Sequential):
    """build_mlp over (N, C) rows; children are indexed as the reference's
    nn.Sequential (Linear, [BatchNorm], ReLU, ...)."""

    def __init__(self, dims: Sequence[int], activation: str = "relu",
                 batch_norm: str = "none", final_nonlinearity: bool = True):
        layers = []
        n_layers = len(dims) - 1
        for i in range(n_layers):
            layers.append(Linear(dims[i], dims[i + 1]))
            if i < n_layers - 1 or final_nonlinearity:
                if batch_norm == "batch":
                    layers.append(MaskedBatchNorm(dims[i + 1]))
                layers.append(nn.ReLU() if activation == "relu"
                              else nn.LeakyReLU())
        super().__init__(*layers)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self:
            x = layer(x, mask) if isinstance(layer, MaskedBatchNorm) else layer(x)
        return x
