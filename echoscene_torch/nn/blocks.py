"""Shared UNet building blocks (timestep embedding, norm, res blocks,
resampling).

Port of echoscene_tpu/nn/blocks.py (reference openai_model_3d.py:100-314 and
ldm_diffusion_util.py:174-273).  The JAX package is channel-last; here the
UNet torso runs channel-first (N, C, *spatial), PyTorch's and cuDNN's native
convolution layout, and the denoisers convert at their public boundary.
Module and parameter names follow the reference torch modules, so their
state_dict keys are the reference's.

Spatial rank 3 is the shape UNet (inner two dims resampled, stride (1,2,2));
rank 1 is the layout UNet's single length-1 token (upsample is the identity,
denoise_net.py:154).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear, conv_nd


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings, cos first (ldm_diffusion_util.py:174-194).
    (B,) -> (B, dim) f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def group_norm(x: torch.Tensor, groups: int, eps: float, weight: torch.Tensor,
               bias: torch.Tensor, shift: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Channel-first GroupNorm with f32 statistics; output in x's dtype.

    `shift`, a per-(B, C) bias, gives GN(x + shift) (the ResBlock's
    time-embedding add, the `shift=` of JAX's group_norm_fast); the sum is
    formed in f32 inside the norm."""
    xf = x.float()
    if shift is not None:
        xf = xf + shift.float().reshape(shift.shape[0], shift.shape[1],
                                        *(1,) * (x.dim() - 2))
    return F.group_norm(xf, groups, weight.float(), bias.float(),
                        eps).to(x.dtype)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with f32 statistics; output in x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def norm_groups(c: int, requested: int = 32) -> int:
    """Largest divisor of c that is <= requested (GroupNorm32's rule)."""
    groups = min(requested, c)
    while c % groups:
        groups -= 1
    return groups


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) computed in f32 (ldm_diffusion_util.py:222-239); test
    widths degrade to the largest divisor <= 32."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(norm_groups(channels), channels, eps=eps)

    def forward(self, x, shift=None):
        return group_norm(x, self.num_groups, self.eps, self.weight, self.bias,
                          shift=shift)


def zero_module(module: nn.Module) -> nn.Module:
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


class Upsample(nn.Module):
    """Nearest-2x upsample of the inner two dims (3D) / identity (1D) + conv
    (openai_model_3d.py:148-157; denoise_net.py:147-157)."""

    def __init__(self, channels: int, dims: int):
        super().__init__()
        self.dims = dims
        self.conv = conv_nd(dims, channels, channels, 3, padding=1)

    def forward(self, x):
        if self.dims == 3:
            x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
        return self.conv(x)


class Downsample(nn.Module):
    """Strided conv; 3D strides only the inner two dims
    (openai_model_3d.py:173-199)."""

    def __init__(self, channels: int, dims: int):
        super().__init__()
        stride = (1, 2, 2) if dims == 3 else 2
        self.op = conv_nd(dims, channels, channels, 3, stride=stride, padding=1)

    def forward(self, x):
        return self.op(x)


class ResBlock(nn.Module):
    """GN-SiLU-conv, + time embedding, GN-SiLU-zero conv, + skip
    (openai_model_3d.py:202-314).  Children are indexed as the reference's
    in_layers / emb_layers / out_layers."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None, dims: int = 3):
        super().__init__()
        out_channels = out_channels or channels
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(),
            conv_nd(dims, channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(0.0),
            zero_module(conv_nd(dims, out_channels, out_channels, 3,
                                padding=1)))
        if out_channels == channels:
            self.skip_connection = nn.Identity()
        else:
            self.skip_connection = conv_nd(dims, channels, out_channels, 1)

    def forward(self, x, emb):
        h = self.in_layers(x)
        emb_out = self.emb_layers(emb)
        h = self.out_layers[0](h, shift=emb_out)
        h = self.out_layers[3](F.silu(h))
        return self.skip_connection(x) + h
