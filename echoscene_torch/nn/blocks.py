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
from typing import Optional, Sequence

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


def factored_upsample_conv(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor],
                           up_axes: Sequence[int]) -> torch.Tensor:
    """Nearest-2x upsample on the spatial axes `up_axes` followed by a SAME
    3^r convolution, computed exactly as 2^len(up_axes) convolutions on the
    pre-upsample grid (JAX's factored_upsample_conv, echoscene_tpu/nn/
    blocks.py:122-215).

    Output position 2i + r along an upsampled axis reads only input rows
    {i - 1, i} (r = 0: taps [W0, W1 + W2], padded (1, 0)) or {i, i + 1}
    (r = 1: taps [W0 + W1, W2], padded (0, 1)), so each parity is a 2-tap
    convolution along that axis; the parities are written into strided
    views of the output, with no repeat tensor.  The UNet's (D, H, W) ->
    (D, 2H, 2W) upsample (up_axes (1, 2)) runs 4 sub-convolutions, the VQ
    decoder's all-axes upsample (up_axes (0, 1, 2)) 8.

    x (B, C, *spatial) channel-first, cast to the weight's dtype; weight
    (K, C, 3, ...), bias (K,) or None.  As in JAX, the taps are summed in
    the weight's dtype, axis by axis in `up_axes` order, each
    sub-convolution's output is rounded to that dtype, and the bias is
    added in f32 (whatever its own dtype) before the result is rounded
    once more."""
    x = x.to(weight.dtype)
    rank = x.dim() - 2
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[rank]
    xp = F.pad(x, (1, 1) * rank)
    out = x.new_empty((x.shape[0], weight.shape[0]) + tuple(
        n * (2 if s in up_axes else 1) for s, n in enumerate(x.shape[2:])))
    parities = [()]
    for _ in up_axes:
        parities = [p + (r,) for p in parities for r in (0, 1)]
    for parity in parities:
        w = weight
        src = [slice(None), slice(None)] + [slice(None)] * rank
        dst = [slice(None), slice(None)] + [slice(None)] * rank
        for s, r in zip(up_axes, parity):
            w0, w1, w2 = w.unbind(2 + s)
            w = torch.stack((w0, w1 + w2) if r == 0 else (w0 + w1, w2),
                            dim=2 + s)
            n = x.shape[2 + s]
            # pad (1, 0) or (0, 1) on this axis: a window of the (1, 1) pad
            src[2 + s] = slice(r, r + n + 1)
            dst[2 + s] = slice(r, None, 2)
        out[tuple(dst)] = conv(xp[tuple(src)], w)
    if bias is not None:
        # an add in f32 (at least), rounded once to the output's dtype
        b = bias.to(torch.promote_types(bias.dtype, torch.float32))
        out.add_(b.reshape((1, -1) + (1,) * rank))
    return out


class Upsample(nn.Module):
    """Nearest-2x upsample of the inner two dims (3D) / identity (1D) + conv
    (openai_model_3d.py:148-157; denoise_net.py:147-157).

    `factored` (3D only) computes the upsample + conv pair as
    `factored_upsample_conv`: 2.25x fewer multiply-adds and no upsampled
    tensor.  It is set on the sampling twin only (`models.sgdiff.
    inference_twin`), as JAX sets it: JAX measured the factored form's
    backward 2.2x slower than interpolate + conv's (echoscene_tpu/nn/
    blocks.py:318-321).  The parameters are the conv's either way."""

    def __init__(self, channels: int, dims: int, factored: bool = False):
        super().__init__()
        self.dims = dims
        self.factored = factored
        self.conv = conv_nd(dims, channels, channels, 3, padding=1)

    def forward(self, x):
        if self.dims == 3 and self.factored:
            return factored_upsample_conv(x, self.conv.weight, self.conv.bias,
                                          (1, 2))
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
