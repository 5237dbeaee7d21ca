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

from .. import trace
from ..kernels import group_norm as gn_kernel
from .layers import Conv3d, Linear, conv_nd
from .quant import Int8Conv3d, RoundedSiLU


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


def act_mode(act: Optional[nn.Module]) -> Optional[str]:
    """The kernel's name (`kernels.group_norm.ACTS`) of the activation
    module that follows a norm, or None for one the kernel does not
    compute."""
    if act is None:
        return "none"
    if type(act) is nn.SiLU:
        return "silu"
    if type(act) is RoundedSiLU:
        return "rounded_silu"
    return None


def plain_reason(x: torch.Tensor, norm: nn.GroupNorm,
                 act: Optional[nn.Module] = None,
                 shift: Optional[torch.Tensor] = None) -> Optional[str]:
    """Why `group_norm_act` computes these inputs by the modules, or None
    where it launches the fused kernel.  The kernel computes the same
    function only for a bf16 x with three spatial dims, with nothing for
    autograd to record (it has no backward) and an activation it knows,
    on a CUDA device (checked last, so that each other reason shows on the
    CPU).  Nothing else keeps x from it: the kernel raises on a slab it
    cannot take (`kernels.group_norm.unfit`)."""
    if x.dtype != torch.bfloat16:
        return f"dtype {x.dtype}, not bfloat16"
    if x.dim() != 5:
        return f"{x.dim() - 2} spatial dims, not 3"
    tensors = (x, norm.weight, norm.bias) + (() if shift is None
                                              else (shift,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return "autograd records"
    if act_mode(act) is None:
        return f"activation {type(act).__name__}"
    if x.device.type != "cuda":
        return f"on {x.device.type}, not CUDA"
    return None


def group_norm_act(x: torch.Tensor, norm: nn.GroupNorm,
                   act: Optional[nn.Module] = None,
                   shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(norm(x, shift=shift)) (just the norm where `act` is None): by
    the fused kernel (`kernels.group_norm`, on x made contiguous) where
    `plain_reason` finds nothing against it, else by the modules.  Each
    call on x with three spatial dims is a `norm3d` span, and a call that
    takes the kernel holds a `norm3d_fused` span."""
    if x.dim() != 5:
        return _norm_act(x, norm, act, shift)
    with trace.span("norm3d"):
        if plain_reason(x, norm, act, shift) is None:
            with trace.span("norm3d_fused"):
                return gn_kernel.group_norm_act(
                    x.contiguous(), norm.num_groups, norm.eps, norm.weight,
                    norm.bias, shift, act_mode(act))
        return _norm_act(x, norm, act, shift)


def _norm_act(x, norm, act, shift):
    h = norm(x, shift=shift)
    return h if act is None else act(h)


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


def _parities(up_axes: Sequence[int]):
    """Every output parity, one bit an axis of `up_axes`, in JAX's order."""
    parities = [()]
    for _ in up_axes:
        parities = [p + (r,) for p in parities for r in (0, 1)]
    return parities


def factored_parities(weight: torch.Tensor, up_axes: Sequence[int]):
    """[(parity, sub-kernel)] of the factored upsample: for each output
    parity (one bit an axis of `up_axes`, in order) the 3-tap kernel's taps
    summed into 2 along each upsampled axis, [W0, W1 + W2] for parity 0
    and [W0 + W1, W2] for parity 1, in the weight's dtype, axis by axis in
    `up_axes` order (JAX's sub_kernel)."""
    out = []
    for parity in _parities(up_axes):
        w = weight
        for s, r in zip(up_axes, parity):
            w0, w1, w2 = w.unbind(2 + s)
            w = torch.stack((w0, w1 + w2) if r == 0 else (w0 + w1, w2),
                            dim=2 + s)
        out.append((parity, w))
    return out


def factored_upsample_conv(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor],
                           up_axes: Sequence[int], quantized: bool = False,
                           int8_subs=None) -> torch.Tensor:
    """Nearest-2x upsample on the spatial axes `up_axes` followed by a SAME
    3^r convolution, computed exactly as 2^len(up_axes) convolutions on the
    pre-upsample grid (JAX's factored_upsample_conv, echoscene_tpu/nn/
    blocks.py:122-215).

    Output position 2i + r along an upsampled axis reads only input rows
    {i - 1, i} (r = 0: taps [W0, W1 + W2], padded (1, 0)) or {i, i + 1}
    (r = 1: taps [W0 + W1, W2], padded (0, 1)), so each parity is a 2-tap
    convolution along that axis (`factored_parities`); the parities are
    written into strided views of the output, with no repeat tensor.  The
    UNet's (D, H, W) -> (D, 2H, 2W) upsample (up_axes (1, 2)) runs 4
    sub-convolutions, the VQ decoder's all-axes upsample (up_axes (0, 1,
    2)) 8.

    x (B, C, *spatial) channel-first, weight (K, C, 3, ...), bias (K,) or
    None.  As in JAX, x is cast to the weight's dtype, the taps are summed
    in the weight's dtype, each sub-convolution's output is rounded to that
    dtype, and the bias is added in f32 (whatever its own dtype) before the
    result is rounded once more.

    `quantized` (3D only) is JAX's W8A8 form (blocks.py:174-198): x cast to
    bf16 and quantized once for all parities (kernel Q1), each parity's
    sub-kernel summed in f32 from the f32 master weight and quantized per
    output channel (`int8_subs`, the (wq, w_scale) pairs in parity order
    that `nn.quant.Int8Conv3d` prepares once, else made here), each
    sub-output dequantized to bf16 without bias by kernel Q2 straight into
    its strided view, then the f32 bias and a last bf16 rounding."""
    rank = x.dim() - 2
    out_spatial = tuple(n * (2 if s in up_axes else 1)
                        for s, n in enumerate(x.shape[2:]))
    if quantized:
        from .quant import quantize_act, quantize_weight
        from ..kernels.int8_conv import int8_conv3d
        if rank != 3:
            raise ValueError("the quantized factored upsample is 3D")
        if int8_subs is None:
            int8_subs = [quantize_weight(w) for _, w in
                         factored_parities(weight.float(), up_axes)]
        xq, xs = quantize_act(x.to(torch.bfloat16).contiguous())
        out = torch.empty((x.shape[0], weight.shape[0]) + out_spatial,
                          dtype=torch.bfloat16, device=x.device)
        for parity, (wq, ws) in zip(_parities(up_axes), int8_subs):
            it = dict(zip(up_axes, parity))
            pads = tuple(((1, 0) if it[s] == 0 else (0, 1)) if s in it
                         else (1, 1) for s in range(3))
            dst = [slice(None), slice(None)] + [
                slice(it[s], None, 2) if s in it else slice(None)
                for s in range(3)]
            int8_conv3d(xq, wq, xs, ws, None, (1, 1, 1), pads,
                        out=out[tuple(dst)])
    else:
        x = x.to(weight.dtype)
        conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[rank]
        xp = F.pad(x, (1, 1) * rank)
        out = x.new_empty((x.shape[0], weight.shape[0]) + out_spatial)
        for parity, w in factored_parities(weight, up_axes):
            src = [slice(None), slice(None)] + [slice(None)] * rank
            dst = [slice(None), slice(None)] + [slice(None)] * rank
            for s, r in zip(up_axes, parity):
                n = x.shape[2 + s]
                # pad (1, 0) or (0, 1) on this axis: a window of the (1, 1)
                # pad
                src[2 + s] = slice(r, r + n + 1)
                dst[2 + s] = slice(r, None, 2)
            out[tuple(dst)] = conv(xp[tuple(src)], w)
    if bias is not None:
        # an add in f32 (at least), rounded once to the output's dtype
        b = bias.to(torch.promote_types(bias.dtype, torch.float32))
        out.add_(b.reshape((1, -1) + (1,) * rank))
    return out


class WinogradConv3d(Conv3d):
    """A SAME stride-1 3x3x3 Conv3d computed by Winograd F(2,3)^3
    (`kernels.winograd.winograd_conv3d`; JAX's WinogradConv3d,
    echoscene_tpu/nn/blocks.py:246-269): same parameters, 3.375x fewer
    multiply-adds, all stages matrix products; D, H, W must be even.  The
    input is cast to `act_dtype` (its own dtype when None); the weight
    transform runs in f32 from the (f32) weight, once when `prepare_` is
    called (the sampling twin does), else on every call."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.act_dtype: Optional[torch.dtype] = None
        self.register_buffer("u", None, persistent=False)

    @classmethod
    def from_conv(cls, conv: nn.Conv3d) -> "WinogradConv3d":
        """A WinogradConv3d holding `conv`'s parameters."""
        new = cls(conv.in_channels, conv.out_channels, conv.kernel_size,
                  stride=conv.stride, padding=conv.padding,
                  bias=conv.bias is not None, device="meta")
        new.weight, new.bias = conv.weight, conv.bias
        return new

    @torch.no_grad()
    def prepare_(self, act_dtype: torch.dtype) -> "WinogradConv3d":
        from ..kernels.winograd import transform_weights
        self.act_dtype = act_dtype
        self.u = transform_weights(self.weight).to(act_dtype)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..kernels.winograd import winograd_conv3d
        x = x.to(self.act_dtype or x.dtype)
        return winograd_conv3d(x, self.weight, self.bias, u=self.u)


def _conv3x3(dims: int, c_in: int, c_out: int, winograd: bool) -> nn.Module:
    """The SAME 3^dims convolution, Winograd's in 3D when asked."""
    if winograd and dims == 3:
        return WinogradConv3d(c_in, c_out, 3, padding=1)
    return conv_nd(dims, c_in, c_out, 3, padding=1)


class Upsample(nn.Module):
    """Nearest-2x upsample of the inner two dims (3D) / identity (1D) + conv
    (openai_model_3d.py:148-157; denoise_net.py:147-157).

    `factored` (3D only) computes the upsample + conv pair as
    `factored_upsample_conv`: 2.25x fewer multiply-adds and no upsampled
    tensor.  It is set on the sampling twin only (`models.sgdiff.
    inference_twin`), as JAX sets it: JAX measured the factored form's
    backward 2.2x slower than interpolate + conv's (echoscene_tpu/nn/
    blocks.py:318-321).  The parameters are the conv's either way.  Under
    the int8 mode the twin's conv is an `Int8Conv3d` and the factored form
    runs quantized.  With `winograd` (3D) the conv is a WinogradConv3d and
    the upsample is never factored (JAX's Upsample, blocks.py:322-327)."""

    def __init__(self, channels: int, dims: int, factored: bool = False,
                 winograd: bool = False):
        super().__init__()
        self.dims = dims
        self.factored = factored
        self.winograd = winograd and dims == 3
        self.conv = _conv3x3(dims, channels, channels, self.winograd)

    def forward(self, x):
        if self.dims == 3 and self.factored and not self.winograd:
            conv = self.conv
            if isinstance(conv, Int8Conv3d):
                return factored_upsample_conv(
                    x, conv.weight, conv.bias, (1, 2), quantized=True,
                    int8_subs=conv.factored_subs())
            return factored_upsample_conv(x, conv.weight, conv.bias, (1, 2))
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
    in_layers / emb_layers / out_layers.  With `winograd` (3D) the two
    3x3x3 convolutions are WinogradConv3d (JAX's ResBlock(winograd=True));
    the skip stays direct."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None, dims: int = 3,
                 winograd: bool = False):
        super().__init__()
        out_channels = out_channels or channels
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(),
            _conv3x3(dims, channels, out_channels, winograd))
        self.emb_layers = nn.Sequential(nn.SiLU(),
                                        Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), nn.SiLU(), nn.Dropout(0.0),
            zero_module(_conv3x3(dims, out_channels, out_channels,
                                 winograd)))
        if out_channels == channels:
            self.skip_connection = nn.Identity()
        else:
            self.skip_connection = conv_nd(dims, channels, out_channels, 1)

    def forward(self, x, emb):
        h = self.in_layers[2](group_norm_act(x, self.in_layers[0],
                                             self.in_layers[1]))
        emb_out = self.emb_layers(emb)
        h = group_norm_act(h, self.out_layers[0], self.out_layers[1],
                           shift=emb_out)
        h = self.out_layers[3](h)
        return self.skip_connection(x) + h
