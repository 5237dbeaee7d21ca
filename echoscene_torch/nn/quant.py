"""Int8 (W8A8) convolutions of the sampling path.

Port of echoscene_tpu/nn/quant.py.  Under `sample_dtype: int8` the shape
denoiser's torso convolutions compute in int8 with int32 accumulation:

  * weights: symmetric per-output-channel scales, quantized once from the
    f32 master weight when the sampling twin is built (JAX quantizes inside
    the program and XLA hoists it out of the sampling scan);
  * activations: a symmetric per-tensor dynamic scale (abs-max) on every
    call, taken over the whole input tensor (kernel Q1,
    `kernels.int8_conv.quantize_act`);
  * the convolution accumulates in int32 and dequantizes with the product
    of both scales, acc * (x_scale * w_scale[k]) + bias in f32, then bf16
    (kernel Q2, `kernels.int8_conv.int8_conv3d`).

`Int8Conv3d` / `Int8Linear` hold the same `weight` / `bias` parameters as
the Conv3d / Linear they replace (the weight bridge and state_dict keys are
unchanged) plus the quantized weight as non-persistent buffers.  JAX's
ECHOSCENE_INT8_FIXED_SCALE measurement hook (a constant activation scale
whose outputs are wrong by design) is not ported.

A one-ulp bf16 difference in a quantized convolution's input flips the int8
value next to it, and at the tensor's abs-max it moves the scale and every
int8 value with it.  So around the quantized convolutions the int8 twin
rounds where JAX's bf16 ops round (`jax_rounding_`): SiLU on bf16 in JAX's
steps (`RoundedSiLU`), the time embedding's Linears' products rounded before
their bias is added (flax's Dense), the GroupNorms' affine parameters kept
f32 (JAX never casts them).  With these an int8 ResBlock equals JAX's bit
for bit on the CPU (tests/test_torch_quant.py).  Beyond the ResBlocks (the
attention, the echo pass) the two packages' matrix products sum in other
orders, and the rare one-ulp differences this leaves are amplified by the
per-tensor scales downstream.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.int8_conv import (int8_conv3d, padded_channels,
                                 quantize_act, quantize_symmetric)
from .layers import Linear

__all__ = ["quantize_symmetric", "quantize_act", "quantize_weight",
           "Int8Conv3d", "Int8Linear", "RoundedSiLU", "jax_rounding_"]


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (K, C, kd, kh, kw) f32 weight -> (wq (K, kd, kh, kw, Cp) int8 in
    Q2's layout, zero channels past C; w_scale (K,) f32), per output
    channel."""
    q, scale = quantize_symmetric(w, dims=range(1, w.dim()))
    c = w.shape[1]
    q = F.pad(q.movedim(1, -1), (0, padded_channels(c) - c))
    return q.contiguous(), scale.reshape(-1).contiguous()


def _pads(padding: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(p), int(p)) for p in padding)


class Int8Conv3d(nn.Module):
    """A Conv3d computed W8A8 (JAX's Int8Conv): the input quantized per
    tensor in the dtype it arrives in, the f32 weight per output channel
    once at construction, int32 accumulation, bf16 output.  Built from the
    Conv3d it replaces and sharing its parameters.  With `up_axes` it also
    holds the quantized 2-tap sub-kernels of the factored upsample
    (`nn.blocks.factored_upsample_conv(..., quantized=True)`), each summed
    in f32 from the master weight, then quantized."""

    def __init__(self, conv: nn.Conv3d,
                 up_axes: Optional[Sequence[int]] = None):
        super().__init__()
        if isinstance(conv.padding, str):
            raise ValueError("Int8Conv3d takes numeric padding")
        self.weight = conv.weight
        self.bias = conv.bias
        self.stride = tuple(conv.stride)
        self.pads = _pads(conv.padding)
        self.up_axes = None if up_axes is None else tuple(up_axes)
        with torch.no_grad():
            wq, ws = quantize_weight(self.weight.float())
            self.register_buffer("wq", wq, persistent=False)
            self.register_buffer("w_scale", ws, persistent=False)
            if self.up_axes is not None:
                from .blocks import factored_parities
                for i, (_, sub) in enumerate(factored_parities(
                        self.weight.float(), self.up_axes)):
                    q, s = quantize_weight(sub)
                    self.register_buffer(f"sub{i}_wq", q, persistent=False)
                    self.register_buffer(f"sub{i}_w_scale", s,
                                         persistent=False)

    def factored_subs(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The quantized sub-kernels (wq, w_scale) in parity order."""
        n = 2 ** len(self.up_axes)
        return [(getattr(self, f"sub{i}_wq"), getattr(self, f"sub{i}_w_scale"))
                for i in range(n)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, xs = quantize_act(x.contiguous())
        bias = None if self.bias is None else self.bias.float()
        return int8_conv3d(xq, self.wq, xs, self.w_scale, bias, self.stride,
                           self.pads)


class Int8Linear(nn.Module):
    """A Linear computed W8A8 (JAX's Int8Dense): per-output-feature weight
    scales, a per-tensor activation scale, int32 accumulation, bf16 output;
    through Q1 and Q2 as a 1x1x1 convolution of the rows.  No model path
    uses it: attention stays bf16 under the int8 mode, as in JAX."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        self.weight = linear.weight
        self.bias = linear.bias
        with torch.no_grad():
            w = self.weight.float()
            wq, ws = quantize_weight(w.reshape(w.shape + (1, 1, 1)))
            self.register_buffer("wq", wq, persistent=False)
            self.register_buffer("w_scale", ws, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, c = x.shape[:-1], x.shape[-1]
        rows = x.reshape(-1, c, 1, 1, 1).contiguous()
        xq, xs = quantize_act(rows)
        bias = None if self.bias is None else self.bias.float()
        y = int8_conv3d(xq, self.wq, xs, self.w_scale, bias, (1, 1, 1),
                        ((0, 0),) * 3)
        return y.reshape(*lead, -1)


class RoundedSiLU(nn.Module):
    """SiLU as JAX computes it on a bf16 tensor, x * (1 / (1 + exp(-x)))
    with every op rounded to bf16 (jax.nn.silu -> logistic: negate, exp,
    add, divide, then multiply); F.silu on other dtypes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16:
            return F.silu(x)
        t = torch.neg(x)
        t.exp_()
        t.add_(1.0)
        t.reciprocal_()
        return t.mul_(x)


def jax_rounding_(denoiser: nn.Module) -> set:
    """Make the shape denoiser's time MLP, its torso's ResBlocks and its
    output head round where JAX's bf16 ops round (module docstring), in
    place: their SiLUs in JAX's bf16 steps, their Linears' products
    rounded before the bias is added (flax's Dense).  Returns the ids of
    those ResBlocks' and the head's GroupNorm parameters, which stay f32.
    The SpatialTransformers, the echo pass and the rest of the twin are the
    bf16 twin's."""
    from .blocks import ResBlock

    def silu(seq, i):
        if type(seq[i]) is nn.SiLU:
            seq[i] = RoundedSiLU()

    def linear(seq, i):
        if isinstance(seq[i], Linear):
            seq[i].round_before_bias = True

    keep = set()
    te = getattr(denoiser, "time_embed", None)
    if te is not None:
        linear(te, 0)
        silu(te, 1)
        linear(te, 2)
    for m in denoiser.modules():
        if isinstance(m, ResBlock):
            silu(m.in_layers, 1)
            silu(m.out_layers, 1)
            silu(m.emb_layers, 0)
            linear(m.emb_layers, 1)
            for gn in (m.in_layers[0], m.out_layers[0]):
                keep |= {id(p) for p in gn.parameters()}
    out = getattr(denoiser, "out", None)
    if out is not None:
        keep |= {id(p) for p in out[0].parameters()}
        silu(out, 1)
    return keep
