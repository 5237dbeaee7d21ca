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
unchanged) plus the quantized weight as non-persistent buffers.

Under tensor parallelism (parallel/tp.py) a ResBlock's `out_layers.3` holds
a shard of the weight's input channels and sees a shard of the activation's
channels.  Its row-split form (`Int8Conv3d(conv, row_split=plan)`) equals
the unsharded convolution bit for bit through three collectives over the
model group, where JAX gets the same from GSPMD:

  * at construction, the per-output-channel weight abs-max of the shard
    folded by a MAX all-reduce, so every rank quantizes its shard with the
    scales of the whole weight (building the twin is collective);
  * in the forward, the activation's abs-max word (Q1's first pass,
    `quantize_amax`) folded by a MAX all-reduce before the quantize
    (`quantize_with_amax`): each rank's int8 values are its slice of the
    whole tensor's;
  * Q2's int32 accumulators (`int8_conv3d_acc`) added by a SUM all-reduce
    in int32 (exact; f32 would not be: they reach ~2.9e8), then one
    `dequantize` with the bias, the fused epilogue's arithmetic in torch
    ops (product rounded, then the bias, then bf16; no FMA).

JAX's ECHOSCENE_INT8_FIXED_SCALE measurement hook (a constant activation
scale whose outputs are wrong by design) is not ported.

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

import torch.distributed as dist

from ..kernels.int8_conv import (dequantize, int8_conv3d, int8_conv3d_acc,
                                 padded_channels, quantize_act,
                                 quantize_amax, quantize_symmetric,
                                 quantize_with_amax, quantize_with_scale,
                                 scale_of)
from ..parallel.mesh import all_reduce_
from .layers import Linear

__all__ = ["quantize_symmetric", "quantize_act", "quantize_weight",
           "Int8Conv3d", "Int8Linear", "RoundedSiLU", "jax_rounding_"]


def weight_amax(w: torch.Tensor) -> torch.Tensor:
    """The per-output-channel abs-max (K,) f32 of a (K, C, ...) weight."""
    return w.float().abs().amax(dim=tuple(range(1, w.dim())))


def quantize_weight(w: torch.Tensor, amax: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (K, C, kd, kh, kw) f32 weight -> (wq (K, kd, kh, kw, Cp) int8 in
    Q2's layout, zero channels past C; w_scale (K,) f32), per output
    channel: the scales of `w`'s own abs-max, or of `amax` (K,) when given
    (a row shard quantized with the whole weight's scales)."""
    if amax is None:
        q, scale = quantize_symmetric(w, dims=range(1, w.dim()))
    else:
        scale = scale_of(amax.float()).reshape((-1,) + (1,) * (w.dim() - 1))
        q = quantize_with_scale(w, scale)
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
    in f32 from the master weight, then quantized.

    With `row_split` (an object whose `group` is a model group, as
    `parallel.tp.TPPlan`) it is the row-split form (module docstring): the
    conv's weight is this rank's shard of the input channels, every rank
    of the group must construct it together (the weight scales are a MAX
    over the group), and each forward runs the group's collectives."""

    def __init__(self, conv: nn.Conv3d,
                 up_axes: Optional[Sequence[int]] = None,
                 row_split=None):
        super().__init__()
        if isinstance(conv.padding, str):
            raise ValueError("Int8Conv3d takes numeric padding")
        if row_split is not None and up_axes is not None:
            raise ValueError("the row-split form has no factored upsample")
        self.weight = conv.weight
        self.bias = conv.bias
        self.stride = tuple(conv.stride)
        self.pads = _pads(conv.padding)
        self.up_axes = None if up_axes is None else tuple(up_axes)
        self.row_split = row_split
        with torch.no_grad():
            amax = None
            if row_split is not None:
                amax = _group_max(weight_amax(self.weight), row_split.group)
            wq, ws = quantize_weight(self.weight.float(), amax)
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

    def accumulate(self, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The row-split form's int32 accumulators, summed over the model
        group, and the activation scale (the whole tensor's)."""
        group = self.row_split.group
        x = x.contiguous()
        amax = _group_max(quantize_amax(x), group)
        xq, xs = quantize_with_amax(x, amax)
        acc = int8_conv3d_acc(xq, self.wq, self.stride, self.pads)
        return all_reduce_(acc, dist.ReduceOp.SUM, group=group), xs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.float()
        if self.row_split is not None:
            acc, xs = self.accumulate(x)
            return dequantize(acc, xs, self.w_scale, bias)
        xq, xs = quantize_act(x.contiguous())
        return int8_conv3d(xq, self.wq, xs, self.w_scale, bias, self.stride,
                           self.pads)


def _group_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise MAX of `t` over `group` (in place).  An f32 tensor of
    non-negative values is reduced as its int32 bit patterns, which order
    as the floats do: an exact MAX, the abs-max words' own order."""
    if t.dtype == torch.float32:
        all_reduce_(t.view(torch.int32), dist.ReduceOp.MAX, group=group)
        return t
    return all_reduce_(t, dist.ReduceOp.MAX, group=group)


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
