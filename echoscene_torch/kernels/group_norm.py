"""GroupNorm (+ a per-channel shift) + activation: CUDA kernel + plain
version.

A hand kernel of the port with no Pallas counterpart: JAX's group_norm_fast
(echoscene_tpu/nn/blocks.py) is fused with its shift and the SiLU after it
by XLA.  In PyTorch the same function is `nn.blocks.group_norm` (x to f32,
+ shift, the statistics, the apply, back to x's dtype) and then the
activation module, five to nine passes over device memory; the kernel,
`csrc/group_norm_act.cu`, reads each (row, group) slab once into shared
memory and writes the result once.

`group_norm_act(x, groups, eps, weight, bias, shift, act)`: act(bf16(
GN(x + shift))) for x (N, C, *spatial) with `act` one of ACTS: "none",
"silu" (F.silu, nn.SiLU) or "rounded_silu" (nn.quant.RoundedSiLU, each
of its ops rounded to bf16).  On a CPU tensor it computes the plain version,
`group_norm_act_plain`, which is the code the kernel replaces; on a CUDA
tensor it launches the kernel or raises on what the kernel does not take
(`unfit` says what).  `LAUNCHES` counts kernel launches; `gap_to_plain`
holds the kernel to the plain version on the card; `group_norm_bound`
gives the least time one H100 could take.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import build

SOURCE = "group_norm_act.cu"
ACTS = {"none": 0, "silu": 1, "rounded_silu": 2}
LAUNCHES: Dict[str, int] = {"group_norm_act": 0}
# csrc/group_norm_act.cu's shared memory: a header (mbarriers, warp sums),
# shift / scale / offset of each channel of the group, then the slab
HEADER_BYTES = 256
MAX_SMEM = 232448           # a block's dynamic shared memory on sm_90
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 (NVIDIA's data sheet)
# `gap_to_plain`'s room for the statistics' summation order: 2^-20 of the
# slab's scale, some 8 f32 ulps (the card reads ~2^-26)
STAT_TOL = 2.0 ** -20
_entries: Dict[str, ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def smem_bytes(channels_per_group: int, positions: int) -> int:
    """The kernel's shared memory for one slab of `channels_per_group`
    channels of `positions` spatial positions each."""
    params = -(-12 * channels_per_group // 16) * 16
    return HEADER_BYTES + params + 2 * channels_per_group * positions


def unfit(x: torch.Tensor, groups: int) -> Optional[str]:
    """What of x keeps it from the kernel, or None where the kernel takes
    it: bf16, channel-first with three spatial dims, contiguous, 16-byte
    aligned, a multiple of 8 positions a channel (16-byte words of one
    channel) and a (row, group) slab that fits a block's shared memory."""
    if x.dtype != torch.bfloat16:
        return f"dtype {x.dtype}, not bfloat16"
    if x.dim() != 5:
        return f"{x.dim() - 2} spatial dims, not 3"
    c = x.shape[1]
    positions = x[0, 0].numel()
    if groups < 1 or c % groups:
        return f"{groups} groups do not divide {c} channels"
    if positions % 8:
        return f"{positions} positions a channel, not a multiple of 8"
    if smem_bytes(c // groups, positions) > MAX_SMEM:
        return (f"a slab of {c // groups} x {positions} does not fit "
                f"{MAX_SMEM} bytes of shared memory")
    if not x.is_contiguous() or x.data_ptr() % 16:
        return "not contiguous and 16-byte aligned"
    return None


def activation_plain(y: torch.Tensor, act: str) -> torch.Tensor:
    """The activation after the norm as the modules compute it."""
    if act == "none":
        return y
    if act == "silu":
        return F.silu(y)
    if act == "rounded_silu":
        from ..nn.quant import RoundedSiLU
        return RoundedSiLU()(y)
    raise ValueError(f"activation {act!r}: one of {sorted(ACTS)}")


def group_norm_act_plain(x: torch.Tensor, groups: int, eps: float,
                         weight: torch.Tensor, bias: torch.Tensor,
                         shift: Optional[torch.Tensor] = None,
                         act: str = "none") -> torch.Tensor:
    """The kernel's plain version, the code it replaces: `nn.blocks.
    group_norm` (f32 statistics, x + shift formed in f32, the result in x's
    dtype), then the activation on that."""
    from ..nn.blocks import group_norm
    return activation_plain(group_norm(x, groups, eps, weight, bias, shift),
                            act)


def _entry():
    with _lock:
        fn = _entries.get("group_norm_act")
        if fn is None:
            fn = build.load(SOURCE).echoscene_group_norm_act
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                    ctypes.c_void_p,
                                                    ctypes.c_int,
                                                    ctypes.c_void_p,
                                                    ctypes.c_int]
                           + [ctypes.c_int] * 3
                           + [ctypes.c_longlong, ctypes.c_float,
                              ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _entries["group_norm_act"] = fn
        return fn


def _check_param(name: str, t: torch.Tensor, numel: int, dev) -> None:
    if (t.device != dev or t.dtype not in (torch.bfloat16, torch.float32)
            or t.numel() != numel or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous bf16 or f32 tensor of "
                         f"{numel} values on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def group_norm_act(x: torch.Tensor, groups: int, eps: float,
                   weight: torch.Tensor, bias: torch.Tensor,
                   shift: Optional[torch.Tensor] = None,
                   act: str = "none") -> torch.Tensor:
    """act(bf16(GroupNorm(x + shift))): x (N, C, D, H, W) bf16, weight and
    bias (C,) and shift (N, C) (or None) bf16 or f32 -> (N, C, D, H, W)
    bf16.  CUDA: the kernel; CPU: `group_norm_act_plain`."""
    if x.device.type == "cpu":
        return group_norm_act_plain(x, groups, eps, weight, bias, shift, act)
    why = unfit(x, groups)
    if why is not None:
        raise ValueError(f"group_norm_act: {why}")
    if act not in ACTS:
        raise ValueError(f"activation {act!r}: one of {sorted(ACTS)}")
    n, c = x.shape[:2]
    _check_param("weight", weight, c, x.device)
    _check_param("bias", bias, c, x.device)
    if shift is not None:
        _check_param("shift", shift, n * c, x.device)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def dtype_flag(t):
        return int(t is not None and t.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        err = _entry()(
            x.data_ptr(), y.data_ptr(), weight.data_ptr(), dtype_flag(weight),
            bias.data_ptr(), dtype_flag(bias),
            None if shift is None else shift.data_ptr(), dtype_flag(shift),
            n, c, groups, x[0, 0].numel(), eps, ACTS[act], stream)
    if err != 0:
        raise RuntimeError(f"group_norm_act kernel launch failed: CUDA error "
                           f"{err}")
    with _lock:
        LAUNCHES["group_norm_act"] += 1
    return y


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of the bf16 values at each element of the bf16 tensor
    t, as f64 (the least subnormal's at 0)."""
    _, e = torch.frexp(t.double())
    return torch.where(t == 0, torch.full_like(e, -133, dtype=torch.float64)
                       .exp2(), (e - 8).double().exp2())


def gap_to_plain(x: torch.Tensor, groups: int, eps: float,
                 weight: torch.Tensor, bias: torch.Tensor,
                 shift: Optional[torch.Tensor], act: str,
                 got: torch.Tensor) -> Dict:
    """How far the kernel's output `got` lies from the plain version on
    the same inputs.  The two compute the same function but sum the f32
    statistics in other orders, so their f32 mean and rstd differ by a
    few f32 ulps, which moves an output near 0 by many bf16 ulps of its
    own (an element at the mean is a difference of two near-equal f32
    values).  So the norm is held to its error model: the kernel's norm
    (`act` "none", launched here) lies within `STAT_TOL` of the slab's
    and the affine's scale of the plain version's unrounded f32 norm,
    STAT_TOL * (|a_c| * (|v - mean| + |mean| + std) + |bias[c]|) (v = x +
    shift, a_c = rstd * weight[c], the statistics in f64; the bias term
    for the affine's f32 rounding, which the two also do in other orders),
    plus half a bf16 ulp of its own for its rounding to nearest; and the
    activation is exact: `got` equals the plain activation of the kernel's
    norm bit for bit.  Returns `norm_of_bound`, the worst gap of
    the norm over that allowance (at most 1 passes); `act_exact`;
    `max_ulps`, the worst gap of `got` to the plain output in bf16 ulps,
    and `differ`, the share of its elements that differ (both printed,
    neither bounded)."""
    from .int8_conv import bf16_ulps
    norm = group_norm_act(x, groups, eps, weight, bias, shift, "none")
    act_exact = bool(torch.equal(got, activation_plain(norm, act)))
    worst = 0.0
    max_ulps, differ = 0, 0
    n, c = x.shape[:2]
    rows = 16    # a pass's rows: f64 copies of at most ~0.4 GB each
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        xs = x[r0:r1]
        sh = None if shift is None else shift[r0:r1]
        y32 = group_norm_act_plain(xs.float(), groups, eps, weight, bias, sh)
        want = activation_plain(y32.to(torch.bfloat16), act)
        ulps = bf16_ulps(got[r0:r1], want)
        max_ulps = max(max_ulps, int(ulps.max()))
        differ += int((ulps > 0).sum())
        v = xs.double()
        if sh is not None:
            v = v + sh.double().reshape(r1 - r0, c, *(1,) * (x.dim() - 2))
        # (rows, groups, channels of a group, positions)
        v = v.reshape(r1 - r0, groups, c // groups, -1)
        mean = v.mean((2, 3), keepdim=True)
        var = v.var((2, 3), unbiased=False, keepdim=True)
        a = ((var + eps).rsqrt() * weight.double().reshape(
            1, groups, -1, 1)).abs()
        allow = (STAT_TOL * (a * ((v - mean).abs() + mean.abs()
                                  + var.sqrt())
                             + bias.double().abs().reshape(1, groups, -1, 1))
                 + 0.5 * _bf16_ulp(norm[r0:r1]).reshape(v.shape))
        gap = (norm[r0:r1].double() - y32.double()).abs().reshape(v.shape)
        worst = max(worst, float((gap / allow).max()))
    return {"norm_of_bound": worst, "act_exact": act_exact,
            "max_ulps": max_ulps, "differ": differ / got.numel()}


def group_norm_bound(numel: int) -> Dict:
    """The least time one H100 could take: read x once and write y once,
    2 + 2 bytes an element at 3.35 TB/s (the few operations an element
    and the parameters are far below it)."""
    nbytes = 4 * numel
    ms = nbytes / PEAK_BYTES * 1e3
    return {"ms": ms, "bound_by": "bytes", "bytes": nbytes}

