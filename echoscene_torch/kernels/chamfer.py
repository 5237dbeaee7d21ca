"""One-way squared nearest-neighbour distance and chamfer: CUDA kernel + plain.

Replaces the Pallas TPU kernel of echoscene_tpu/kernels/chamfer_pallas.py:

  * `nn_distance_oneway` <- `nn_distance_oneway` / `_nn_kernel` (K4):
    out[b, n] = min_m |a[b, n] - b[b, m]|^2, clamped at 0;
  * `chamfer` <- `chamfer_pallas`: mean(a->b) + mean(b->a) per batch entry.

On a CUDA tensor `nn_distance_oneway` launches the hand-written sm_90a kernel
(`csrc/chamfer.cu`; see its header for the design and what bounds it on the
H100) and raises on inputs the kernel does not take.  On a CPU tensor it
computes the plain PyTorch version `nn_distance_plain`, the Gram form of
JAX's kernel (|a|^2 + |b|^2 - 2 a.b, clamped at 0) term by term; on CUDA
nothing reaches it.  Shapes are JAX's: a (B, N, 3), b (B, M, 3) -> (B, N).

`LAUNCHES` counts kernel launches; a run resets it to read which kernels its
main path went through.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import build

SOURCE = "chamfer.cu"
LAUNCHES: Dict[str, int] = {"nn_distance": 0}
# per-point limit, relative to the inputs' squared extent: f32 rounding of a
# squared distance is ~1e-7 of the squared coordinates; leaving out targets
# moves neighbour distances by their squared spacing, orders above it
MAX_ERR_SCALE = 1e-6
# relative limit on each batch entry's mean distance (half a chamfer value)
MEAN_REL_ERR = 1e-5


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nn_distance_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, N): the Gram form of JAX's `_nn_kernel`
    and of `chamfer_parts` (pointcloud_metrics.py:31-41), in a's dtype."""
    xx = (a * a).sum(-1)
    yy = (b * b).sum(-1)
    zz = torch.einsum("bnd,bmd->bnm", a, b)
    p = xx[:, :, None] + yy[:, None, :] - 2.0 * zz
    return p.clamp_min(0.0).amin(dim=2)


def error_ratios(out: torch.Tensor, ref: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor):
    """The tolerance the kernel's f32 output is held to against a float64
    `nn_distance_plain` on the same inputs, as (max abs err /
    (MAX_ERR_SCALE * (max|a|^2 + max|b|^2)), max over the batch of the
    relative error of the mean distance / MEAN_REL_ERR); both <= 1 passes.
    A result that leaves out 64 of the targets is off by many times both
    (chip_smoke.py checks that)."""
    d = (out.double() - ref.double()).abs()
    scale = ((a.double() ** 2).sum(-1).max() + (b.double() ** 2).sum(-1).max())
    mo, mr = out.double().mean(1), ref.double().mean(1)
    rel = ((mo - mr).abs() / mr.abs().clamp_min(1e-300)).max()
    return (d.max().item() / (MAX_ERR_SCALE * scale.item()),
            rel.item() / MEAN_REL_ERR)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, x in (("a", a), ("b", b)):
        if not x.is_cuda:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if (x.dim() != 3 or x.shape[-1] != 3 or not x.is_contiguous()
                or x.data_ptr() % 4):
            raise ValueError(f"{name} must be a contiguous, 4-byte aligned "
                             f"(B, n, 3) tensor, got shape {tuple(x.shape)}")
    if a.device != b.device or a.shape[0] != b.shape[0]:
        raise ValueError(f"batch mismatch a {tuple(a.shape)} on {a.device}, "
                         f"b {tuple(b.shape)} on {b.device}")
    if b.shape[1] == 0:
        raise ValueError("no target points (M = 0)")
    if a.shape[0] > 65535 or max(a.shape[1], b.shape[1]) >= 2 ** 31 // 3:
        raise ValueError(f"sizes beyond the kernel's grid: a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}")


def nn_distance_oneway(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4 (replaces `_nn_kernel`): a (B, N, 3), b (B, M, 3) -> (B, N)
    squared distance from each a point to its nearest b point.  CUDA: the
    sm_90a kernel; CPU: `nn_distance_plain`."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return nn_distance_plain(a, b)
    _check(a, b)
    out = torch.empty(a.shape[:2], dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    fn = build.load(SOURCE).echoscene_nn_distance
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
                 a.shape[1], b.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"nn_distance kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["nn_distance"] += 1
    return out


def chamfer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) chamfer: mean squared NN distance both ways
    (`chamfer_pallas`, compute_mmd_cov_1nn.py:88); two K4 launches on CUDA."""
    return (nn_distance_oneway(a, b).mean(dim=1)
            + nn_distance_oneway(b, a).mean(dim=1))
