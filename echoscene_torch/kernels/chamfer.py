"""One-way squared nearest-neighbour distance and chamfer: CUDA kernel + plain.

Replaces the Pallas TPU kernel of echoscene_tpu/kernels/chamfer_pallas.py:

  * `nn_distance_oneway` <- `nn_distance_oneway` / `_nn_kernel` (K4):
    out[b, n] = min_m |a[b, n] - b[b, m]|^2, clamped at 0;
  * `chamfer` <- `chamfer_pallas`: mean(a->b) + mean(b->a) per batch entry.

On a CUDA tensor `nn_distance_oneway` launches the hand-written sm_90a kernel
(`csrc/chamfer.cu`: the Gram form in f64 on the tensor cores; see its header
for the design and what bounds it on the H100) with the grid of
`launch_plan`, and raises on inputs the kernel does not take.  On a CPU
tensor it computes the plain PyTorch version `nn_distance_plain`, the Gram
form of JAX's kernel (|a|^2 + |b|^2 - 2 a.b, clamped at 0) term by term; on
CUDA nothing reaches it.  Shapes are JAX's: a (B, N, 3), b (B, M, 3) ->
(B, N).

`LAUNCHES` counts kernel launches and `LAUNCH_SHAPES` the same launches by
(B, N, M); a run resets both to read which kernels its main path went
through, at which shapes.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from . import build

SOURCE = "chamfer.cu"
LAUNCHES: Dict[str, int] = {"nn_distance": 0}
# the same launches by (B, N, M)
LAUNCH_SHAPES: Dict[Tuple[int, int, int], int] = {}
# per-point limit, relative to the inputs' squared extent: f32 rounding of a
# squared distance is ~1e-7 of the squared coordinates; leaving out targets
# moves neighbour distances by their squared spacing, orders above it
MAX_ERR_SCALE = 1e-6
# relative limit on each batch entry's mean distance (half a chamfer value)
MEAN_REL_ERR = 1e-5
# `ulp_distance` counts ulps no finer than this fraction of the squared
# extent of the clouds around b's centroid: 128 units of 2^-53, above the
# f64 Gram form's rounding (a few units) with room for the kernel's centre
ULP_FLOOR_SCALE = 2.0 ** -46

# the kernel's launch geometry (csrc/chamfer.cu): queries per query tile and
# targets per unit of work; the CTAs that fit on an SM are asked of the
# kernel at its first launch
BLOCK_N = 512
CHUNK_UNIT = 64

# H100 SXM peaks (NVIDIA's data sheet) behind `nn_distance_bound`
PEAK_F64_TENSOR_FLOPS = 67e12   # f64 tensor cores (= f32 on the CUDA cores)
PEAK_BYTES = 3.35e12            # HBM3


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        LAUNCH_SHAPES.clear()


def nn_distance_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, N): the Gram form of JAX's `_nn_kernel`
    and of `chamfer_parts` (pointcloud_metrics.py:31-41), in a's dtype."""
    xx = (a * a).sum(-1)
    yy = (b * b).sum(-1)
    zz = torch.einsum("bnd,bmd->bnm", a, b)
    p = xx[:, :, None] + yy[:, None, :] - 2.0 * zz
    return p.clamp_min(0.0).amin(dim=2)


def nn_distance_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`nn_distance_plain` in float64 on both clouds moved to b's centroid
    (distances do not change): the reference of `ulp_distance`, whose own
    rounding is a few units of 2^-53 of the clouds' squared extent, not of
    their squared distance from the origin."""
    a, b = a.double(), b.double()
    c = b.mean(1, keepdim=True)
    return nn_distance_plain(a - c, b - c)


def ulp_floor(a: torch.Tensor, b: torch.Tensor) -> float:
    """The finest unit `ulp_distance` counts in, for clouds a and b:
    ULP_FLOOR_SCALE (max|a - c|^2 + max|b - c|^2), c b's centroid per batch
    entry.  Below it a squared distance is under the f64 Gram form's own
    rounding."""
    a, b = a.double(), b.double()
    c = b.mean(1, keepdim=True)
    return ULP_FLOOR_SCALE * (((a - c) ** 2).sum(-1).max().item()
                              + ((b - c) ** 2).sum(-1).max().item())


def ulp_distance(out: torch.Tensor, ref: torch.Tensor,
                 floor: float = 0.0) -> float:
    """Largest distance of `out` from `ref` rounded to f32, in ulps of the
    rounded `ref` (each ulp counted no finer than `floor`): 0 where they
    agree, 1 where they are neighbouring f32 values.  The kernel is held to
    <= 1 against `nn_distance_f64` with the floor of `ulp_floor`."""
    r = ref.float()
    ulp = (torch.nextafter(r, torch.full_like(r, float("inf"))) - r).double()
    d = (out.double() - r.double()).abs()
    return (d / ulp.clamp_min(floor)).max().item()


class LaunchPlan(NamedTuple):
    query_tiles: int     # query tiles of block_n queries per batch entry
    units_row: int       # chunk units of targets in a row (entry, query tile)
    ctas: int            # the grid: CTAs, each over an equal share of units
    atomic: bool         # a row is shared: fill with +inf, then atomicMin


@functools.lru_cache(maxsize=256)
def launch_plan(b: int, n: int, m: int, sms: int, ctas_per_sm: int,
                block_n: int = BLOCK_N) -> LaunchPlan:
    """The kernel's grid for a (b, n, 3) -> (b, m, 3) call on a card with
    `sms` SMs, `ctas_per_sm` CTAs of which fit on an SM at once.  The work
    is b * ceil(n / block_n) rows (a batch entry's query tile) of
    ceil(m / CHUNK_UNIT) units of targets each; one wave of CTAs takes equal
    shares of it, so the card fills at any batch (one consistency pair,
    B = 1) and no CTA waits on a last partial wave."""
    query_tiles = -(-n // block_n)
    units = -(-m // CHUNK_UNIT)
    total = query_tiles * b * units
    ctas = min(total, ctas_per_sm * sms)
    # atomic unless every share starts at a row's start
    atomic = any(c * total // ctas % units for c in range(1, ctas))
    return LaunchPlan(query_tiles, units, ctas, atomic)


def nn_distance_bound(b: int, n: int, m: int) -> Dict:
    """The least time one H100 could take for the one-way distance of
    (b, n, 3) queries to (b, m, 3) targets: the larger of 8 flops a pair on
    the f64 tensor cores (|b|^2 - 2 a.b as a depth-4 product) and the bytes
    (a and b read once, the (b, n) distances written once)."""
    flops = 8 * b * n * m
    nbytes = (3 * b * n + 3 * b * m + b * n) * 4
    times = {"operations": flops / PEAK_F64_TENSOR_FLOPS * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(times, key=times.get)
    return {"ms": times[by], "bound_by": by, "flops": flops, "bytes": nbytes,
            "tensor_core_ms": times["operations"], "bytes_ms": times["bytes"]}


def surface_clouds(b: int, n: int, gen: torch.Generator, device="cuda",
                   centre: float = 0.0) -> torch.Tensor:
    """(b, n, 3) f32 points on one sphere per batch entry (radius 0.3-0.5,
    centre within 0.1 of (centre, centre, centre)): surface-like clouds
    whose neighbour distances are small, as in sampled meshes."""
    radius = 0.3 + 0.2 * torch.rand((b, 1, 1), generator=gen, device=device)
    mid = 0.2 * torch.rand((b, 1, 3), generator=gen, device=device) - 0.1
    dirs = torch.randn((b, n, 3), generator=gen, device=device)
    return (centre + mid + radius * dirs / dirs.norm(dim=-1, keepdim=True)
            ).float()


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


_lib = {}
# guards _lib and the launch counts against launches from several threads
_lock = threading.Lock()


def _kernel():
    """The library's C function, its ctypes signature bound once, and the
    CTAs of the kernel that fit on one SM."""
    with _lock:
        if not _lib:
            lib = build.load(SOURCE)
            if (lib.echoscene_nn_distance_block_n() != BLOCK_N
                    or lib.echoscene_nn_distance_chunk_unit() != CHUNK_UNIT):
                raise RuntimeError("csrc/chamfer.cu's tile sizes differ from "
                                   "BLOCK_N / CHUNK_UNIT")
            fn = lib.echoscene_nn_distance
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib["fn"] = fn
            _lib["ctas_per_sm"] = lib.echoscene_nn_distance_ctas_per_sm()
            if _lib["ctas_per_sm"] < 1:
                raise RuntimeError(
                    "the nn_distance kernel fits no CTA on an SM")
        return _lib["fn"], _lib["ctas_per_sm"]


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    B, N, M = a.shape[0], a.shape[1], b.shape[1]
    fn, ctas_per_sm = _kernel()
    plan = launch_plan(B, N, M, _sms(a.device), ctas_per_sm)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, M,
                 plan.query_tiles, plan.units_row, plan.ctas,
                 int(plan.atomic), stream)
    if err != 0:
        raise RuntimeError(f"nn_distance kernel launch failed: CUDA error "
                           f"{err}")
    _count(B, N, M)
    return out


def _count(B: int, N: int, M: int) -> None:
    """One launch at (B, N, M), counted under the lock."""
    with _lock:
        LAUNCHES["nn_distance"] += 1
        LAUNCH_SHAPES[(B, N, M)] = LAUNCH_SHAPES.get((B, N, M), 0) + 1


def chamfer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) chamfer: mean squared NN distance both ways
    (`chamfer_pallas`, compute_mmd_cov_1nn.py:88); two K4 launches on CUDA."""
    return (nn_distance_oneway(a, b).mean(dim=1)
            + nn_distance_oneway(b, a).mean(dim=1))
