#!/usr/bin/env python3
"""Smoke run of the PyTorch port (echoscene_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):
  1. build the CUDA kernels from the sources in the checkout, one nvcc per
     source, all started together, and print each one's build seconds and
     `-Xptxas -v` report;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it, plus small ragged cases, and time the
     kernel, the plain version and a yardstick PyTorch call the port never
     makes:
     * K1 / K2 (attention): bf16 inputs against the f32-accumulated plain
       version, max abs error <= 2^-6 of the plain output's peak and mean
       abs error <= 1e-2 of its mean magnitude (`flash_attention.
       error_ratios`), a tolerance that must reject the plain version with
       its last 32 keys left out; yardstick scaled_dot_product_attention;
       the bound is `flash_attention.attention_bound` (tensor cores, exp2
       on the SFU at the card's max SM clock, bytes); printed beside it:
       TFLOP/s, share of the bound, the ratio to the yardstick, the time of
       the earlier mma.sync design (`csrc/flash_attention_mma.cu`, run here
       on the same inputs and held to the same tolerance) and the host time
       of one wrapper call;
     * K4 (nearest-neighbour distance) at the path's shapes (16, 8 and 1
       clouds of 5000 points against 5000) and a ragged one: surface-like
       f32 clouds (points on spheres of radius 0.3-0.5) against the plain
       version in float64, max abs error <= 1e-6 (max|a|^2 + max|b|^2) per
       point and each mean distance and chamfer value within 1e-5 relative
       (`chamfer.error_ratios`), a tolerance that must reject the plain
       version with its last 64 targets left out; and within 1 ulp of the
       float64 reference rounded to f32 (`chamfer.ulp_distance`, ulps
       counted no finer than `chamfer.ulp_floor`); yardstick cdist(a, b)^2
       min; the bound is `chamfer.nn_distance_bound`; printed beside it:
       share of the bound, the earlier direct-form design
       (`csrc/chamfer_direct.cu`, same inputs, same tolerance) and the host
       time of one wrapper call;
     * K1 / K2 on f32 inputs (f32 sampling and training), the f32 FMA
       kernel (`csrc/flash_attention_f32.cu`) at the same shapes: against
       the plain version in f32, max abs error <= 2^-14 of the plain
       output's peak and mean abs error <= 1e-5 of its mean magnitude, a
       tolerance that must reject the plain version with its last 32 keys
       left out; times beside the f32 bound (f32 FMAs at 67 TFLOP/s, exp2,
       4-byte elements), SDPA in f32 with TF32 off, the plain version and
       the host time of one wrapper call;
     * K1 / K2 at the training step's shapes ((8, 1024, 8, 56), the VQ
       encoder's (8, 4096, 1, 256)) through the differentiable Function:
       the output carries its grad_fn, the forward meets `error_ratios`,
       and dq, dk, dv equal plain autograd's within 1e-6 of their peak
       (bit-equal expected: the backward is the same plain computation);
       times the kernel forward + plain backward beside the plain forward +
       backward and SDPA's forward + backward;
  3. check the port on the card against the port on the CPU: the tiny
     test configuration in f32 (same weights, same injected noise; max abs
     error <= 1e-4 on boxes and SDFs), one tiny-config f32 training step
     (same weights and draws; loss within 1e-5 relative, each gradient leaf
     within 1e-3 of its part's gradient peak + 1e-7, then two AdamW steps
     on each from the CPU's gradients, parameters within 1e-6), and MMD /
     COV / 1-NN over 6 clouds of 256 points (CD values within 1e-5
     relative, auction-EMD values within 1e-4);
  4. drive the main path once: full-width flagship generation (1000-step
     layout DDPM + 100-step shape DDIM + chunked VQ decode) on the seeded
     8-scene synthetic batch, with every kernel launch count set to 0 just
     before and read just after; checks finite outputs of the JAX output
     shapes and the launch counts (K1 = 5 per DDIM step, K2 = one per
     decode chunk);
  5. time each part of that path alone (graph context, one layout step, one
     shape step, one decode chunk): wall clock per call, and the device busy
     share and kernel launches of one call under torch.profiler;
  6. drive the evaluation path: a fake SG-FRONT dataset (test split) ->
     `SceneEvaluator` generating every scene at flagship width with SDF
     dumps -> the consistency CLI on the same-category instances -> MMD /
     COV / 1-NN (auction EMD) of 8 generated clouds against 8 clouds of
     analytic SDFs, on the card; checks that the report parses, that every
     dumped real-row SDF meshes, that every part gives finite values, and
     the launch counts (K1 / K2 of the generation; K4 = 48 at
     (8, 5000, 5000) for the metrics plus 2 at (pairs, 5000, 5000) per
     scene with an annotated pair for the consistency, by shape as the
     wrapper counts them), with every count set to 0 just before and read
     just after; then times the
     MMD step once more with an EMD that returns zeros, which splits the
     step's time between the chamfers (K4) and the auction EMD;
  7. drive the training path on the phase-4 model: bf16, remat on, 8
     scenes, diffusion_bs 8, seeded analytic 64^3 SDFs through the frozen
     encoder; one warm step and 8 timed (train scenes/sec, ms per step,
     peak memory; K1 / K2 counts set to 0 just before and read just after:
     K1 = 10 a step, 5 forward + 5 in the remat recompute, K2 = 1, one
     encoder chunk), finite losses, the parts that get gradients moved, the
     VQ-VAE bit-unchanged; the busy share and kernel launches of one step
     and of its forward, backward and optimizer under torch.profiler; two
     steps through `Trainer.train` over a fake dataset whose SDFs come from
     an in-memory loader (K1 = 20, K2 = 2, finite logged losses); a
     `Trainer.save` -> `restore_checkpoint` round trip into a model with
     other weights, bit-exact, and one step after it with the same loss as
     the saved model's; one step at the yaml's diffusion_bs of 64 (K1 = 10,
     K2 = 8), its peak memory; one step with compute_dtype float32 (K1 =
     10 and K2 = 1 launches, all f32; finite loss, its ms and peak memory);
  8. drive the generation service on the phase-4 model at the fast profile
     (DPM++ with 50 layout and 20 shape steps, bf16; row buckets 16, 32,
     48): warmup; 8 concurrent clients with 16 requests of 3-6 objects
     through the MicroBatcher (10 ms window): latency p50 / p95,
     requests/sec, batches, reserved memory; an addition and a
     relationship change against earlier results (untouched objects'
     boxes and SDFs bit-equal); a mesh request; an HTTP round trip on
     127.0.0.1 and a malformed request (400); an f32 request (K1 / K2 in
     f32); two fresh seed-0 services on one request (boxes bit-equal).
     Checks no variant after warmup, finite outputs, and K1 = 5 x 20 and
     K2 = ceil(rows / 8) per dispatch, with the counts set to 0 just before
     each part and read just after.

Prints the total seconds, the `kernels` JSON line (K1 / K2 in bf16 and in
f32, each entry with its dtype; K1 / K2 also carry their training launches,
serving launches and forward + backward times; the f32 entries' launches
are phase 8's f32 request), the card's name and
power limit (nvidia-smi), and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one card; exits 2 without CUDA or without the repository beside it.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ATOL_TINY = 1e-4
GRAD_RTOL = 1e-6             # kernel Function's dq, dk, dv vs plain autograd
LOSS_RTOL = 1e-5             # tiny training step, card vs CPU
GRAD_LEAF_RTOL = 1e-3        # ... each gradient leaf, of its part's peak
PARAM_ATOL = 1e-6            # ... parameters after AdamW on the same grads
# K1 / K2 in phase 7's training step: the shape UNet's self-attention at
# diffusion_bs 8 rows, the frozen VQ encoder's mid attention on 8 SDFs
TRAIN_K1_SHAPE = (8, 1024, 8, 56)
TRAIN_K2_SHAPE = (8, 4096, 1, 256)
CD_RTOL = 1e-5               # chamfer values, card vs plain / CPU
T_START = 0.0
EMD_RTOL = 1e-4              # auction EMD values, card vs CPU


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    # the card waits on a sleep (~2.5 ms) while the host enqueues the calls,
    # so a call shorter than its host time is timed on the card alone
    torch.cuda._sleep(5_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the earlier (mma.sync, cp.async) design of K1 / K2, timed beside the
# TMA / wgmma kernel in the same run; no path of the port calls it
BASELINE_SOURCE = "flash_attention_mma.cu"
_baseline = []


def mma_baseline(q, k, v):
    """softmax(q k^T D^-1/2) v by the earlier design's kernel."""
    import ctypes
    import torch
    from echoscene_torch.kernels import build
    if not _baseline:
        fn = build.load(BASELINE_SOURCE).echoscene_mma_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _baseline.append(fn)
    b, l, h, d = q.shape
    o = torch.empty_like(q)
    err = _baseline[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       b, h, l, k.shape[1], d, d ** -0.5,
                       torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"the baseline attention kernel failed to launch: CUDA error {err}")
    return o


# the earlier (direct f32 form) design of K4, timed beside the f64
# tensor-core kernel in the same run; no path of the port calls it
K4_DIRECT_SOURCE = "chamfer_direct.cu"
_baseline_k4 = []


def k4_direct(a, b):
    """The one-way squared NN distance by the earlier design's kernel."""
    import ctypes
    import torch
    from echoscene_torch.kernels import build
    if not _baseline_k4:
        fn = build.load(K4_DIRECT_SOURCE).echoscene_nn_distance_direct
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _baseline_k4.append(fn)
    out = torch.empty(a.shape[:2], device=a.device)
    err = _baseline_k4[0](a.data_ptr(), b.data_ptr(), out.data_ptr(),
                          a.shape[0], a.shape[1], b.shape[1],
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"the direct-form K4 kernel failed to launch: CUDA error {err}")
    return out


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def check_kernel(name, wrapper, shape, ragged_shapes, replaces, sm_clock_hz):
    """Phase 2 for one attention kernel; returns its `kernels` entry."""
    import torch
    import torch.nn.functional as F
    from echoscene_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shp in (*ragged_shapes, shape):
        q, k, v = (torch.randn(shp, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        out = wrapper(q, k, v)
        torch.cuda.synchronize()
        ref = fa.attention_plain(q, k, v)
        ratios = fa.error_ratios(out, ref)
        if not max(ratios) <= 1.0:
            fail(f"{name} at {shp}: max / mean abs err at {ratios[0]:.3f} / "
                 f"{ratios[1]:.3f} of their limits")
    err = (out.float() - ref.float()).abs().max().item()
    # each limit alone must fail a kernel that skips a key tile
    dropped = fa.error_ratios(
        fa.attention_plain(q, k[:, :-32], v[:, :-32]), ref)
    if not min(dropped) > 1.0:
        fail(f"{name}: the tolerance passes the plain version with 32 keys "
             f"left out ({dropped[0]:.3f} / {dropped[1]:.3f} of the limits)")
    earlier = fa.error_ratios(mma_baseline(q, k, v), ref)
    if not max(earlier) <= 1.0:
        fail(f"the baseline design at {shape}: max / mean err at "
             f"{earlier[0]:.3f} / {earlier[1]:.3f} of their limits")
    ms = cuda_ms(lambda: wrapper(q, k, v), iters=20)
    earlier_ms = cuda_ms(lambda: mma_baseline(q, k, v), iters=20)
    # host time of one wrapper call: enqueue 20 calls without waiting
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        wrapper(q, k, v)
    host_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v), iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                         iters=20)
    bound = fa.attention_bound(*shape, sm_clock_hz=sm_clock_hz)
    return {"name": name, "route": "cuda", "dtype": "bfloat16",
            "source": "echoscene_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["ms"],
            "bound_by": bound["bound_by"], "library_ms": library_ms,
            "earlier_ms": earlier_ms, "shape": list(shape),
            "bound_detail": {key: bound[key] for key in (
                "by", "tensor_core_ms", "exp2_ms", "bytes_ms")},
            "tflops": bound["flops"] / ms * 1e-9,
            "share_of_bound": bound["ms"] / ms, "vs_library": ms / library_ms,
            "host_us_per_call": host_us, "err_of_limit": ratios,
            "keys_dropped_err_of_limit": dropped}


def check_kernel_f32(name, wrapper, shape, ragged_shapes, replaces,
                     sm_clock_hz):
    """Phase 2 for the f32 kernel of one attention wrapper: f32 inputs
    against `attention_plain` in f32 at the path shape and the ragged ones
    (`error_ratios`' f32 limits: max abs err <= 2^-14 of the plain output's
    peak, mean abs err <= 1e-5 of its mean magnitude, which must reject the
    plain version with its last 32 keys left out); times beside the f32
    bound, SDPA in f32 with TF32 off, the plain version and the host time
    of one wrapper call.  Returns its `kernels` entry."""
    import torch
    import torch.nn.functional as F
    from echoscene_torch.kernels import flash_attention as fa

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the f32 yardsticks would not be f32")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shp in (*ragged_shapes, shape):
        q, k, v = (torch.randn(shp, generator=gen, device="cuda")
                   for _ in range(3))
        fa.reset_launches()
        out = wrapper(q, k, v)
        torch.cuda.synchronize()
        if fa.LAUNCHES_BY_DTYPE != {(name, "float32"): 1}:
            fail(f"{name} on f32 at {shp} launched "
                 f"{fa.LAUNCHES_BY_DTYPE}, want one f32 launch")
        ref = fa.attention_plain(q, k, v)
        ratios = fa.error_ratios(out, ref)
        if not (out.dtype == torch.float32 and max(ratios) <= 1.0):
            fail(f"{name} f32 at {shp}: {out.dtype} output, max / mean abs "
                 f"err at {ratios[0]:.3f} / {ratios[1]:.3f} of their limits")
    err = (out - ref).abs().max().item()
    dropped = fa.error_ratios(
        fa.attention_plain(q, k[:, :-32], v[:, :-32]), ref)
    if not min(dropped) > 1.0:
        fail(f"{name} f32: the tolerance passes the plain version with 32 "
             f"keys left out ({dropped[0]:.3f} / {dropped[1]:.3f})")
    ms = cuda_ms(lambda: wrapper(q, k, v), iters=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        wrapper(q, k, v)
    host_us = (time.perf_counter() - t0) / 10 * 1e6
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v), iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                         iters=10)
    bound = fa.attention_bound(*shape, sm_clock_hz=sm_clock_hz,
                               dtype=torch.float32)
    return {"name": f"{name}_f32", "route": "cuda", "dtype": "float32",
            "source": "echoscene_torch/csrc/flash_attention_f32.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["ms"],
            "bound_by": bound["bound_by"], "library_ms": library_ms,
            "shape": list(shape),
            "bound_detail": {key: bound[key] for key in (
                "by", "fma_ms", "exp2_ms", "bytes_ms")},
            "tflops": bound["flops"] / ms * 1e-9,
            "share_of_bound": bound["ms"] / ms, "vs_library": ms / library_ms,
            "host_us_per_call": host_us, "err_of_limit": ratios,
            "keys_dropped_err_of_limit": dropped}


def check_kernel_backward(name, wrapper, shape):
    """Phase 2, training: the kernel's output carries the differentiable
    Function, and its dq, dk, dv (the plain version recomputed and
    differentiated, as JAX's `_fa_bwd`) equal plain autograd's from the same
    inputs and upstream gradient; times the kernel forward + plain backward
    beside the plain forward + backward and SDPA's forward + backward."""
    import torch
    import torch.nn.functional as F
    from echoscene_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = wrapper(*leaves)
    if type(out.grad_fn).__name__ != "KernelAttentionBackward":
        fail(f"{name} at {shape}: output grad_fn {out.grad_fn}, want the "
             "differentiable kernel Function")
    ratios = fa.error_ratios(out.detach(), fa.attention_plain(q, k, v))
    if not max(ratios) <= 1.0:
        fail(f"{name} at {shape}: max / mean abs err at {ratios[0]:.3f} / "
             f"{ratios[1]:.3f} of their limits")
    got = torch.autograd.grad(out, leaves, g)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(*plain), plain, g)
    diffs = [((a.float() - b.float()).abs().max()
              / b.float().abs().max()).item() for a, b in zip(got, want)]
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    if not max(diffs) <= GRAD_RTOL:
        fail(f"{name} at {shape}: dq, dk, dv differ from plain autograd's by "
             f"{diffs} of their peaks (limit {GRAD_RTOL})")

    def fwd_bwd(fn, xs, gx):
        return lambda: torch.autograd.grad(fn(*xs), xs, gx)

    kernel_ms = cuda_ms(fwd_bwd(wrapper, leaves, g), iters=5)
    plain_ms = cuda_ms(fwd_bwd(fa.attention_plain, plain, g), iters=3,
                       warmup=1)
    tr = [x.detach().transpose(1, 2).contiguous().requires_grad_(True)
          for x in (q, k, v)]
    library_ms = cuda_ms(fwd_bwd(F.scaled_dot_product_attention, tr,
                                 g.transpose(1, 2).contiguous()), iters=5)
    return {"train_shape": list(shape), "grad_bit_equal": equal,
            "grad_max_diff_of_peak": max(diffs),
            "train_err_of_limit": ratios, "fwd_bwd_ms": kernel_ms,
            "plain_fwd_bwd_ms": plain_ms, "library_fwd_bwd_ms": library_ms}


def check_chamfer_kernel(shapes, ragged_shape):
    """Phase 2 for K4 at each path shape and a ragged one; returns its
    `kernels` entry (top level: the first of `shapes`) with every shape's
    numbers under `per_shape`."""
    import torch
    from echoscene_torch.kernels import chamfer as k4

    gen = torch.Generator(device="cuda").manual_seed(0)
    per_shape = []
    for b, n, m in (ragged_shape, *shapes):
        # one sphere per entry for both clouds: draw them together
        both = k4.surface_clouds(b, n + m, gen)
        a, t = both[:, :n].contiguous(), both[:, n:].contiguous()
        out = k4.nn_distance_oneway(a, t)
        torch.cuda.synchronize()
        ref = k4.nn_distance_plain(a.double(), t.double())
        ratios = k4.error_ratios(out, ref, a, t)
        floor = k4.ulp_floor(a, t)
        ulps = k4.ulp_distance(out, k4.nn_distance_f64(a, t), floor)
        cd = k4.chamfer(a, t).double()
        cd_ref = ref.mean(1) + k4.nn_distance_plain(t.double(),
                                                    a.double()).mean(1)
        cd_rel = ((cd - cd_ref).abs() / cd_ref).max().item()
        if not (max(ratios) <= 1.0 and cd_rel <= CD_RTOL and ulps <= 1.0):
            fail(f"nn_distance at {(b, n, m)}: max err / mean err at "
                 f"{ratios[0]:.3f} / {ratios[1]:.3f} of their limits, "
                 f"chamfer rel err {cd_rel:.3e} (limit {CD_RTOL}), {ulps} "
                 f"ulp (limit 1, floor {floor:.3e})")
        earlier = k4.error_ratios(k4_direct(a, t), ref, a, t)
        if not max(earlier) <= 1.0:
            fail(f"the direct-form design at {(b, n, m)}: max / mean err at "
                 f"{earlier[0]:.3f} / {earlier[1]:.3f} of their limits")
        if (b, n, m) == ragged_shape:
            continue
        err = (out.double() - ref).abs().max().item()
        if (b, n, m) == shapes[0]:
            dropped = k4.error_ratios(
                k4.nn_distance_plain(a.double(), t[:, :-64].double()), ref,
                a, t)
            if not min(dropped) > 1.0:
                fail(f"nn_distance: the tolerance passes the plain version "
                     f"with 64 targets left out ({dropped[0]:.3f} / "
                     f"{dropped[1]:.3f})")
        del ref, cd_ref
        ms = cuda_ms(lambda: k4.nn_distance_oneway(a, t), iters=30)
        earlier_ms = cuda_ms(lambda: k4_direct(a, t), iters=30)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            k4.nn_distance_oneway(a, t)
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        plain_ms = cuda_ms(lambda: k4.nn_distance_plain(a, t), iters=3,
                           warmup=1)
        library_ms = cuda_ms(lambda: torch.cdist(a, t).square().amin(2),
                             iters=5)
        bound = k4.nn_distance_bound(b, n, m)
        per_shape.append({
            "shape": [b, n, m], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound["ms"],
            "bound_by": bound["bound_by"], "library_ms": library_ms,
            "earlier_ms": earlier_ms, "share_of_bound": bound["ms"] / ms,
            "pair_tflops": bound["flops"] / ms * 1e-9,
            "host_us_per_call": host_us, "err_of_limit": ratios,
            "ulp": ulps, "ulp_floor": floor, "chamfer_rel_err": cd_rel,
            "earlier_err_of_limit": earlier})
        torch.cuda.empty_cache()
    top = per_shape[0]
    entry = {"name": "nn_distance", "route": "cuda", "dtype": "float32",
             "source": "echoscene_torch/csrc/chamfer.cu",
             "replaces": "echoscene_tpu/kernels/chamfer_pallas.py:27",
             "launches": None}
    entry.update({key: top[key] for key in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "earlier_ms", "shape", "share_of_bound",
        "host_us_per_call", "err_of_limit", "ulp", "chamfer_rel_err")})
    entry["targets_dropped_err_of_limit"] = dropped
    entry["per_shape"] = per_shape
    return entry


def check_metrics_against_cpu() -> dict:
    """Phase 3: MMD / COV / 1-NN on the card vs on the CPU, 6 + 6 clouds of
    256 points, chamfer via K4 vs the Gram form, auction EMD on each."""
    import torch
    from echoscene_torch.eval.pointcloud_metrics import (compute_all_metrics,
                                                         emd_auction)
    from echoscene_torch.kernels import chamfer as k4

    gen = torch.Generator().manual_seed(3)
    sample = k4.surface_clouds(6, 256, gen, device="cpu").numpy()
    ref = k4.surface_clouds(6, 256, gen, device="cpu").numpy()
    res = {d: compute_all_metrics(sample, ref, batch_size=4,
                                  emd_fn=emd_auction, device=d)
           for d in ("cpu", "cuda")}
    if res["cpu"].keys() != res["cuda"].keys():
        fail("metric keys differ between CPU and CUDA")
    worst = {}
    for k, want in res["cpu"].items():
        got = res["cuda"][k]
        rtol = EMD_RTOL if k.endswith("EMD") or "-EMD-" in k else CD_RTOL
        rel = abs(got - want) / max(abs(want), 1e-12)
        worst[k] = rel
        if not (math.isfinite(got) and rel <= rtol):
            fail(f"metric {k}: CUDA {got} vs CPU {want} (rel {rel:.3e}, "
                 f"limit {rtol})")
    return worst


def eval_path(sg, card: str) -> dict:
    """Phase 6: the evaluation path at flagship width; returns the K4 launch
    count of its metric steps and the wall seconds of each part."""
    import numpy as np
    import torch
    from echoscene_torch import native
    from echoscene_torch.benchmarks import NUM_OBJS, NUM_PREDS, analytic_sdf
    from echoscene_torch.data.clip_text import ClipTextEncoder
    from echoscene_torch.data.collate import CollateSpec, collate_scenes
    from echoscene_torch.data.fake import make_fake_dataset
    from echoscene_torch.data.sgfront import SGFrontDataset
    from echoscene_torch.eval import consistency_cli
    from echoscene_torch.eval.evaluator import SceneEvaluator
    from echoscene_torch.eval.pointcloud_metrics import (compute_all_metrics,
                                                         emd_auction)
    from echoscene_torch.kernels import chamfer as k4
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.models.sgdiff import shape_row_capacity

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        root = make_fake_dataset(os.path.join(tmp, "data"), num_scenes=8,
                                 min_objs=3, max_objs=6, with_sdf=False,
                                 seed=0)
        ds = SGFrontDataset(root, split="test", shuffle_objs=False,
                            use_sdf=False, with_changes=False,
                            clip=ClipTextEncoder("hash"), seed=47)
        if (len(ds.classes), len(ds.pred_names)) != (NUM_OBJS, NUM_PREDS):
            fail("the fake vocabulary does not match the flagship model's")
        spec = CollateSpec(max_nodes=48, max_triples=160, max_scenes=8,
                           diffusion_bs=48, with_sdf=False)
        examples = [ds[i] for i in range(len(ds))]
        if (sum(e.num_nodes for e in examples) > spec.max_nodes
                or sum(len(e.triples) for e in examples) > spec.max_triples):
            fail("the eval scenes do not fit one generation group")
        rows = shape_row_capacity(collate_scenes(examples, spec))
        store = os.path.join(tmp, "eval")
        ev = SceneEvaluator(sg, spec, ds.box_stats, gen_shape=True,
                            store_path=store, dump_sdfs=True, eval_batch=8)

        # generation, scoring and the SDF dumps
        fa.reset_launches()
        k4.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev.run(ds, "none", 0, torch.Generator(device="cuda").manual_seed(47))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        want = {"onepass_attention": 5 * sg.ddim_tables.num_steps,
                "stream_attention": math.ceil(rows / 8)}
        if dict(fa.LAUNCHES) != want or k4.LAUNCHES["nn_distance"] != 0:
            fail(f"eval generation launched {dict(fa.LAUNCHES)} and "
                 f"{dict(k4.LAUNCHES)}, want {want} and no nn_distance")
        with open(os.path.join(store, "none_accuracy_analysis.txt")) as f:
            report = f.read()
        total = re.search(r"^acc & L/R: \S+ & F/B: \S+ & Bi/Sm: \S+ & "
                          r"Ta/Sh: \S+ & Stand: \S+ & Close: \S+ & Symm: "
                          r"\S+\. Total: &(\S+)\nmeans of mean: (\S+)",
                          report, re.M)
        if total is None or not math.isfinite(float(total.group(1))):
            fail(f"accuracy report does not parse or has no total:\n{report}")
        dumps, n_rows, n_tris = {}, 0, 0
        for ex in examples:
            with np.load(os.path.join(store, f"{ex.scan_id}.npz")) as d:
                dumps[ex.scan_id] = {k: d[k] for k in d.files}
            sdfs = dumps[ex.scan_id]["sdfs"]
            if sdfs.shape != (ex.num_nodes, 64, 64, 64):
                fail(f"{ex.scan_id}: dumped SDFs of shape {sdfs.shape}")
            for grid in sdfs:
                tris = len(native.marching_cubes(grid)[1])
                if not (np.isfinite(grid).all() and tris > 0):
                    fail(f"{ex.scan_id}: a dumped SDF is not finite or gives "
                         f"no triangles ({tris})")
                n_rows += 1
                n_tris += tris
        print(f"eval generation: {len(examples)} scenes, {rows} rows, "
              f"{gen_s:.3f} s wall; accuracy total {total.group(1)}, means "
              f"of mean {total.group(2)}; {n_rows} dumped SDFs, "
              f"{n_tris / n_rows:.0f} triangles each on average [{card}]")

        # SDF -> 5000-point clouds: 8 generated, 8 of analytic SDFs
        t0 = time.perf_counter()
        grids = np.concatenate([dumps[e.scan_id]["sdfs"] for e in examples])
        gen_pcs = np.stack([native.sdf_to_point_cloud(g, 5000)
                            for g in grids[:8]])
        rng = np.random.default_rng(0)
        ref_pcs = np.stack([native.sdf_to_point_cloud(
            analytic_sdf(i % 3, 64, rng), 5000) for i in range(8)])
        cloud_s = time.perf_counter() - t0
        if not (np.isfinite(gen_pcs).all() and np.isfinite(ref_pcs).all()):
            fail("point clouds are not finite")

        # consistency over same-category instances, then MMD / COV / 1-NN
        anns, pairs, want_cons = {}, 0, {}
        for ex in examples:
            by_cat = {}
            d = dumps[ex.scan_id]
            for iid, cat in zip(d["instance_ids"], d["categories"]):
                if iid >= 0:
                    by_cat.setdefault(str(cat), []).append(int(iid))
            groups = [g for g in by_cat.values() if len(g) > 1]
            if groups:
                anns[ex.scan_id] = groups
                scene = sum(len(g) * (len(g) - 1) // 2 for g in groups)
                pairs += scene
                # one chamfer (two K4 launches) over the scene's pairs
                key = (scene, 5000, 5000)
                want_cons[key] = want_cons.get(key, 0) + 2
        if not anns:
            fail("no scene has two instances of one category")
        ann_path = os.path.join(tmp, "consistencies.json")
        with open(ann_path, "w") as f:
            json.dump(anns, f)
        k4.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agg = consistency_cli.main(["--annotations", ann_path,
                                    "--generated_dir", store])
        torch.cuda.synchronize()
        cons_s = time.perf_counter() - t0
        if not all(math.isfinite(v) for v in agg.values()):
            fail(f"consistency is not finite: {agg}")
        cons_launches = k4.LAUNCHES["nn_distance"]
        cons_shapes = dict(k4.LAUNCH_SHAPES)
        t0 = time.perf_counter()
        mmd = compute_all_metrics(gen_pcs, ref_pcs, batch_size=16,
                                  emd_fn=emd_auction)
        torch.cuda.synchronize()
        mmd_s = time.perf_counter() - t0
        launches = k4.LAUNCHES["nn_distance"]
        shapes = dict(k4.LAUNCH_SHAPES)
        if not all(math.isfinite(v) for v in mmd.values()):
            fail(f"MMD / COV / 1-NN is not finite: {mmd}")
        # three 8 x 8 CD matrices, one chamfer of 8 reference clouds per
        # row: 48 launches at (8, 5000, 5000)
        mmd_shapes = {k: c - cons_shapes.get(k, 0) for k, c in shapes.items()
                      if c != cons_shapes.get(k, 0)}
        if (cons_launches, launches - cons_launches) != (2 * len(anns), 48):
            fail(f"nn_distance launched {cons_launches} times in the "
                 f"consistency step and {launches - cons_launches} in the "
                 f"MMD step, want {2 * len(anns)} and 48")
        if cons_shapes != want_cons or mmd_shapes != {(8, 5000, 5000): 48}:
            fail(f"nn_distance launched at {cons_shapes} in the consistency "
                 f"step and {mmd_shapes} in the MMD step, want {want_cons} "
                 f"and 48 at (8, 5000, 5000)")
        # the MMD step again with an EMD of zeros: its chamfer time alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compute_all_metrics(gen_pcs, ref_pcs, batch_size=16,
                            emd_fn=lambda x, y: np.zeros(len(x)))
        torch.cuda.synchronize()
        mmd_cd_s = time.perf_counter() - t0
    print(f"eval SDF -> clouds: 16 clouds of 5000 points, {cloud_s:.3f} s "
          f"wall; native library: {native.available()} [{card}]")
    print(f"eval consistency: {pairs} pairs in {len(anns)} scenes, total "
          f"{agg['total']:.6g}, {cons_s:.3f} s wall [{card}]")
    print(f"eval MMD / COV / 1-NN: 8 vs 8 clouds, {json.dumps(mmd)}, "
          f"{mmd_s:.3f} s wall, of which chamfers (the step with an EMD of "
          f"zeros) {mmd_cd_s:.3f} s and auction EMD the other "
          f"{mmd_s - mmd_cd_s:.3f} s [{card}]")
    shapes = {str(list(k)): c for k, c in sorted(shapes.items())}
    print(f"eval nn_distance launches by shape (counted by the wrapper): "
          f"{json.dumps(shapes)}")
    return {"nn_distance_launches": launches, "generation_s": gen_s,
            "clouds_s": cloud_s, "consistency_s": cons_s, "mmd_s": mmd_s,
            "mmd_chamfer_s": mmd_cd_s, "nn_distance_launches_by_shape": shapes}


def check_tiny_against_cpu() -> float:
    """Phase 3: the port on CUDA vs on CPU, tiny config, f32."""
    import torch
    from echoscene_torch.benchmarks import seeded_weights_, synthetic_batch
    from echoscene_torch.models.config import tiny_config
    from echoscene_torch.models.sgdiff import SGDiff, shape_row_capacity

    cfg = tiny_config()
    cfg.sample_dtype = "float32"
    batch = synthetic_batch(3, cfg.max_nodes, cfg.max_triples, seed=1)
    rows = shape_row_capacity(batch, multiple=1)
    n = batch.num_nodes
    sd = cfg.shape_branch.denoiser
    g = torch.Generator().manual_seed(2)
    noise = {"box_x_T": torch.randn((n, 8), generator=g),
             "box_steps": torch.randn((cfg.layout_diffusion.time_num, n, 8),
                                      generator=g),
             "shape_x_T": torch.randn((1, sd.image_size, sd.image_size,
                                       sd.image_size,
                                       cfg.shape_branch.vqvae.embed_dim),
                                      generator=g)}
    outs = []
    for device in ("cpu", "cuda"):
        torch.manual_seed(0)
        sg = SGDiff(cfg, 9, 16, device=device)
        seeded_weights_(sg.module.cpu(), 0)
        sg.module.to(device)
        out = sg.sample_fn(batch.to(device), shape_rows=rows,
                           noise={k: v.to(device) for k, v in noise.items()})
        outs.append({k: v.float().cpu() for k, v in out.items()})
    err = max((outs[0][k] - outs[1][k]).abs().max().item()
              for k in ("sizes", "translations", "angles", "shapes"))
    if not err <= ATOL_TINY:
        fail(f"tiny config CUDA vs CPU max abs err {err} > {ATOL_TINY}")
    return err


def check_tiny_train_against_cpu() -> dict:
    """Phase 3, training: one tiny-config f32 training step on the card and
    on the CPU from the same weights and draws (loss within LOSS_RTOL, each
    gradient leaf within GRAD_LEAF_RTOL of its part's peak + 1e-7); then
    AdamW on each
    from the CPU's own gradients (parameters within PARAM_ATOL).  The tiny
    config reaches no kernel, so f32 runs on the card here."""
    import torch
    from echoscene_torch.benchmarks import seeded_weights_, synthetic_batch
    from echoscene_torch.models.config import tiny_config
    from echoscene_torch.models.sgdiff import SGDiff, trainable_parameters

    cfg = tiny_config()
    # the flagship's layout width, 16 channels per GroupNorm group: at the
    # tiny 16 channels each group of the one-token layout UNet holds one
    # value and passes only rounding noise back
    cfg.layout_denoiser.model_channels = 512
    batch = synthetic_batch(3, cfg.max_nodes, cfg.max_triples, seed=1,
                            diffusion_bs=cfg.diffusion_bs,
                            sdf_res=cfg.shape_branch.vqvae.resolution)
    sd, n, m = cfg.shape_branch.denoiser, batch.num_nodes, cfg.diffusion_bs
    g = torch.Generator().manual_seed(4)
    draws = {"change": torch.randn((n, cfg.embedding_dim), generator=g),
             "t_scene": torch.randint(0, cfg.layout_diffusion.time_num,
                                      (batch.num_scenes + 1,), generator=g),
             "noise_box": torch.randn((n, 8), generator=g),
             "t_shape": torch.randint(0, sd.timesteps, (m,), generator=g),
             "noise_shape": torch.randn(
                 (m, sd.image_size, sd.image_size, sd.image_size,
                  cfg.shape_branch.vqvae.embed_dim), generator=g)}
    runs = []
    for device in ("cpu", "cuda"):
        torch.manual_seed(0)
        sg = SGDiff(cfg, 9, 16, device=device)
        seeded_weights_(sg.module.cpu(), 0)
        sg.module.to(device)
        loss, _ = sg.loss_fn(batch.to(device), draws={
            k: v.to(device) for k, v in draws.items()})
        loss.backward()
        params = trainable_parameters(sg.module)
        names = [n for n, _ in params]
        grads = [p.grad.detach().cpu() if p.grad is not None
                 else torch.zeros(p.shape) for _, p in params]
        runs.append((sg, loss.item(), grads))
    (cpu, loss_c, grads_c), (card, loss_g, grads_g) = runs
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    # each leaf within GRAD_LEAF_RTOL of the gradient peak of its part
    # (layout_denoiser, shape_denoiser, ...) + 1e-7: a leaf whose gradient
    # nearly cancels (a bias before a norm, ~1e-5) carries the f32 rounding
    # of its part, up to 2e-3 of its own tiny peak on the card (card and CPU
    # sum in other orders, and batch norms over a dozen rows amplify that
    # rounding; the GCN pooling is a one-hot product, the same on every
    # card run)
    part = lambda n: n.split(".")[0]
    peak = {}
    for n, b in zip(names, grads_c):
        peak[part(n)] = max(peak.get(part(n), 0.0), b.abs().max().item())
    errs = [(a - b).abs().max().item() for a, b in zip(grads_g, grads_c)]
    of_part = max(e / peak[part(n)] for n, e in zip(names, errs)
                  if peak[part(n)] > 0)
    bad = [n for n, e in zip(names, errs)
           if not e <= GRAD_LEAF_RTOL * peak[part(n)] + 1e-7]
    leaf = max(e / b.abs().max().item() for e, b in zip(errs, grads_c)
               if b.abs().max() > 1e-6)
    if not (loss_rel <= LOSS_RTOL and not bad):
        fail(f"tiny training step, CUDA vs CPU: loss rel err {loss_rel:.3e} "
             f"(limit {LOSS_RTOL}); gradient leaves off by more than "
             f"{GRAD_LEAF_RTOL} of their part's peak + 1e-7: {bad[:8]} "
             f"(largest error {of_part:.3e} of a part's peak)")
    for sg in (cpu, card):
        state = sg.init_train_state()
        for _ in range(2):
            sg.apply_gradients(state, [x.clone().to(sg.device)
                                       for x in grads_c])
    param_err = max((a.detach().cpu() - b.detach()).abs().max().item()
                    for (_, a), (_, b) in zip(card.module.named_parameters(),
                                              cpu.module.named_parameters()))
    if not param_err <= PARAM_ATOL:
        fail(f"AdamW on the CPU's gradients: parameters differ by "
             f"{param_err:.3e} between CUDA and CPU (limit {PARAM_ATOL})")
    return {"loss_rel_err": loss_rel, "grad_err_of_part_peak": of_part,
            "grad_err_of_own_peak": leaf,
            "param_abs_err_after_2_steps": param_err}


def trainer_steps(sg, state, card: str, steps: int = 2) -> dict:
    """Phase 7, the user's entry point: `Trainer.train` takes `steps` steps
    at full width over a fake SG-FRONT training split (8 scenes a batch,
    the node capacity train.cli gives them, diffusion_bs 8), its SDFs fed
    by an in-memory loader of seeded analytic 64^3 grids (the card's
    machine has no h5py); K1 / K2 counts set to 0 just before and read just
    after; every logged loss finite."""
    import zlib

    import numpy as np
    import torch
    from echoscene_torch.benchmarks import NUM_OBJS, NUM_PREDS, analytic_sdf
    from echoscene_torch.data.clip_text import ClipTextEncoder
    from echoscene_torch.data.collate import CollateSpec
    from echoscene_torch.data.fake import make_fake_dataset
    from echoscene_torch.data.sgfront import SGFrontDataset
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.train.trainer import Trainer

    def in_memory_sdf(path):
        """A seeded analytic grid per model path, clamped as the reader's."""
        if path is None:
            return np.zeros((64, 64, 64, 1), np.float32)
        rng = np.random.default_rng(zlib.crc32(path.encode()))
        grid = analytic_sdf(int(rng.integers(3)), 64, rng)
        return np.clip(grid, -0.2, 0.2)[..., None].astype(np.float32)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        root = make_fake_dataset(os.path.join(tmp, "data"), num_scenes=16,
                                 min_objs=3, max_objs=5, with_sdf=False,
                                 seed=1)
        ds = SGFrontDataset(root, use_sdf=True, with_changes=True,
                            clip=ClipTextEncoder("hash"), seed=3)
        if (len(ds.classes), len(ds.pred_names)) != (NUM_OBJS, NUM_PREDS):
            fail("the fake vocabulary does not match the flagship model's")
        ds.load_sdf = in_memory_sdf
        spec = CollateSpec(max_nodes=128, max_triples=384, max_scenes=8,
                           diffusion_bs=8, with_sdf=True, sdf_res=64)
        exp = os.path.join(tmp, "exp")
        trainer = Trainer(sg, ds, spec, exp, batch_scenes=8, log_every=1)
        first = state.step
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        trainer.train(state, state.epoch + 1, max_steps=steps,
                      final_save=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        with open(os.path.join(exp, "loss_log.txt")) as f:
            lines = f.read().splitlines()
    want = {"onepass_attention": 10 * steps, "stream_attention": steps}
    if state.step - first != steps or launches != want:
        fail(f"Trainer.train took {state.step - first} steps and launched "
             f"{launches}, want {steps} steps and {want}")
    losses = [float(x) for line in lines
              for x in re.findall(r"(?:box|shape) (\S+?)[,.] ", line)]
    if len(lines) != steps or len(losses) != 2 * steps or not all(
            math.isfinite(x) for x in losses):
        fail(f"Trainer.train logged {lines}")
    print(f"training through Trainer.train: {steps} steps over a fake "
          f"dataset with in-memory SDFs, {wall:.3f} s wall (first batches "
          f"collated), launches {json.dumps(launches)}; log: {lines} "
          f"[{card}]")
    return {"steps": steps, "wall_s": wall, "launches": launches,
            "log": lines}


def train_path(sg, card: str) -> dict:
    """Phase 7: the joint training step at full width, bf16, remat on, on
    the phase-4 model with bench.py's train batch (8 scenes, max_nodes 48,
    max_triples 112, diffusion_bs 8, seeded analytic 64^3 SDFs through the
    frozen encoder): one warm step then 8 timed (K1 / K2 counts set to 0
    just before, read just after), the busy share of one step, frozen VQ-VAE
    and moved parameters, a save -> restore round trip, and one step at the
    yaml's diffusion_bs of 64."""
    import torch
    from echoscene_torch.benchmarks import (NUM_OBJS, NUM_PREDS, profile_call,
                                            synthetic_batch, time_train_step)
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.models.sgdiff import SGDiff
    from echoscene_torch.train.trainer import Trainer

    cfg = sg.cfg
    if not (cfg.compute_dtype == "bfloat16"
            and cfg.shape_branch.denoiser.use_checkpoint
            and cfg.layout_denoiser.use_checkpoint):
        fail("the flagship config must train in bf16 with remat on")
    batch = synthetic_batch(8, 48, 112, seed=0, diffusion_bs=8,
                            sdf_res=64).to("cuda")
    state = sg.init_train_state()
    vq0 = {k: v.clone() for k, v in sg.module.vqvae.state_dict().items()}
    p0 = {n: p.detach().clone() for n, p in sg.module.named_parameters()
          if p.requires_grad}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    k = 8
    sps, step_s, losses = time_train_step(sg, state, batch, 8, k=k)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"onepass_attention": 10 * (k + 1),
            "stream_attention": 1 * (k + 1)}
    if launches != want:
        fail(f"training launched {launches} in {k + 1} steps, want {want} "
             "(K1: 5 sites forward + 5 in the remat recompute; K2: one "
             "encoder chunk of 8 rows)")
    if not bool(torch.isfinite(losses).all()):
        fail(f"training losses not finite: {losses.tolist()}")
    moved = {}
    for n, p in sg.module.named_parameters():
        if n in p0:
            top = n.split(".")[0]
            moved[top] = max(moved.get(top, 0.0),
                             (p.detach() - p0[n]).abs().max().item())
    del p0
    # the GCNs and predicate embeddings feed only c_s, which no loss reads
    # (their gradients are zero in JAX too): they keep their weights
    if not all(moved[top] > 0 for top in ("layout_denoiser", "shape_denoiser",
                                          "rel_s_mlp", "obj_embeddings_ec")):
        fail(f"some trainable parts did not move: {moved}")
    vq = sg.module.vqvae.state_dict()
    if not all(torch.equal(vq[key], v) for key, v in vq0.items()):
        fail("the frozen VQ-VAE changed under training")
    del vq0
    gen = torch.Generator(device="cuda").manual_seed(23)

    def one_step():
        return sg.train_step(state, batch, gen)
    one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    busy = profile_call(one_step, sg.device,
                        (time.perf_counter() - t0) * 1e3)

    # the step in its parts, as train_step runs them: the forward and the
    # losses, the backward, the optimizer (clip, NaN zeroing, AdamW); one
    # pass timed by the host clock, one with each part under the profiler
    params = [p for p in sg.module.parameters() if p.requires_grad]
    held = {}

    def forward():
        held["loss"] = sg.loss_fn(batch, gen)[0]

    def backward():
        held["loss"].backward()

    def optimizer():
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        for p in params:
            p.grad = None
        sg.apply_gradients(state, grads)
    steps = (("forward", forward), ("backward", backward),
             ("optimizer", optimizer))
    wall = {}
    for name, fn in steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall[name] = (time.perf_counter() - t0) * 1e3
    parts = {name: profile_call(fn, sg.device, wall[name])
             for name, fn in steps}
    del held

    trainer = trainer_steps(sg, state, card)

    # save -> restore into a model with other weights, bit for bit
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        t0 = time.perf_counter()
        Trainer(sg, None, None, tmp).save(state, 0)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(tmp, "checkpoint", "model0"))
        torch.manual_seed(1)
        other = SGDiff(cfg, NUM_OBJS, NUM_PREDS, device="cuda")
        t0 = time.perf_counter()
        st2 = Trainer(other, None, None, tmp).load(other.init_train_state(), 0)
        load_s = time.perf_counter() - t0
        a, b = sg.module.state_dict(), other.module.state_dict()
        same = a.keys() == b.keys() and all(torch.equal(a[x], b[x]) for x in a)
        oa, ob = state.optimizer.state_dict(), st2.optimizer.state_dict()
        same = same and oa["state"].keys() == ob["state"].keys() and all(
            torch.equal(v, ob["state"][i][key])
            for i, st in oa["state"].items() for key, v in st.items())
        if not (same and (st2.step, st2.epoch) == (state.step, state.epoch)):
            fail("the checkpoint round trip is not bit-exact")
        # both take the next step from the same draws: the same loss
        # (the forward is deterministic, the GCN pooling a one-hot product;
        # cuDNN's weight gradients need not be, so the updates are not
        # compared bit for bit)
        resumed = [m.train_step(s, batch, torch.Generator(
            device="cuda").manual_seed(31))["loss"].item()
            for m, s in ((sg, state), (other, st2))]
        if not (math.isfinite(resumed[0]) and resumed[0] == resumed[1]):
            fail(f"the step after the restore gave loss {resumed[1]}, the "
                 f"model it was saved from {resumed[0]}")
        del other, st2, a, b, oa, ob
    torch.cuda.empty_cache()

    # one step at the yaml's shape capacity (hyper.batch_size 64), on the
    # node capacity train.cli gives 8 scenes (16 a scene, 3 triples a node)
    batch64 = synthetic_batch(8, 128, 384, seed=0, diffusion_bs=64,
                              sdf_res=64).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    loss64 = sg.train_step(state, batch64, gen)["loss"]
    torch.cuda.synchronize()
    peak64 = torch.cuda.max_memory_allocated()
    launches64 = dict(fa.LAUNCHES)
    if launches64 != {"onepass_attention": 10, "stream_attention": 8}:
        fail(f"the diffusion_bs 64 step launched {launches64}, want K1 10 "
             "and K2 8 (eight encoder chunks of 8)")
    if not bool(torch.isfinite(loss64)):
        fail("the diffusion_bs 64 step's loss is not finite")
    del batch64
    torch.cuda.empty_cache()

    # one step in f32 (compute_dtype float32, f32 masters used as they
    # are): K1 / K2 launch their f32 kernels; one warm step, one timed
    cfg.compute_dtype = "float32"
    try:
        sg.train_step(state, batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        loss32 = sg.train_step(state, batch, gen)["loss"]
        torch.cuda.synchronize()
        f32_ms = (time.perf_counter() - t0) * 1e3
        peak32 = torch.cuda.max_memory_allocated()
        launches32 = dict(fa.LAUNCHES_BY_DTYPE)
    finally:
        cfg.compute_dtype = "bfloat16"
    if launches32 != {("onepass_attention", "float32"): 10,
                      ("stream_attention", "float32"): 1}:
        fail(f"the f32 training step launched {launches32}, want K1 10 and "
             "K2 1, all f32")
    if not bool(torch.isfinite(loss32)):
        fail("the f32 training step's loss is not finite")
    return {"scenes_per_sec": sps, "ms_per_step": step_s * 1e3,
            "losses": losses.tolist(), "launches": launches,
            "steps": k + 1, "peak_gib": peak / 2**30,
            "busy_share": busy["busy_share"],
            "step_device_ms": busy["device_ms"],
            "step_wall_ms": busy["wall_ms"],
            "step_kernel_launches": busy["kernel_launches"],
            "step_parts": parts, "trainer": trainer,
            "moved": moved, "checkpoint_bytes": size, "save_s": save_s,
            "load_s": load_s, "peak_gib_diffusion_bs_64": peak64 / 2**30,
            "loss_diffusion_bs_64": loss64.item(),
            "launches_diffusion_bs_64": launches64,
            "f32_step_ms": f32_ms, "f32_peak_gib": peak32 / 2**30,
            "f32_loss": loss32.item(),
            "f32_launches": {f"{k[0]}/{k[1]}": c
                             for k, c in launches32.items()}}


def serve_path(sg, card: str) -> dict:
    """Phase 8: the generation service on the phase-4 model, at the fast
    profile (DPM++ with 50 layout and 20 shape steps, bf16), the vocabulary
    and box stats of a fake dataset, buckets of 48 nodes / 160 triples / 8
    scenes and the row ladder (16, 32, 48).  Warmup; 8 concurrent clients
    through the MicroBatcher (10 ms window); an addition and a relationship
    change against earlier results (untouched objects bit-equal); a mesh
    request; an HTTP round trip and a malformed request; an f32 request;
    two fresh seed-0 services on one request.  K1 / K2 counts are set to 0
    just before each part and read just after: K1 = 5 x 20 and K2 =
    ceil(rows / 8) per dispatch.  Runs last: it leaves the model on the
    fast profile."""
    import socket
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from echoscene_torch.benchmarks import (NUM_OBJS, NUM_PREDS,
                                            concurrent_latency)
    from echoscene_torch.data.clip_text import ClipTextEncoder
    from echoscene_torch.data.collate import CollateSpec
    from echoscene_torch.data.fake import make_fake_dataset
    from echoscene_torch.data.sgfront import SGFrontDataset
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.serve.cli import run_http
    from echoscene_torch.serve.service import GenerationService

    t_phase = time.perf_counter()
    clip = ClipTextEncoder("hash")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        root = make_fake_dataset(os.path.join(tmp, "data"), num_scenes=8,
                                 min_objs=3, max_objs=6, with_sdf=False,
                                 seed=0)
        ds = SGFrontDataset(root, split="test", shuffle_objs=False,
                            use_sdf=False, with_changes=False, clip=clip,
                            seed=47)
    if (len(ds.classes), len(ds.pred_names)) != (NUM_OBJS, NUM_PREDS):
        fail("the fake vocabulary does not match the flagship model's")
    spec = CollateSpec(max_nodes=48, max_triples=160, max_scenes=8,
                       diffusion_bs=48, with_sdf=False)
    cfg = sg.cfg
    cfg.layout_diffusion.sampler, cfg.layout_diffusion.sample_steps = (
        "dpmpp", 50)
    cfg.shape_branch.sampler, cfg.shape_branch.ddim_steps = "dpmpp", 20
    sg.layout_fast_tables["dpmpp"] = sg.layout_diff.make_dpmpp_tables(50)
    sg.ddim_tables = sg.shape_diff.make_dpmpp_tables(20)
    steps = sg.ddim_tables.num_steps
    buckets = (16, 32, 48)

    def service(**kw):
        kw.setdefault("result_format", "arrays")
        return GenerationService(sg, spec, ds.box_stats, ds.classes,
                                 ds.rel_dict, clip=clip, row_buckets=buckets,
                                 **kw)

    # the rows of every dispatch, to hold K1 / K2 to their per-dispatch counts
    dispatch_rows = []
    sample_fn = sg.sample_fn

    def logged_sample_fn(batch, generator=None, **kw):
        dispatch_rows.append(kw["shape_rows"])
        return sample_fn(batch, generator, **kw)
    sg.sample_fn = logged_sample_fn

    def counted(part, fn, dtype="bfloat16"):
        """fn() with the counts set to 0 just before and read just after;
        fails unless each dispatch launched K1 5 x steps and K2 ceil(rows /
        8) times, all in `dtype`."""
        dispatch_rows.clear()
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(fa.LAUNCHES_BY_DTYPE)
        want = {("onepass_attention", dtype): 5 * steps * len(dispatch_rows),
                ("stream_attention", dtype): sum(
                    math.ceil(r / 8) for r in dispatch_rows)}
        if not dispatch_rows or got != want:
            fail(f"serving {part}: {len(dispatch_rows)} dispatches at rows "
                 f"{dispatch_rows} launched {got}, want {want}")
        return out, wall, list(dispatch_rows), got

    def finite(res):
        keys = [k for k in ("sizes", "translations", "angles", "sdfs")
                if k in res]
        return all(np.isfinite(np.asarray(res[k])).all() for k in keys)

    names = [n for n in ds.classes if n != "_scene_"]
    preds = list(ds.rel_dict)
    rng = np.random.default_rng(8)

    def request(rid):
        k = int(rng.integers(3, 7))
        pairs = [(s, o) for s in range(k) for o in range(k) if s != o]
        pick = rng.choice(len(pairs), int(rng.integers(2, 5)), replace=False)
        return {"id": rid,
                "objects": [names[int(i)] for i in rng.integers(0, len(names),
                                                                k)],
                "triples": [[pairs[i][0], preds[int(rng.integers(len(preds)))],
                             pairs[i][1]] for i in pick]}

    svc = service(gen_shape=True, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_warm = svc.warmup(verbose=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warmed = svc.compiled_variants()
    print(f"serving warmup: {n_warm} variants {warmed} in {warm_s:.3f} s "
          f"[{card}]")

    # 8 concurrent clients, 16 requests of 3-6 objects and 2-4 triples
    reqs = [request(f"s{i}") for i in range(16)]
    reserved0 = torch.cuda.memory_reserved()
    stream, stream_s, stream_rows, stream_launches = counted(
        "stream", lambda: concurrent_latency(svc, reqs, 10.0, 8))
    reserved1 = torch.cuda.memory_reserved()
    results = stream["results"]
    if sorted(results) != list(range(len(reqs))) or not all(
            finite(r) and r["id"] == reqs[i]["id"]
            for i, r in results.items()):
        fail("the concurrent stream's results are missing or not finite")
    lat = np.asarray(stream["latencies_s"])
    st = stream["stats"]
    print(f"serving 8 concurrent clients: {len(reqs)} requests, latency p50 "
          f"{np.percentile(lat, 50):.3f} s, p95 {np.percentile(lat, 95):.3f}"
          f" s, {stream['req_per_sec']:.4f} requests/sec, {st['batches']} "
          f"batches (mean size {st['mean_batch_size']:.2f}), dispatches at "
          f"rows {stream_rows}; reserved memory {reserved0 / 2**30:.2f} -> "
          f"{reserved1 / 2**30:.2f} GiB [{card}]")

    # an addition and a relationship change against earlier results
    base_add, base_rel = results[0], results[1]
    old_pred = reqs[1]["triples"][0][1]
    manips = [
        (base_add, {"previous": "s0", "id": "m_add", "manipulation": {
            "type": "addition", "object": names[0],
            "triples": [[-1, preds[0], 0]]}}),
        (base_rel, {"previous": "s1", "id": "m_rel", "manipulation": {
            "type": "relationship", "index": 0,
            "predicate": next(p for p in preds if p != old_pred)}})]
    manip_s = []
    for prev, req in manips:
        (out,), wall, _, _ = counted(req["id"],
                                     lambda: svc.generate([req]))
        manip_s.append(wall)
        kept = [j for j, k in enumerate(out["keep"]) if k == 1.0]
        changed = [j for j, k in enumerate(out["keep"]) if k == 0.0]
        if not (finite(out) and kept and changed):
            fail(f"manipulation {req['id']}: keep {out['keep']}")
        for j in kept:
            same = all(out[f][j] == prev[f][j]
                       for f in ("sizes", "translations", "angles"))
            if not (same and np.array_equal(out["sdfs"][j], prev["sdfs"][j])):
                fail(f"manipulation {req['id']}: untouched object {j} "
                     "differs from the previous response")
    if svc.compiled_variants() != warmed:
        fail(f"serving ran variants {svc.compiled_variants()} after warming "
             f"{warmed}")
    print(f"serving manipulations: addition {manip_s[0]:.3f} s, "
          f"relationship {manip_s[1]:.3f} s, untouched objects bit-equal; "
          f"no variant after warmup [{card}]")

    # meshes of the real rows
    mesh_svc = service(gen_shape=True, seed=1, return_meshes=True)
    (meshed,), mesh_s, _, _ = counted(
        "meshes", lambda: mesh_svc.generate([dict(reqs[2], id="mesh")]))
    tris = [len(m["faces"]) for m in meshed["meshes"]]
    if len(tris) != len(reqs[2]["objects"]) or min(tris) == 0 or not all(
            np.isfinite(m["vertices"]).all() for m in meshed["meshes"]):
        fail(f"mesh request: {len(tris)} meshes with {tris} triangles")
    print(f"serving meshes: {len(tris)} objects, {tris} triangles, "
          f"{mesh_s:.3f} s [{card}]")

    # the HTTP endpoint on 127.0.0.1 (layout only, as the CLI serves by
    # default), and a malformed request
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    http_svc = service(gen_shape=False, seed=2, result_format="json")
    threading.Thread(target=run_http, args=(http_svc, "127.0.0.1", port),
                     daemon=True).start()
    url = f"http://127.0.0.1:{port}/generate"
    payload = json.dumps([dict(reqs[3], id="h0")]).encode()
    t0 = time.perf_counter()
    for _ in range(100):
        try:
            resp = urllib.request.urlopen(urllib.request.Request(
                url, data=payload,
                headers={"Content-Type": "application/json"}), timeout=300)
            break
        except urllib.error.URLError as e:
            if isinstance(e, urllib.error.HTTPError):
                fail(f"HTTP round trip: {e.code} {e.read()[:300]}")
            time.sleep(0.05)
    else:
        fail("the HTTP endpoint did not answer")
    body = json.loads(resp.read())
    http_s = time.perf_counter() - t0
    if [r["id"] for r in body["results"]] != ["h0"] or not finite(
            body["results"][0]):
        fail(f"HTTP round trip returned {str(body)[:300]}")
    try:
        urllib.request.urlopen(urllib.request.Request(
            url, data=json.dumps([{"objects": ["nope"]}]).encode()),
            timeout=60)
        fail("a malformed request was answered with 200")
    except urllib.error.HTTPError as e:
        if e.code != 400 or "error" not in json.loads(e.read()):
            fail(f"a malformed request got {e.code}, want 400")
    print(f"serving HTTP: POST round trip {http_s:.3f} s, malformed request "
          f"-> 400 [{card}]")

    # one request sampled in f32: K1 / K2 launch their f32 kernels
    cfg.sample_dtype = "float32"
    try:
        f32_svc = service(gen_shape=True, seed=3)
        (f32_out,), f32_s, f32_rows, f32_launches = counted(
            "f32", lambda: f32_svc.generate([dict(reqs[4], id="f32")]),
            dtype="float32")
    finally:
        cfg.sample_dtype = "bfloat16"
    if not finite(f32_out):
        fail("the f32 request's outputs are not finite")
    print(f"serving f32 request: {f32_s:.3f} s at rows {f32_rows}, launches "
          f"{f32_launches} [{card}]")

    # two fresh seed-0 services, one request: the same bits
    twins = [service(gen_shape=True, seed=0).generate(
        [dict(reqs[5], id="twin")])[0] for _ in range(2)]
    same = all(twins[0][f] == twins[1][f]
               for f in ("sizes", "translations", "angles"))
    sdf_diff = float(np.abs(twins[0]["sdfs"] - twins[1]["sdfs"]).max())
    if not same:
        fail("two seed-0 services gave different boxes for one request")
    print(f"serving reproducibility: two seed-0 services, boxes bit-equal, "
          f"SDFs max abs difference {sdf_diff:.3e} [{card}]")
    del sg.sample_fn
    return {"warmup_s": warm_s, "warmed_variants": [list(v) for v in warmed],
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p95_s": float(np.percentile(lat, 95)),
            "latencies_s": stream["latencies_s"],
            "req_per_sec": stream["req_per_sec"], "stream_s": stream_s,
            "batches": st["batches"],
            "mean_batch_size": st["mean_batch_size"],
            "dispatch_rows": stream_rows,
            "stream_launches": {f"{k[0]}/{k[1]}": c
                                for k, c in stream_launches.items()},
            "reserved_gib_before": reserved0 / 2**30,
            "reserved_gib_after": reserved1 / 2**30,
            "manipulation_s": manip_s, "mesh_s": mesh_s,
            "mesh_triangles": tris, "http_s": http_s, "f32_s": f32_s,
            "f32_rows": f32_rows,
            "f32_launches": {f"{k[0]}/{k[1]}": c
                             for k, c in f32_launches.items()},
            "twin_sdf_max_diff": sdf_diff,
            "phase_s": time.perf_counter() - t_phase}


def main() -> int:
    global T_START
    T_START = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "echoscene_torch", "csrc")):
        print("chip_smoke: echoscene_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from echoscene_torch.benchmarks import (build_flagship,
                                            device_busy_shares,
                                            synthetic_batch, time_generation)
    from echoscene_torch.kernels import build
    from echoscene_torch import native
    from echoscene_torch.kernels import chamfer as k4
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.models.sgdiff import set_precision, shape_row_capacity

    set_precision()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build: one nvcc per source, all started together
    sources = (fa.SOURCE, fa.SOURCE_F32, BASELINE_SOURCE, k4.SOURCE,
               K4_DIRECT_SOURCE)
    t0 = time.perf_counter()
    built = build.build_all(sources)
    for source in sources:
        build.load(source)
    print(f"build: {time.perf_counter() - t0:.2f} s for {', '.join(sources)}")
    for source in sources:
        seconds, report = built[source]
        print(f"  {source}: {seconds:.2f} s")
        for line in report.splitlines():
            fn = re.search(r"Compiling entry function '(\S+)'", line)
            if fn:
                print(f"    {fn.group(1)}")
            elif ("registers" in line or "spill" in line
                  or "Performance Loss" in line):
                print(f"      {line.strip()}")

    # the main path's row count fixes K1's batch dimension
    rows = shape_row_capacity(synthetic_batch(), multiple=1)

    # 2. kernels against their plain versions at the main path's shapes
    clock = max_sm_clock_hz()
    entries = [
        check_kernel("onepass_attention", fa.onepass_attention,
                     (rows, 1024, 8, 56),
                     [(3, 200, 2, 24), (3, 333, 8, 56), TRAIN_K1_SHAPE],
                     "echoscene_tpu/kernels/flash_attention.py:73", clock),
        check_kernel("stream_attention", fa.stream_attention,
                     (8, 4096, 1, 256), [(2, 77, 3, 200)],
                     "echoscene_tpu/kernels/flash_attention.py:35", clock),
    ]
    for e in entries:
        d = e["bound_detail"]
        print(f"kernel {e['name']} {e['shape']}: {e['ms']:.4f} ms, "
              f"{e['tflops']:.1f} TFLOP/s, {e['share_of_bound']:.3f} of the "
              f"bound {e['bound_ms']:.4f} ms (by {d['by']}: tensor cores "
              f"{d['tensor_core_ms']:.4f}, exp2 at {clock / 1e6:.0f} MHz "
              f"{d['exp2_ms']:.4f}, bytes {d['bytes_ms']:.4f}); sdpa "
              f"{e['library_ms']:.4f} ms ({e['vs_library']:.3f} x its "
              f"time), earlier mma.sync design {e['earlier_ms']:.4f} ms "
              f"({e['earlier_ms'] / e['ms']:.2f} x this), plain "
              f"{e['plain_ms']:.3f} ms; host {e['host_us_per_call']:.1f} us "
              f"per wrapper call; max abs err {e['max_abs_err']:.3e}, max / "
              f"mean err at {e['err_of_limit'][0]:.3f} / "
              f"{e['err_of_limit'][1]:.3f} of their limits, 32 keys left out "
              f"at {e['keys_dropped_err_of_limit'][0]:.3f} / "
              f"{e['keys_dropped_err_of_limit'][1]:.3f} [{card}]")
    # K1 / K2 at the training shapes, through the differentiable Function
    for e, shape in zip(entries, (TRAIN_K1_SHAPE, TRAIN_K2_SHAPE)):
        wrapper = getattr(fa, e["name"])
        e.update(check_kernel_backward(e["name"], wrapper, shape))
        print(f"kernel {e['name']} {shape} forward + backward (kernel forward,"
              f" plain recompute backward): {e['fwd_bwd_ms']:.4f} ms; plain "
              f"forward + backward {e['plain_fwd_bwd_ms']:.4f} ms; sdpa "
              f"forward + backward {e['library_fwd_bwd_ms']:.4f} ms; dq, dk, "
              f"dv vs plain autograd: bit-equal {e['grad_bit_equal']}, max "
              f"diff {e['grad_max_diff_of_peak']:.3e} of the peak; forward "
              f"max / mean err at {e['train_err_of_limit'][0]:.3f} / "
              f"{e['train_err_of_limit'][1]:.3f} of their limits [{card}]")
    # K1 / K2 on f32 inputs (f32 sampling and training), the f32 kernel
    f32_entries = [
        check_kernel_f32("onepass_attention", fa.onepass_attention,
                         (rows, 1024, 8, 56),
                         [(3, 200, 2, 24), (3, 333, 8, 56), TRAIN_K1_SHAPE],
                         "echoscene_tpu/kernels/flash_attention.py:73", clock),
        check_kernel_f32("stream_attention", fa.stream_attention,
                         (8, 4096, 1, 256), [(2, 77, 3, 200)],
                         "echoscene_tpu/kernels/flash_attention.py:35",
                         clock)]
    for e in f32_entries:
        d = e["bound_detail"]
        print(f"kernel {e['name']} {e['shape']} f32: {e['ms']:.4f} ms, "
              f"{e['tflops']:.2f} TFLOP/s, {e['share_of_bound']:.3f} of the "
              f"f32 bound {e['bound_ms']:.4f} ms (by {d['by']}: f32 FMA "
              f"{d['fma_ms']:.4f}, exp2 {d['exp2_ms']:.4f}, bytes "
              f"{d['bytes_ms']:.4f}); sdpa f32 (TF32 off) "
              f"{e['library_ms']:.4f} ms ({e['vs_library']:.3f} x its "
              f"time), plain {e['plain_ms']:.3f} ms; host "
              f"{e['host_us_per_call']:.1f} us per wrapper call; max abs err "
              f"{e['max_abs_err']:.3e}, max / mean err at "
              f"{e['err_of_limit'][0]:.4f} / {e['err_of_limit'][1]:.4f} of "
              f"their limits (2^-14 / 1e-5), 32 keys left out at "
              f"{e['keys_dropped_err_of_limit'][0]:.1f} / "
              f"{e['keys_dropped_err_of_limit'][1]:.1f} [{card}]")
    # K4 at the metric shapes: the MMD step's chamfers (8 references of
    # 5000 points), a full batch of 16, one consistency pair, and a ragged
    # case
    e = check_chamfer_kernel(
        ((8, 5000, 5000), (16, 5000, 5000), (1, 5000, 5000)), (3, 777, 1001))
    entries.append(e)
    for p in e["per_shape"]:
        print(f"kernel {e['name']} {p['shape']}: {p['ms']:.4f} ms, "
              f"{p['share_of_bound']:.3f} of the bound {p['bound_ms']:.4f} ms "
              f"(by {p['bound_by']}; {p['pair_tflops']:.1f} TFLOP/s at 8 a "
              f"pair); cdist+amin {p['library_ms']:.4f} ms, earlier direct "
              f"design {p['earlier_ms']:.4f} ms ({p['earlier_ms'] / p['ms']:.2f}"
              f" x this), plain {p['plain_ms']:.3f} ms; host "
              f"{p['host_us_per_call']:.1f} us per wrapper call; max abs err "
              f"{p['max_abs_err']:.3e}, max / mean err at "
              f"{p['err_of_limit'][0]:.3f} / {p['err_of_limit'][1]:.3f} of "
              f"their limits, {p['ulp']:.0f} ulp (floor {p['ulp_floor']:.2e})"
              f", chamfer rel err {p['chamfer_rel_err']:.3e} [{card}]")
    print(f"kernel {e['name']}: 64 targets left out at "
          f"{e['targets_dropped_err_of_limit'][0]:.1f} / "
          f"{e['targets_dropped_err_of_limit'][1]:.1f} of the limits")

    # 3. the rest of the port on the card vs on the CPU
    err = check_tiny_against_cpu()
    print(f"tiny config, CUDA vs CPU f32 sample: max abs err {err:.3e}")
    tr = check_tiny_train_against_cpu()
    print(f"tiny config, CUDA vs CPU f32 training step: {json.dumps(tr)}")
    worst = check_metrics_against_cpu()
    print(f"MMD / COV / 1-NN, CUDA vs CPU: largest relative differences "
          f"{json.dumps(worst)}")

    # 4. the main path: one full-width flagship generation
    t0 = time.perf_counter()
    sg, batch = build_flagship(device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in sg.module.parameters())
    print(f"flagship: {n_params} parameters, {rows} real rows of "
          f"{batch.num_nodes}, built in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    sps, wall, out = time_generation(sg, batch, batch.num_scenes, n_iters=1,
                                     warmup=False)
    launches = dict(fa.LAUNCHES)
    n = batch.num_nodes
    want_shapes = {"sizes": (n, 3), "translations": (n, 3), "angles": (n, 1),
                   "keep": (n,), "shapes": (n, 64, 64, 64, 1)}
    for key, shp in want_shapes.items():
        if tuple(out[key].shape) != shp:
            fail(f"output {key} has shape {tuple(out[key].shape)}, want {shp}")
        if not bool(torch.isfinite(out[key].float()).all()):
            fail(f"output {key} is not finite")
    if not bool(out["shapes"][:rows].float().abs().sum() > 0):
        fail("decoded SDFs of the real rows are all zero")
    want = {"onepass_attention": 5 * sg.ddim_tables.num_steps,
            "stream_attention": math.ceil(rows / 8)}
    for name, count in want.items():
        if launches[name] != count:
            fail(f"{name} launched {launches[name]} times, want {count}")
    for e in entries[:2]:
        e["launches"] = launches[e["name"]]
    print(f"generation: {wall:.3f} s wall, {sps:.4f} scenes/sec "
          f"({batch.num_scenes} scenes, first call in the process), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    print(f"launches on the main path: {json.dumps(launches)}")

    # 5. how busy the device is in each part of sample_fn, timed alone
    parts = device_busy_shares(sg, batch, rows)
    for name, p in parts.items():
        busy = (f"{p['busy_share']:.3f}" if p["busy_share"] is not None
                else "not measured")
        print(f"part {name}: {p['wall_ms']:.3f} ms wall per call, device "
              f"busy share {busy}, {p['kernel_launches']} kernel launches "
              f"[{card}]")

    # 6. the evaluation path: fake dataset -> SceneEvaluator -> SDF dumps ->
    # consistency CLI -> MMD / COV / 1-NN, on the phase-4 model
    ev = eval_path(sg, card)
    entries[2]["launches"] = ev["nn_distance_launches"]
    entries[2]["launches_by_shape"] = ev["nn_distance_launches_by_shape"]
    for p in entries[2]["per_shape"]:
        p["launches"] = ev["nn_distance_launches_by_shape"].get(
            str(p["shape"]), 0)
    print(f"eval path wall seconds: {json.dumps(ev)}; native library "
          f"available: {native.available()} [{card}]")
    # 7. the joint training step at full width on the phase-4 model
    t0 = time.perf_counter()
    tr = train_path(sg, card)
    for e in entries[:2]:
        e["train_launches"] = tr["launches"][e["name"]]
        e["train_launches_per_step"] = tr["launches"][e["name"]] // tr["steps"]
    print(f"training: {tr['scenes_per_sec']:.4f} train scenes/sec, "
          f"{tr['ms_per_step']:.3f} ms per step (8 scenes, diffusion_bs 8, "
          f"bf16, remat; 1 warm + 8 timed steps), peak memory "
          f"{tr['peak_gib']:.2f} GiB; one step: {tr['step_wall_ms']:.3f} ms "
          f"wall, device busy share {tr['busy_share']:.3f}, "
          f"{tr['step_kernel_launches']} kernel launches; diffusion_bs 64: "
          f"peak memory {tr['peak_gib_diffusion_bs_64']:.2f} GiB [{card}]")
    for name, p in tr["step_parts"].items():
        print(f"training step part {name}: {p['wall_ms']:.3f} ms wall, "
              f"device {p['device_ms']:.3f} ms, busy share "
              f"{p['busy_share']:.3f}, {p['kernel_launches']} kernel "
              f"launches [{card}]")
    print(f"training in f32 (compute_dtype float32): one step "
          f"{tr['f32_step_ms']:.3f} ms, peak memory {tr['f32_peak_gib']:.2f} "
          f"GiB, loss {tr['f32_loss']:.6g}, launches "
          f"{json.dumps(tr['f32_launches'])} [{card}]")
    print(f"training details: {json.dumps(tr)}; phase 7 took "
          f"{time.perf_counter() - t0:.1f} s")
    for e, name in zip(f32_entries, ("onepass_attention", "stream_attention")):
        e["train_launches_per_step"] = tr["f32_launches"][f"{name}/float32"]

    # 8. the generation service at the fast profile on the phase-4 model
    sv = serve_path(sg, card)
    for e in entries[:2]:
        e["serve_launches"] = sv["stream_launches"][f"{e['name']}/bfloat16"]
    for e, name in zip(f32_entries, ("onepass_attention", "stream_attention")):
        # the f32 kernels' main path: the f32 request of phase 8
        e["launches"] = sv["f32_launches"][f"{name}/float32"]
    print(f"serving details: {json.dumps(sv)}; phase 8 took "
          f"{sv['phase_s']:.1f} s")
    entries[2:2] = f32_entries
    for e in entries:
        e["status"] = "ported: built, matches its plain version, on the path"

    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
