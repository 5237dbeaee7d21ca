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
     * K1 / K2 on f32 inputs (f32 sampling and training), the 3xTF32
       kernel (`csrc/flash_attention_tf32x3.cu`) at the same shapes and
       ragged ones (D 8 to 256): against the plain version in f32, max abs
       error <= 2^-14 of the plain output's peak and mean abs error <= 1e-5
       of its mean magnitude, a tolerance that must reject the plain
       version with its last 32 keys left out; times beside the f32 bound
       (three TF32 products per product at 495 TFLOP/s, exp2, 4-byte
       elements; the f32 FMA route at 67 TFLOP/s beside it), its pre-pass
       alone, the earlier f32 FMA design (`csrc/flash_attention_f32.cu`,
       same inputs, same tolerance), SDPA in f32 with TF32 off, the plain
       version and the host time of one wrapper call;
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
     dumped real-row SDF meshes, one 256^2 render and one .glb per
     scene, the render equal to its .glb rasterized again and the .glb's
     objects spanning the heights of the generated boxes and lying within
     their footprints, the boxes descaled by the script itself (random
     weights put them out of view, so the pixels drawn on the floor are
     counted, not required), the consistency's CLIP
     block (pixel proxy) finite, that every part gives finite values, and
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
     each part and read just after;
  9. drive the training pipeline: VQ-VAE training at configs/vqvae_snet.yaml
     widths (ch 64, ch_mult 1-2-4, 8192 codes, 64^3 grids), batch 8, seeded
     weights and analytic SDFs: 3 f32 steps (median ms, peak memory; K2 f32
     = 2 a step, the encoder's and the decoder's mid attention), one under
     torch.profiler (device time, busy share, launches), 2 bf16 steps (K2
     bf16 = 2 a step, f32 masters), eval_iou over 64 grids (K2 = 2 a
     batch); K2 in f32 with a gradient at (8, 4096, 1, 256): dq, dk, dv
     bit-equal to plain autograd's, timed beside the plain forward +
     backward, SDPA f32 forward + backward (TF32 off) and the bound of
     forward + backward; one tiny VQ-VAE f32 step card vs CPU (loss within
     1e-5 relative, each gradient leaf within 1e-3 of its own peak + 1e-7,
     Adam from the CPU's gradients within 1e-6); the VQ checkpoint (the
     VQ CLI's writer) -> `precompute_latents` over a fake dataset's SDF
     paths (K2 f32 = one a batch of 8) -> the cache file ->
     `train.cli.main` at full_mp.yaml width in bf16 with --vq_ckpt,
     --latent_cache, 4 steps and one preview at the fast profile (DPM++ 50
     / 20, a yaml copy in a temporary directory; K1 = 10 a step + 100 for
     the preview, K2 = 0 a step + one per decode chunk of the preview's
     128 rows; exactly two images, gen_shape_0 / 1, once); the joint step
     from latents on the phase-4 model, timed as phase 7's (K1 = 10, K2 =
     0 a step); a background checkpoint save at full width (its blocking
     part and the whole write) with a parameter changed in place right after
     it returns, restored bit-exact and without that change, and a
     synchronous save, timed;
 10. drive the image metrics on the phase-4 model: GT box renders of a
     fake test split (`eval.gt_renders`); layout-only `SceneEvaluator`
     runs at DPM++ 50 with the onlybox, retrieval (a cat_jid table of OBJ
     boxes) and txt2shape (a directory of PLY meshes) render types and a
     relationship run of onlybox for the `_mani.png` overlay, each checked
     for its renders (256^2, each equal to its .glb rasterized again, at
     least one a run drawing something besides the floor), .glb files and
     object meshes, and for K1 = K2 = K4 = 0; FID-InceptionV3 at
     full width on the card from seeded weights written as JAX's .npz
     (the extractor must be the port's module, not TorchScript), its
     features against the same module on the CPU on 4 renders (max abs
     error <= 1e-4 of the peak); `eval.fid_cli` over the onlybox renders
     against the GT renders (finite FID and KID, n_real / n_fake equal to
     the file counts); the feature throughput at batch 64 of 299^2, its
     peak memory, and the wall seconds of each part.

Prints the total seconds, the `kernels` JSON line (K1 / K2 in bf16 and in
f32, each entry with its dtype; K1 / K2 also carry their training launches,
serving launches and forward + backward times; the f32 entries' launches
are phase 8's f32 request; the f32 K2 entry also carries its VQ-VAE
launches; `stream_attention_f32_train` is K2 f32 forward + plain backward
at the VQ-VAE site, its launches phase 9's 3 f32 steps; every entry's
`image_metrics_launches` is its wrapper's count over the whole of phase 10,
the counts set to 0 at the phase's start and read at its end), the card's
name and power limit
(nvidia-smi), and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one card; exits 2 without CUDA or without the repository beside it.
"""
from __future__ import annotations

import dataclasses
import hashlib
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
VQ_BATCH = 8                 # VQ-VAE training batch (scripts/train_vqvae.py)
VQ_GRAD_SHAPE = (8, 4096, 1, 256)   # K2 at the VQ-VAE's mid attention
VQ_LEAF_RTOL = 1e-3          # tiny VQ-VAE step, each leaf of its own peak
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


# the earlier (f32 FMA, CUDA cores) design of the f32 K1 / K2 kernel, timed
# beside the 3xTF32 kernel in the same run; no path of the port calls it
F32_SIMT_SOURCE = "flash_attention_f32.cu"
_baseline_f32 = []


def f32_simt_baseline(q, k, v):
    """softmax(q k^T D^-1/2) v on f32 inputs by the earlier design's kernel."""
    import ctypes
    import torch
    from echoscene_torch.kernels import build
    if not _baseline_f32:
        fn = build.load(F32_SIMT_SOURCE).echoscene_onepass_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _baseline_f32.append(fn)
    b, l, h, d = q.shape
    o = torch.empty_like(q)
    err = _baseline_f32[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), b, h, l, k.shape[1], d, d ** -0.5,
                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"the earlier f32 kernel failed to launch: CUDA error {err}")
    return o


_prepass = []


def f32_prepass(q, k, v, scratch):
    """The f32 kernel's pre-pass alone (split of k and v into TF32 hi / lo
    parts, v transposed) into `scratch`."""
    import ctypes
    import torch
    from echoscene_torch.kernels import build
    from echoscene_torch.kernels import flash_attention as fa
    if not _prepass:
        fn = build.load(fa.SOURCE_F32).echoscene_attention_f32_prepass
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _prepass.append(fn)
    b, l, h, d = q.shape
    err = _prepass[0](k.data_ptr(), v.data_ptr(), b, h, l,
                      k.shape[1], d, torch.cuda.current_stream().cuda_stream,
                      scratch.data_ptr())
    if err != 0:
        fail(f"the f32 pre-pass failed to launch: CUDA error {err}")


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
    """Phase 2 for the f32 kernel of one attention wrapper (3xTF32 on the
    tensor cores): f32 inputs against `attention_plain` in f32 at the path
    shape and the ragged ones (`error_ratios`' f32 limits: max abs err <=
    2^-14 of the plain output's peak, mean abs err <= 1e-5 of its mean
    magnitude, which must reject the plain version with its last 32 keys
    left out); times beside the f32 bound (the 3xTF32 products, exp2,
    bytes; the f32 FMA route beside it), its pre-pass alone, the earlier
    f32 FMA design (`csrc/flash_attention_f32.cu`, same inputs, same
    tolerance), SDPA in f32 with TF32 off, the plain version and the host
    time of one wrapper call.  Returns its `kernels` entry."""
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
    earlier = fa.error_ratios(f32_simt_baseline(q, k, v), ref)
    if not max(earlier) <= 1.0:
        fail(f"the earlier f32 design at {shape}: max / mean err at "
             f"{earlier[0]:.3f} / {earlier[1]:.3f} of their limits")
    ms = cuda_ms(lambda: wrapper(q, k, v), iters=10)
    earlier_ms = cuda_ms(lambda: f32_simt_baseline(q, k, v), iters=10)
    b, _, h, d = q.shape
    scratch = torch.empty(fa.f32_scratch_floats(b, h, d, k.shape[1]),
                          device="cuda")
    prepass_ms = cuda_ms(lambda: f32_prepass(q, k, v, scratch), iters=10)
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
            "source": f"echoscene_torch/csrc/{fa.SOURCE_F32}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["ms"],
            "bound_by": bound["bound_by"], "library_ms": library_ms,
            "earlier_ms": earlier_ms, "prepass_ms": prepass_ms,
            "shape": list(shape),
            "bound_detail": {key: bound[key] for key in (
                "by", "fma_ms", "tf32x3_ms", "exp2_ms", "bytes_ms")},
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
        render_dir = os.path.join(tmp, "renders")
        ev = SceneEvaluator(sg, spec, ds.box_stats, gen_shape=True,
                            store_path=store, dump_sdfs=True, eval_batch=8,
                            render_dir=render_dir, export_glb=True)
        # the layout of each scene as the model gave it, in [-1, 1], before
        # the evaluator descales it
        raw, score_scene = {}, ev.score_scene

        def keep_raw(ds_, ex, out_slice, *rest):
            raw[ex.scan_id] = (list(ex.objs), out_slice["sizes"].copy(),
                               out_slice["translations"].copy())
            return score_scene(ds_, ex, out_slice, *rest)

        ev.score_scene = keep_raw

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
        # random weights put boxes far off (heights and bottoms of
        # hundreds of metres), above the camera or under the floor, and
        # the chain is bit-reproducible, so these renders show only the
        # floor on every run: each is held to its .glb's geometry, and that
        # geometry to the generated boxes
        drawn = check_renders(render_dir, [e.scan_id for e in examples],
                              "echoscene")
        box_range = check_placement(render_dir, raw, ds.box_stats,
                                    ds.vocab["object_idx_to_name"],
                                    "echoscene")
        # the model's layout output, to compare runs
        digest = hashlib.sha256(b"".join(
            raw[k][1].tobytes() + raw[k][2].tobytes()
            for k in sorted(raw))).hexdigest()[:16]
        print(f"eval generation: {len(examples)} scenes, {rows} rows, "
              f"{gen_s:.3f} s wall with the renders; accuracy total "
              f"{total.group(1)}, means of mean {total.group(2)}; {n_rows} "
              f"dumped SDFs, {n_tris / n_rows:.0f} triangles each on "
              f"average; {len(examples)} renders of 256^2 with a .glb each, "
              f"pixels drawn on the floor per render {drawn}; generated "
              f"box sizes and positions descaled between "
              f"{box_range[0]:.2f} and {box_range[1]:.2f} m, layout digest "
              f"{digest} [{card}]")

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
                                    "--generated_dir", store,
                                    "--clip", "pixel"])
        torch.cuda.synchronize()
        cons_s = time.perf_counter() - t0
        clip = agg.pop("clip", None)
        if not all(math.isfinite(v) for v in agg.values()):
            fail(f"consistency is not finite: {agg}")
        if not clip or not all(math.isfinite(v) for v in clip.values()):
            fail(f"the consistency CLIP block is missing or not finite: "
                 f"{clip}")
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
          f"{agg['total']:.6g}, CLIP (pixel proxy) total "
          f"{clip['total']:.6g}, {cons_s:.3f} s wall [{card}]")
    print(f"eval MMD / COV / 1-NN: 8 vs 8 clouds, {json.dumps(mmd)}, "
          f"{mmd_s:.3f} s wall, of which chamfers (the step with an EMD of "
          f"zeros) {mmd_cd_s:.3f} s and auction EMD the other "
          f"{mmd_s - mmd_cd_s:.3f} s [{card}]")
    shapes = {str(list(k)): c for k, c in sorted(shapes.items())}
    print(f"eval nn_distance launches by shape (counted by the wrapper): "
          f"{json.dumps(shapes)}")
    return {"nn_distance_launches": launches, "generation_render_s": gen_s,
            "drawn_pixels": drawn, "box_range_m": box_range,
            "layout_digest": digest,
            "clouds_s": cloud_s, "consistency_s": cons_s, "mmd_s": mmd_s,
            "mmd_chamfer_s": mmd_cd_s, "nn_distance_launches_by_shape": shapes}


def floor_colours():
    """The colours of a render with nothing on the floor, the background
    and the floor plane, as a (k, 3) uint8 array."""
    import numpy as np
    from echoscene_torch import native
    from echoscene_torch.eval.render import assemble_scene

    img = native.rasterize_topdown(*assemble_scene(
        [], np.zeros((0, 7), np.float32), []), width=256, height=256)
    return np.unique(img.reshape(-1, 3), axis=0)


def check_renders(render_dir, scan_ids, render_type, mani=False,
                  glb=True) -> list:
    """Each scene has a 256^2 `<scan_id>.png` (and `_mani.png` when
    `mani`); with `glb`, a `.glb` that holds objects besides the floor and
    whose geometry, rasterized again, gives the render bit for bit.
    Returns the pixels drawn on the floor per render (an object below the
    floor plane is hidden by it, so a scene may draw none)."""
    import numpy as np
    from PIL import Image
    from echoscene_torch import native
    from echoscene_torch.eval.render import read_glb

    def read_png(path):
        return np.asarray(Image.open(path).convert("RGB"))

    empty = floor_colours()
    drawn = []
    for sid in scan_ids:
        names = [f"{sid}.png"] + ([f"{sid}_mani.png"] if mani else [])
        for name in names:
            path = os.path.join(render_dir, name)
            if not os.path.exists(path):
                fail(f"{render_type}: no render {name}")
            img = read_png(path)
            if img.shape != (256, 256, 3):
                fail(f"{render_type}: {name} has shape {img.shape}")
            px = img.reshape(-1, 1, 3)
            drawn.append(int((~(px == empty[None]).all(-1).any(-1)).sum()))
        if not glb:
            continue
        path = os.path.join(render_dir, f"{sid}_{render_type}.glb")
        if not os.path.exists(path):
            fail(f"{render_type}: no .glb for {sid}")
        pos, col = read_glb(path)
        if len(pos) <= 6:   # the floor plane is 2 triangles
            fail(f"{render_type}: the .glb of {sid} holds no object")
        again = native.rasterize_topdown(
            pos, np.arange(len(pos), dtype=np.int32).reshape(-1, 3),
            np.ascontiguousarray(col[::3]), width=256, height=256)
        if not np.array_equal(again, read_png(
                os.path.join(render_dir, f"{sid}.png"))):
            fail(f"{render_type}: the render of {sid} is not its .glb's "
                 "geometry")
    return drawn


def check_placement(render_dir, raw, stats, class_names,
                    render_type) -> tuple:
    """Each scene's `.glb` objects span the heights of its generated boxes
    and lie within their footprints, the boxes descaled here from the
    model's [-1, 1] output by the min-max formula (helpers/util.py:542-557;
    stats = min lhw, max lhw, min xyz, max xyz; xyz is the bottom centre):
    a box placed or descaled wrongly fails.  `raw` maps a scan id to (objs,
    sizes, translations).  Returns the least and the greatest of the
    descaled sizes and positions."""
    import numpy as np
    from echoscene_torch.eval.render import read_glb

    s = np.asarray(stats, np.float64)
    lo, hi = math.inf, -math.inf
    for sid, (objs, sizes, trans) in raw.items():
        size = (sizes + 1) / 2 * (s[3:6] - s[0:3]) + s[0:3]
        loc = (trans + 1) / 2 * (s[9:12] - s[6:9]) + s[6:9]
        shown = [i for i, c in enumerate(objs) if class_names[int(c)]
                 .rstrip("\n") not in ("_scene_", "lamp")]
        size, loc = size[shown], loc[shown]
        lo = min(lo, size.min(), loc.min())
        hi = max(hi, size.max(), loc.max())
        pos, _ = read_glb(os.path.join(render_dir,
                                       f"{sid}_{render_type}.glb"))
        obj = pos[6:].astype(np.float64)   # after the floor's 2 triangles
        tol = 1e-5 * max(np.abs(obj).max(), 1.0)
        bottom, top = loc[:, 1], loc[:, 1] + size[:, 1]
        want = (np.minimum(bottom, top).min(), np.maximum(bottom, top).max())
        got = (obj[:, 1].min(), obj[:, 1].max())
        if not np.allclose(got, want, rtol=0, atol=tol):
            fail(f"{render_type}: the objects of {sid} span heights {got}, "
                 f"its generated boxes {want}")
        # any yaw keeps a box within half its diagonal of its centre: each
        # vertex lies within that disc of one box
        reach = np.hypot(size[:, 0], size[:, 2]) / 2 + tol
        inside = np.zeros(len(obj), bool)
        for (x, z), r in zip(loc[:, [0, 2]], reach):
            inside |= np.hypot(obj[:, 0] - x, obj[:, 2] - z) <= r
        if not inside.all():
            fail(f"{render_type}: {int((~inside).sum())} object vertices of "
                 f"{sid} lie outside the footprints of its generated boxes")
    return float(lo), float(hi)


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
    import torch
    from echoscene_torch.benchmarks import NUM_OBJS, NUM_PREDS
    from echoscene_torch.data.clip_text import ClipTextEncoder
    from echoscene_torch.data.collate import CollateSpec
    from echoscene_torch.data.fake import make_fake_dataset
    from echoscene_torch.data.sgfront import SGFrontDataset
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.train.trainer import Trainer

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


def in_memory_sdf(path, res: int = 64):
    """A seeded analytic grid per SDF path, clamped as the dataset reader
    clamps (the card's machine has no h5py); zeros for None."""
    import zlib

    import numpy as np
    from echoscene_torch.benchmarks import analytic_sdf

    if path is None:
        return np.zeros((res, res, res, 1), np.float32)
    rng = np.random.default_rng(zlib.crc32(path.encode()))
    grid = analytic_sdf(int(rng.integers(3)), res, rng)
    return np.clip(grid, -0.2, 0.2)[..., None].astype(np.float32)


def vq_config():
    from echoscene_torch.train.vqvae_cli import load_vq_config
    return load_vq_config(os.path.join(ROOT, "configs", "vqvae_snet.yaml"))


def vq_train_path(card: str) -> dict:
    """Phase 9, VQ-VAE training at configs/vqvae_snet.yaml's widths (ch 64,
    ch_mult 1-2-4, 8192 codes, 64^3), batch 8, seeded weights and analytic
    SDFs: 3 f32 steps (JAX's default precision; K2 f32 counts set to 0 just
    before, read just after: 2 a step), one more under the profiler, 2 bf16
    steps (the second timed), and eval_iou over 64 grids (2 K2 launches a
    batch).  Returns the numbers and the f32 state."""
    import numpy as np
    import torch
    from echoscene_torch.benchmarks import profile_call
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.train.vqvae_trainer import VQVAETrainer

    cfg = vq_config()
    grids = np.stack([in_memory_sdf(f"vq/{i}") for i in range(64)])
    batches = [torch.from_numpy(grids[i:i + VQ_BATCH]).cuda()
               for i in range(0, 64, VQ_BATCH)]
    trainer = VQVAETrainer(cfg, device="cuda")
    state = trainer.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in state.module.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    step_ms, losses = [], []
    for i in range(3):
        t0 = time.perf_counter()
        logs = trainer.train_step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(logs["loss_total"].item())
    launches = dict(fa.LAUNCHES_BY_DTYPE)
    peak = torch.cuda.max_memory_allocated()
    if launches != {("stream_attention", "float32"): 6}:
        fail(f"3 f32 VQ-VAE steps launched {launches}, want K2 f32 6 (the "
             "encoder's and the decoder's mid attention, each step)")
    if not all(math.isfinite(x) for x in losses):
        fail(f"VQ-VAE losses not finite: {losses}")
    median = sorted(step_ms)[1]
    busy = profile_call(lambda: trainer.train_step(state, batches[3]),
                        trainer.device, median)

    bf16 = VQVAETrainer(cfg, compute_dtype="bfloat16", device="cuda")
    st16 = bf16.init(torch.Generator(device="cuda").manual_seed(0))
    bf16.train_step(st16, batches[0])
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    loss16 = bf16.train_step(st16, batches[1])["loss_total"].item()
    torch.cuda.synchronize()
    bf16_ms = (time.perf_counter() - t0) * 1e3
    launches16 = dict(fa.LAUNCHES_BY_DTYPE)
    if launches16 != {("stream_attention", "bfloat16"): 2}:
        fail(f"the bf16 VQ-VAE step launched {launches16}, want K2 bf16 2")
    if not math.isfinite(loss16):
        fail("the bf16 VQ-VAE loss is not finite")
    master = next(st16.module.parameters())
    if master.dtype != torch.float32:
        fail("bf16 VQ-VAE training must keep f32 masters")
    del bf16, st16

    fa.reset_launches()
    t0 = time.perf_counter()
    iou, iou_std = trainer.eval_iou(state, batches)
    torch.cuda.synchronize()
    iou_s = time.perf_counter() - t0
    iou_launches = dict(fa.LAUNCHES_BY_DTYPE)
    if iou_launches != {("stream_attention", "float32"): 2 * len(batches)}:
        fail(f"eval_iou over 64 grids launched {iou_launches}, want K2 f32 "
             f"{2 * len(batches)}")
    if not (0.0 <= iou <= 1.0 and math.isfinite(iou_std)):
        fail(f"eval_iou gave {iou} +- {iou_std}")
    res = {"params": n_params, "f32_step_ms": step_ms,
           "f32_median_ms": median, "f32_peak_gib": peak / 2**30,
           "f32_losses": losses, "busy_share": busy["busy_share"],
           "step_device_ms": busy["device_ms"],
           "step_kernel_launches": busy["kernel_launches"],
           "f32_launches_per_step": 2, "bf16_step_ms": bf16_ms,
           "bf16_loss": loss16, "eval_iou": iou, "eval_iou_std": iou_std,
           "eval_iou_s": iou_s, "eval_iou_launches": 2 * len(batches)}
    dev = ("not measured" if busy["device_ms"] is None else
           f"{busy['device_ms']:.1f} ms, busy share {busy['busy_share']:.3f}")
    print(f"VQ-VAE training ({n_params} parameters, batch {VQ_BATCH}, 64^3): "
          f"f32 steps {', '.join(f'{x:.1f}' for x in step_ms)} ms (median "
          f"{median:.1f}), peak memory {peak / 2**30:.2f} GiB; one f32 step "
          f"under the profiler: device {dev}, {busy['kernel_launches']} "
          f"kernel launches; K2 f32 "
          f"{launches[('stream_attention', 'float32')] // 3}"
          f" a step; bf16 step {bf16_ms:.1f} ms (K2 bf16 2); eval_iou over "
          f"64 grids {iou:.4f} +- {iou_std:.4f} in {iou_s:.2f} s [{card}]")
    return res, trainer, state


def check_k2_f32_backward(clock: float) -> dict:
    """Phase 9, K2 in f32 with a gradient at the VQ-VAE's shape: the
    forward is the f32 kernel, dq, dk, dv (the plain recompute
    differentiated) bit-equal to plain autograd's; times the kernel forward
    + plain backward beside the plain forward + backward, SDPA f32 forward
    + backward with TF32 off, and the bound of forward + backward: the
    forward's products three times over (two products forward, four
    backward), its exp2 once, and 8 tensors' bytes (q, k, v, dO in; O, dq,
    dk, dv out)."""
    import torch
    import torch.nn.functional as F
    from echoscene_torch.kernels import flash_attention as fa

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the f32 yardsticks would not be f32")
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, g = (torch.randn(VQ_GRAD_SHAPE, generator=gen, device="cuda")
                  for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fa.reset_launches()
    out = fa.stream_attention(*leaves)
    if type(out.grad_fn).__name__ != "KernelAttentionBackward":
        fail(f"K2 f32 output grad_fn {out.grad_fn}, want the Function")
    got = torch.autograd.grad(out, leaves, g)
    if fa.LAUNCHES_BY_DTYPE != {("stream_attention", "float32"): 1}:
        fail(f"K2 f32 forward + backward launched {fa.LAUNCHES_BY_DTYPE}")
    ref = fa.attention_plain(q, k, v)
    ratios = fa.error_ratios(out.detach(), ref)
    if not max(ratios) <= 1.0:
        fail(f"K2 f32 with a gradient: max / mean err at {ratios[0]:.3f} / "
             f"{ratios[1]:.3f} of their limits")
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(*plain), plain, g)
    if not all(a.dtype == torch.float32 and torch.equal(a, b)
               for a, b in zip(got, want)):
        diffs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        fail(f"K2 f32 dq, dk, dv differ from plain autograd's by {diffs}")

    def fwd_bwd(fn, xs, gx):
        return lambda: torch.autograd.grad(fn(*xs), xs, gx)

    ms = cuda_ms(fwd_bwd(fa.stream_attention, leaves, g), iters=5)
    plain_ms = cuda_ms(fwd_bwd(fa.attention_plain, plain, g), iters=3,
                       warmup=1)
    tr = [x.detach().transpose(1, 2).contiguous().requires_grad_(True)
          for x in (q, k, v)]
    library_ms = cuda_ms(fwd_bwd(F.scaled_dot_product_attention, tr,
                                 g.transpose(1, 2).contiguous()), iters=5)
    fwd = fa.attention_bound(*VQ_GRAD_SHAPE, sm_clock_hz=clock,
                             dtype=torch.float32)
    products = 3 * min(fwd["fma_ms"], fwd["tf32x3_ms"])
    parts = {"operations": max(products, fwd["exp2_ms"]),
             "bytes": 2 * fwd["bytes_ms"]}
    by = max(parts, key=parts.get)
    return {"name": "stream_attention_f32_train", "route": "cuda",
            "dtype": "float32",
            "source": f"echoscene_torch/csrc/{fa.SOURCE_F32}",
            "replaces": "echoscene_tpu/kernels/flash_attention.py:35",
            "launches": None, "max_abs_err": (out.detach() - ref).abs().max(
                ).item(), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": parts[by], "bound_by": by, "library_ms": library_ms,
            "shape": list(VQ_GRAD_SHAPE), "what": "forward (the f32 kernel) "
            "+ KernelAttention's plain backward, the VQ-VAE training site",
            "forward_bound_ms": fwd["ms"], "grad_bit_equal": True,
            "share_of_bound": parts[by] / ms, "vs_library": ms / library_ms,
            "err_of_limit": ratios}


def check_tiny_vq_against_cpu() -> dict:
    """Phase 9: one tiny VQ-VAE f32 step on the card and on the CPU from
    the same weights and batch (the mid attention's 512 tokens take K1 f32
    on the card): the loss within LOSS_RTOL, each gradient leaf within
    VQ_LEAF_RTOL of its own peak + 1e-7, then Adam on each from the CPU's
    gradients, parameters within PARAM_ATOL."""
    import numpy as np
    import torch
    from echoscene_torch.models.config import VQVAEConfig
    from echoscene_torch.train.vqvae_trainer import VQVAETrainer

    cfg = VQVAEConfig(n_embed=64, ch=8, ch_mult=(1, 2), resolution=16)
    x = torch.from_numpy(np.stack([in_memory_sdf(f"tiny/{i}", 16)
                                   for i in range(4)]))
    runs = []
    for device in ("cpu", "cuda"):
        tr = VQVAETrainer(cfg, lr=1e-3, device=device)
        st = tr.init(torch.Generator().manual_seed(0) if device == "cpu"
                     else torch.Generator(device="cuda").manual_seed(0))
        if runs:
            st.module.load_state_dict(runs[0][1].module.state_dict())
        loss, _ = tr.loss_fn(st.module, x.to(device))
        loss.backward()
        grads = [p.grad.detach().cpu() for p in st.module.parameters()]
        runs.append((tr, st, loss.item(), grads))
    (_, cpu, loss_c, grads_c), (_, card, loss_g, grads_g) = runs
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    names = [n for n, _ in cpu.module.named_parameters()]
    errs = [((a - b).abs().max().item(), b.abs().max().item())
            for a, b in zip(grads_g, grads_c)]
    bad = [n for n, (e, peak) in zip(names, errs)
           if not e <= VQ_LEAF_RTOL * peak + 1e-7]
    # a convolution bias ahead of a GroupNorm gets a gradient that cancels
    # to rounding noise: the + 1e-7 covers it, the report leaves it out
    worst = max(e / peak for e, peak in errs if peak > 1e-6)
    if not (loss_rel <= LOSS_RTOL and not bad):
        fail(f"tiny VQ-VAE step, CUDA vs CPU: loss rel err {loss_rel:.3e}; "
             f"gradient leaves off by more than {VQ_LEAF_RTOL} of their "
             f"peak: {bad[:8]} (largest {worst:.3e})")
    for st in (cpu, card):
        for p, gc in zip(st.module.parameters(), grads_c):
            p.grad = gc.to(p.device)
        st.optimizer.step()
    param_err = max((a.detach().cpu() - b.detach()).abs().max().item()
                    for a, b in zip(card.module.parameters(),
                                    cpu.module.parameters()))
    if not param_err <= PARAM_ATOL:
        fail(f"Adam on the CPU's gradients: parameters differ by "
             f"{param_err:.3e} between CUDA and CPU (limit {PARAM_ATOL})")
    return {"loss_rel_err": loss_rel, "grad_err_of_own_peak": worst,
            "param_abs_err_after_adam": param_err}


def fast_profile_yaml(tmp: str) -> str:
    """A copy of configs/full_mp.yaml at the fast profile (DPM++ 50 layout
    / 20 shape steps) in `tmp`, its nested configs named by absolute path;
    configs/ is left as it is."""
    import yaml

    cfg_dir = os.path.join(ROOT, "configs")
    with open(os.path.join(cfg_dir, "full_mp.yaml")) as f:
        root = yaml.safe_load(f)
    dk = root["layout_branch"]["diffusion_kwargs"]
    dk["sampler"], dk["sample_steps"] = "dpmpp", 50
    sb = root["shape_branch"]
    sb["sampler"], sb["ddim_steps"] = "dpmpp", 20
    for key in ("df_cfg", "vq_cfg"):
        sb[key] = os.path.join(cfg_dir, sb[key])
    path = os.path.join(tmp, "full_mp_fast.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(root, f)
    return path


class RecordingWriter:
    """A TensorBoard-shaped writer that keeps what it is given."""

    def __init__(self):
        self.images, self.scalars = [], []

    def add_image(self, tag, img, step):
        self.images.append((tag, tuple(img.shape), step))

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))


def pipeline_path(sg, vq_trainer, vq_state, card: str) -> dict:
    """Phase 9, the pipeline a user runs: the VQ-VAE checkpoint (the VQ
    CLI's writer) -> precompute_latents over a fake dataset's SDF paths
    (analytic 64^3 grids by path; K2 f32 = one a batch, counted) -> the
    cache file -> `train.cli.main` at full_mp.yaml width in bf16 with
    --vq_ckpt, --latent_cache and one preview (4 steps; counts set to 0
    just before, read just after: K1 = 10 a step + 5 x 20 for the preview,
    K2 = 0 a step + one per decode chunk of the preview's rows); then the
    same step on the phase-4 model from a latent batch, timed as phase 7
    times its step (K1 10, K2 0 a step)."""
    import numpy as np
    import torch
    from echoscene_torch.benchmarks import (profile_call, synthetic_batch,
                                            time_train_step)
    from echoscene_torch.core.graphbatch import ShapeSelection
    from echoscene_torch.data.clip_text import ClipTextEncoder
    from echoscene_torch.data.fake import make_fake_dataset
    from echoscene_torch.data.sgfront import SGFrontDataset
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.train import cli as train_cli
    from echoscene_torch.train import latents
    from echoscene_torch.train.checkpoint import save_vqvae_checkpoint

    res = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        vq_path = os.path.join(tmp, "vq", "epoch-best")
        save_vqvae_checkpoint(vq_path, vq_state)
        root = make_fake_dataset(os.path.join(tmp, "data"), num_scenes=16,
                                 min_objs=3, max_objs=5, with_sdf=False,
                                 seed=1)
        ds = SGFrontDataset(root, use_sdf=True, with_changes=False,
                            shuffle_objs=False, clip=ClipTextEncoder("hash"))
        paths = latents.dataset_sdf_paths(ds)
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        cache = latents.precompute_latents(vq_state.module, paths,
                                           in_memory_sdf, batch=VQ_BATCH,
                                           device="cuda")
        res["precompute_s"] = time.perf_counter() - t0
        want = {("stream_attention", "float32"):
                math.ceil((len(paths) + 1) / VQ_BATCH)}
        if dict(fa.LAUNCHES_BY_DTYPE) != want:
            fail(f"precompute_latents over {len(paths)} paths launched "
                 f"{dict(fa.LAUNCHES_BY_DTYPE)}, want {want}")
        if not (set(cache) == set(paths) | {"__zero__"} and all(
                z.shape == (16, 16, 16, 3) and z.dtype == np.float32
                and np.isfinite(z).all() for z in cache.values())):
            fail("the latent cache is not f32 (16, 16, 16, 3) per path")
        npz = os.path.join(tmp, "latent_cache.npz")
        latents.write_latent_cache(npz, cache)
        res.update(precompute_paths=len(paths),
                   precompute_launches=want[("stream_attention", "float32")])
        del vq_trainer, vq_state
        torch.cuda.empty_cache()

        exp = os.path.join(tmp, "exp")
        writer = RecordingWriter()
        steps, nodes = 4, 8 * 16
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        state = train_cli.main([
            "--dataset", root, "--exp", exp, "--with_SDF", "True",
            "--diff_yaml", fast_profile_yaml(tmp), "--batchSize", "8",
            "--diffusion_bs", "8", "--nepoch", "3", "--max_steps",
            str(steps), "--preview_every", str(steps), "--clip_backend",
            "hash", "--vq_ckpt", vq_path, "--latent_cache", npz,
            "--device", "cuda"], writer=writer)
        torch.cuda.synchronize()
        res["cli_s"] = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES_BY_DTYPE)
        want = {("onepass_attention", "bfloat16"): 10 * steps + 5 * 20,
                ("stream_attention", "bfloat16"): nodes // 8}
        if state.step != steps or launches != want:
            fail(f"train.cli took {state.step} steps and launched "
                 f"{launches}, want {steps} steps and {want} (K1 10 a step "
                 "and 5 x 20 for the preview; K2 0 a step and one per "
                 "decode chunk of the preview)")
        images = [(tag, shp, step) for tag, shp, step in writer.images]
        if images != [(f"gen_shape_{i}", (3, 256, 256), steps)
                      for i in range(2)]:
            fail(f"the preview logged {images}, want gen_shape_0 and "
                 f"gen_shape_1 at step {steps}, once")
        if not all(bool(torch.isfinite(p).all())
                   for group in state.optimizer.param_groups
                   for p in group["params"]):
            fail("train.cli left non-finite parameters")
        res.update(cli_steps=steps, cli_launches={
            f"{k[0]}/{k[1]}": c for k, c in launches.items()},
            preview_images=len(images),
            checkpoints=sorted(os.listdir(os.path.join(exp, "checkpoint"))))
        del state
    torch.cuda.empty_cache()

    # the joint step from latents on the phase-4 model, as phase 7 times
    # its step from SDFs: phase 7's batch with the frozen encoder's latents
    # of its SDFs in place of the grids
    batch = synthetic_batch(8, 48, 112, seed=0, diffusion_bs=8,
                            sdf_res=64).to("cuda")
    with torch.no_grad():
        lat = sg.module.vqvae.encode_no_quant(batch.shapes.sdf).float()
    batch = dataclasses.replace(batch, shapes=ShapeSelection(
        sdf=None, latent=lat, num_valid=batch.shapes.num_valid,
        indices=batch.shapes.indices, mp_valid=batch.shapes.mp_valid))
    state = sg.init_train_state()
    torch.cuda.synchronize()
    fa.reset_launches()
    k = 8
    sps, step_s, losses = time_train_step(sg, state, batch, 8, k=k)
    launches = dict(fa.LAUNCHES)
    if launches != {"onepass_attention": 10 * (k + 1),
                    "stream_attention": 0}:
        fail(f"the joint step from latents launched {launches} in {k + 1} "
             "steps, want K1 10 and K2 0 a step")
    if not bool(torch.isfinite(losses).all()):
        fail("the joint step from latents gave non-finite losses")
    gen = torch.Generator(device="cuda").manual_seed(29)
    busy = profile_call(lambda: sg.train_step(state, batch, gen), sg.device,
                        step_s * 1e3)
    res.update(cache_step_ms=step_s * 1e3, cache_scenes_per_sec=sps,
               cache_step_launches={"onepass_attention": 10,
                                    "stream_attention": 0},
               cache_step_device_ms=busy["device_ms"],
               cache_step_busy_share=busy["busy_share"],
               cache_step_kernel_launches=busy["kernel_launches"])
    print(f"pipeline: VQ checkpoint -> precompute_latents over "
          f"{res['precompute_paths']} SDFs in {res['precompute_s']:.2f} s "
          f"(K2 f32 {res['precompute_launches']}) -> train.cli with "
          f"--latent_cache, --vq_ckpt and one preview at the fast profile: "
          f"{steps} steps in {res['cli_s']:.1f} s with model build, saves "
          f"and preview, launches {json.dumps(res['cli_launches'])}, "
          f"{len(images)} preview images; the joint step from latents on the "
          f"phase-4 model {step_s * 1e3:.3f} ms ({sps:.4f} train scenes/sec; "
          f"K1 10, K2 0 a step; one step under the profiler: device "
          f"{busy['device_ms']} ms, {busy['kernel_launches']} kernel "
          f"launches) [{card}]")
    return res, state


def checkpoint_path(sg, state, card: str) -> dict:
    """Phase 9, checkpoints at full width: a background save (the blocking
    part, then the whole write) with one parameter changed in place right
    after it returns, restored into a model with other weights: the change
    absent, everything else bit-exact; then a synchronous save, timed."""
    import torch
    from echoscene_torch.benchmarks import NUM_OBJS, NUM_PREDS
    from echoscene_torch.models.sgdiff import SGDiff
    from echoscene_torch.train.checkpoint import (restore_checkpoint,
                                                  save_checkpoint,
                                                  wait_for_checkpoints)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "checkpoint", "model1")
        name, param = next(iter(sg.module.layout_denoiser.named_parameters()))
        before = param.detach().clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, sg, state, wait=False)
        blocking_s = time.perf_counter() - t0
        with torch.no_grad():
            param.add_(1.0)
        wait_for_checkpoints()
        whole_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        torch.manual_seed(1)
        other = SGDiff(sg.cfg, NUM_OBJS, NUM_PREDS, device="cuda")
        st2 = restore_checkpoint(path, other, other.init_train_state())
        restored = dict(other.module.named_parameters())[
            f"layout_denoiser.{name}"]
        if not torch.equal(restored, before):
            fail("the background save holds a change made after it returned")
        with torch.no_grad():
            param.copy_(before)
        a, b = sg.module.state_dict(), other.module.state_dict()
        same = a.keys() == b.keys() and all(torch.equal(a[x], b[x]) for x in a)
        oa, ob = state.optimizer.state_dict(), st2.optimizer.state_dict()
        same = same and oa["state"].keys() == ob["state"].keys() and all(
            torch.equal(v, ob["state"][i][key])
            for i, st in oa["state"].items() for key, v in st.items())
        if not (same and st2.step == state.step):
            fail("the background save's round trip is not bit-exact")
        del other, st2, a, b, oa, ob
        torch.cuda.empty_cache()
        os.remove(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, sg, state)
        sync_s = time.perf_counter() - t0
    print(f"checkpoint ({size / 1e9:.2f} GB): background save blocks "
          f"{blocking_s:.3f} s, its write done after {whole_s:.3f} s; "
          f"restored bit-exact without the change made after it returned; "
          f"synchronous save {sync_s:.3f} s [{card}]")
    return {"bytes": size, "background_blocking_s": blocking_s,
            "background_whole_s": whole_s, "sync_s": sync_s}


INCEPTION_BATCH = 64          # phase 10's feature throughput batch
FEAT_RTOL = 1e-4              # Inception features, card vs CPU, of the peak


def image_path(sg, card: str) -> dict:
    """Phase 10, the image metrics on the phase-4 model: GT box renders of
    the fake test split (`eval.gt_renders`); layout-only `SceneEvaluator`
    runs at DPM++ 50 with the onlybox, retrieval (a cat_jid table of OBJ
    boxes) and txt2shape (a directory of PLY meshes) render types, and a
    relationship run of onlybox for the overlay, each with K1 = K2 = K4 = 0
    (counts set to 0 just before each run, read just after, and banked
    into the phase's counts, which are returned);
    FID-InceptionV3 at full width on the card from seeded weights written
    as JAX's .npz under build/, against the same module on the CPU on 4
    renders; `fid_cli` over the onlybox renders against the GT renders;
    the feature throughput at batch 64 of 299^2 and its peak memory."""
    import numpy as np
    import torch
    from echoscene_torch import native
    from echoscene_torch.benchmarks import NUM_OBJS, NUM_PREDS, analytic_sdf
    from echoscene_torch.data.clip_text import ClipTextEncoder
    from echoscene_torch.data.collate import CollateSpec
    from echoscene_torch.data.fake import make_fake_dataset
    from echoscene_torch.data.sgfront import SGFrontDataset
    from echoscene_torch.eval import fid_cli, gt_renders
    from echoscene_torch.eval.evaluator import SceneEvaluator
    from echoscene_torch.eval.fid import get_extractor, load_image_dir
    from echoscene_torch.eval.inception_fid import (InceptionExtractor,
                                                    conv_flops, conv_specs)
    from echoscene_torch.eval.render import box_mesh, export_obj, export_ply
    from echoscene_torch.eval.retrieval import MeshResultsDir, SizeDatabase
    from echoscene_torch.kernels import chamfer as k4
    from echoscene_torch.kernels import flash_attention as fa

    # every launch of the phase, banked before each run's own reset
    launches = {f"{name}/{dtype}": 0 for name in fa.LAUNCHES
                for dtype in ("bfloat16", "float32")}
    launches["nn_distance"] = 0

    def bank():
        for (name, dtype), n in fa.LAUNCHES_BY_DTYPE.items():
            launches[f"{name}/{dtype}"] = launches.get(f"{name}/{dtype}",
                                                       0) + n
        launches["nn_distance"] += k4.LAUNCHES["nn_distance"]
        fa.reset_launches()
        k4.reset_launches()

    fa.reset_launches()
    k4.reset_launches()
    secs = {}
    cfg = sg.cfg
    cfg.layout_diffusion.sampler, cfg.layout_diffusion.sample_steps = (
        "dpmpp", 50)
    sg.layout_fast_tables["dpmpp"] = sg.layout_diff.make_dpmpp_tables(50)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        # (a) GT renders of the fake test split (boxes: no h5py here)
        t0 = time.perf_counter()
        root = make_fake_dataset(os.path.join(tmp, "data"), num_scenes=8,
                                 min_objs=3, max_objs=6, with_sdf=False,
                                 seed=0)
        gt_dir = os.path.join(tmp, "gt")
        n_gt = gt_renders.main(["--dataset", root, "--out", gt_dir])
        secs["gt_renders"] = time.perf_counter() - t0
        ds_kw = dict(split="test", shuffle_objs=False, use_sdf=False,
                     clip=ClipTextEncoder("hash"), seed=47)
        ds = SGFrontDataset(root, with_changes=False, **ds_kw)
        if (len(ds.classes), len(ds.pred_names)) != (NUM_OBJS, NUM_PREDS):
            fail("the fake vocabulary does not match the flagship model's")
        scan_ids = [ds[i].scan_id for i in range(len(ds))]
        if n_gt != len(scan_ids):
            fail(f"gt_renders wrote {n_gt} renders for {len(scan_ids)} "
                 "test scenes")
        # GT boxes lie inside the box stats: every GT render shows objects
        drawn = {"gt": check_renders(gt_dir, scan_ids, "gt", glb=False)}
        if not all(drawn["gt"]):
            fail(f"a GT render shows nothing besides the floor: "
                 f"{drawn['gt']}")

        # (b) the mesh sources: a size table of OBJ boxes, PLY results
        names = sorted({n.strip() for n in ds.vocab["object_idx_to_name"]})
        table, rng = {}, np.random.default_rng(10)
        for n in names:
            table[n] = {}
            for k in range(2):
                size = rng.uniform(0.4, 1.6, 3).round(3)
                jid = f"{n}-{k}"
                table[n][jid] = size.tolist()
                d = os.path.join(tmp, "future", "3D-FUTURE-model", jid)
                os.makedirs(d)
                v, f = box_mesh([*size, 0, 0, 0, 0])
                export_obj(os.path.join(d, "raw_model.obj"), v, f)
        table_path = os.path.join(tmp, "future", "cat_jid_trainval.json")
        with open(table_path, "w") as f:
            json.dump(table, f)
        for k, n in enumerate(names):
            d = os.path.join(tmp, "txt2shape", n)
            os.makedirs(d)
            v, f = native.marching_cubes(analytic_sdf(k % 3, 32, rng))
            export_ply(os.path.join(d, "res0.ply"), v, f)
        spec = CollateSpec(max_nodes=48, max_triples=160, max_scenes=8,
                           diffusion_bs=48, with_sdf=False)
        runs = (("onlybox", "none", {}),
                ("retrieval", "none",
                 {"mesh_db": SizeDatabase(table_path)}),
                ("txt2shape", "none",
                 {"txt2shape_db": MeshResultsDir(
                     os.path.join(tmp, "txt2shape"))}),
                ("onlybox", "relationship", {}))
        dirs = {}
        for render_type, etype, dbs in runs:
            key = f"{render_type}/{etype}"
            dirs[key] = os.path.join(tmp, "gen", render_type + "_" + etype)
            ev = SceneEvaluator(sg, spec, ds.box_stats, gen_shape=False,
                                store_path=os.path.join(tmp, "store", key),
                                eval_batch=8, render_dir=dirs[key],
                                render_type=render_type, export_glb=True,
                                **dbs)
            ds_e = (ds if etype == "none" else SGFrontDataset(
                root, with_changes=True, eval_mode=True, eval_type=etype,
                **ds_kw))
            bank()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev.run(ds_e, etype, 0,
                   torch.Generator(device="cuda").manual_seed(47))
            torch.cuda.synchronize()
            secs[key] = time.perf_counter() - t0
            got = {**dict(fa.LAUNCHES), **dict(k4.LAUNCHES)}
            if any(got.values()):
                fail(f"layout-only {key} launched {got}, want no K1 / K2 / "
                     "K4")
            # a manipulated reader may drop a scene it cannot change, and
            # its draws advance with every read: take the scenes rendered
            ids = sorted(f[:-4] for f in os.listdir(dirs[key])
                         if f.endswith(".png") and not f.endswith("_mani.png"))
            if (ids != sorted(scan_ids) if etype == "none" else not ids):
                fail(f"{key} rendered {ids} of the test scenes {scan_ids}")
            drawn[key] = check_renders(dirs[key], ids, render_type,
                                       mani=etype != "none")
            # the short DPM++ chain keeps boxes near the room: a generated
            # scene in view
            if not any(drawn[key]):
                fail(f"{key}: no render draws anything besides the floor: "
                     f"{drawn[key]}")
            if render_type in ("retrieval", "txt2shape"):
                meshes = os.path.join(dirs[key], "object_meshes")
                if not (os.path.isdir(meshes) and os.listdir(meshes)):
                    fail(f"{key} exported no object meshes")

        # (c) FID-InceptionV3 at full width, seeded weights as JAX's .npz
        t0 = time.perf_counter()
        wrng = np.random.default_rng(0)
        params = {}
        for sp in conv_specs():
            kh, kw = sp["k"]
            fan = sp["cin"] * kh * kw
            n = sp["name"]
            params[f"{n}.kernel"] = wrng.normal(
                0, np.sqrt(2.0 / fan),
                (kh, kw, sp["cin"], sp["cout"])).astype(np.float32)
            params[f"{n}.scale"] = wrng.uniform(
                0.5, 1.5, sp["cout"]).astype(np.float32)
            params[f"{n}.bias"] = wrng.normal(
                0, 0.1, sp["cout"]).astype(np.float32)
        npz = os.path.join(tmp, "inception.npz")
        np.savez(npz, **params)
        ext = get_extractor(f"inception:{npz}", device="cuda")
        if not (isinstance(ext, InceptionExtractor)
                and ext.device.type == "cuda"):
            fail(f"inception:{npz} gave {type(ext).__name__}, not the port's "
                 "Inception module on the card")
        n_params = sum(p.numel() for p in ext.net.parameters())
        torch.cuda.synchronize()
        secs["inception_build"] = time.perf_counter() - t0

        # (d) card against CPU features of the same module on 4 renders
        t0 = time.perf_counter()
        imgs = load_image_dir(dirs["onlybox/none"])[:4]
        got = ext(imgs)
        want = InceptionExtractor(params, "cpu")(imgs)
        feat_err = float(np.abs(got - want).max() / np.abs(want).max())
        if not (np.isfinite(got).all() and got.shape == (len(imgs), 2048)
                and feat_err <= FEAT_RTOL):
            fail(f"Inception features on the card {got.shape}: max err "
                 f"{feat_err:.3e} of the peak against the CPU (limit "
                 f"{FEAT_RTOL})")
        secs["card_vs_cpu"] = time.perf_counter() - t0

        # (e) FID / KID of the onlybox renders against the GT renders
        t0 = time.perf_counter()
        res = fid_cli.main([
            "--path_to_real_renderings", gt_dir,
            "--path_to_synthesized_renderings", dirs["onlybox/none"],
            "--extractor", f"inception:{npz}", "--device", "cuda"])
        secs["fid_cli"] = time.perf_counter() - t0
        n_files = [len([f for f in os.listdir(d) if f.endswith(".png")])
                   for d in (gt_dir, dirs["onlybox/none"])]
        if not (math.isfinite(res["fid"]) and math.isfinite(res["kid"])
                and [res["n_real"], res["n_fake"]] == n_files):
            fail(f"fid_cli gave {res}, with {n_files} render files")

    # (f) feature throughput at batch 64 of 299^2, with its peak memory
    t0 = time.perf_counter()
    batch = torch.randint(0, 256, (INCEPTION_BATCH, 299, 299, 3),
                          dtype=torch.uint8, device="cuda",
                          generator=torch.Generator(device="cuda"
                                                    ).manual_seed(0))
    ext.features(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = cuda_ms(lambda: ext.features(batch), iters=5)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    secs["throughput"] = time.perf_counter() - t0
    bank()
    flops = conv_flops(299) * INCEPTION_BATCH
    out = {"n_gt": n_gt, "drawn_pixels": drawn, "launches": launches,
           "inception_params": n_params, "feat_err_of_peak": feat_err,
           "fid": res, "batch_ms": ms,
           "images_per_s": INCEPTION_BATCH / (ms / 1e3),
           "conv_tflops": flops / (ms / 1e3) / 1e12,
           "f32_bound_ms": flops / 67e12 * 1e3,
           "peak_gib_above_weights": peak, "seconds": secs}
    del ext, batch
    torch.cuda.empty_cache()
    return out


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
    sources = (fa.SOURCE, fa.SOURCE_F32, BASELINE_SOURCE, F32_SIMT_SOURCE,
               k4.SOURCE, K4_DIRECT_SOURCE)
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
                         (8, 4096, 1, 256),
                         [(2, 77, 3, 200), (3, 129, 2, 256), (2, 300, 2, 8)],
                         "echoscene_tpu/kernels/flash_attention.py:35",
                         clock)]
    for e in f32_entries:
        d = e["bound_detail"]
        print(f"kernel {e['name']} {e['shape']} f32: {e['ms']:.4f} ms "
              f"(pre-pass {e['prepass_ms']:.4f} of it), {e['tflops']:.2f} "
              f"TFLOP/s, {e['share_of_bound']:.3f} of the f32 bound "
              f"{e['bound_ms']:.4f} ms (by {d['by']}: 3xTF32 "
              f"{d['tf32x3_ms']:.4f}, f32 FMA {d['fma_ms']:.4f}, exp2 "
              f"{d['exp2_ms']:.4f}, bytes {d['bytes_ms']:.4f}); sdpa f32 "
              f"(TF32 off) {e['library_ms']:.4f} ms ({e['vs_library']:.3f} "
              f"x its time), earlier f32 FMA design {e['earlier_ms']:.4f} "
              f"ms ({e['earlier_ms'] / e['ms']:.2f} x this), plain "
              f"{e['plain_ms']:.3f} ms; host "
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

    # 9. the training pipeline: VQ-VAE training at vqvae_snet.yaml width,
    # K2 f32 with a gradient, a tiny VQ-VAE step card vs CPU, VQ checkpoint
    # -> latent cache -> train.cli with --latent_cache and a preview, and
    # background checkpoint saves at full width
    t0 = time.perf_counter()
    vq, vq_trainer, vq_state = vq_train_path(card)
    k2_train = check_k2_f32_backward(clock)
    k2_train["launches"] = 3 * vq["f32_launches_per_step"]
    k2_train.update(launches_per_vq_step=vq["f32_launches_per_step"],
                    eval_iou_launches_per_batch=2)
    print(f"kernel {k2_train['name']} {k2_train['shape']}: forward + "
          f"backward {k2_train['ms']:.4f} ms, {k2_train['share_of_bound']:.3f}"
          f" of its bound {k2_train['bound_ms']:.4f} ms (by "
          f"{k2_train['bound_by']}; the forward's bound "
          f"{k2_train['forward_bound_ms']:.4f}); sdpa f32 forward + backward"
          f" (TF32 off) {k2_train['library_ms']:.4f} ms "
          f"({k2_train['vs_library']:.3f} x its time), plain forward + "
          f"backward {k2_train['plain_ms']:.4f} ms; dq, dk, dv bit-equal to "
          f"plain autograd's; forward max / mean err at "
          f"{k2_train['err_of_limit'][0]:.3f} / "
          f"{k2_train['err_of_limit'][1]:.3f} of the f32 limits [{card}]")
    tiny_vq = check_tiny_vq_against_cpu()
    print(f"tiny VQ-VAE step, CUDA vs CPU: {json.dumps(tiny_vq)}")
    pipe, state = pipeline_path(sg, vq_trainer, vq_state, card)
    del vq_trainer, vq_state
    print(f"joint step (bf16, diffusion_bs 8): from latents "
          f"{pipe['cache_step_ms']:.3f} ms, device "
          f"{pipe['cache_step_device_ms']} ms, {pipe['cache_step_kernel_launches']} launches (K1 10, K2 0 a "
          f"step); from SDFs through the frozen encoder "
          f"{tr['ms_per_step']:.3f} ms, device {tr['step_device_ms']} ms, "
          f"{tr['step_kernel_launches']} launches (phase 7; K1 10, K2 1) "
          f"[{card}]")
    ck = checkpoint_path(sg, state, card)
    del state
    for e in f32_entries[1:]:
        e.update(vq_train_launches_per_step=vq["f32_launches_per_step"],
                 eval_iou_launches_per_batch=2,
                 precompute_launches=pipe["precompute_launches"])
    for e in entries[:2]:
        e["cache_train_launches_per_step"] = pipe["cache_step_launches"][
            e["name"]]
    details = {"vq": vq, "tiny_vq": tiny_vq, "pipeline": pipe,
               "checkpoint": ck}
    print(f"pipeline details: {json.dumps(details)}; phase 9 took "
          f"{time.perf_counter() - t0:.1f} s")

    # 10. the image metrics: GT renders, the layout-only render types with
    # the overlay, FID-InceptionV3 on the card against the CPU, fid_cli,
    # the feature throughput
    t0 = time.perf_counter()
    im = image_path(sg, card)
    by_wrapper = {"onepass_attention": "onepass_attention/bfloat16",
                  "stream_attention": "stream_attention/bfloat16",
                  "onepass_attention_f32": "onepass_attention/float32",
                  "stream_attention_f32": "stream_attention/float32",
                  "stream_attention_f32_train": "stream_attention/float32",
                  "nn_distance": "nn_distance"}
    for e in entries + f32_entries + [k2_train]:
        e["image_metrics_launches"] = im["launches"][by_wrapper[e["name"]]]
    print(f"image metrics: {im['n_gt']} GT renders and the onlybox, "
          f"retrieval, txt2shape and onlybox-relationship renders of the "
          f"test split, layout-only at DPM++ 50 (K1 = K2 = K4 = 0 in each), "
          f"wall seconds {json.dumps(im['seconds'])}; kernel launches in "
          f"the whole phase {json.dumps(im['launches'])} [{card}]")
    print(f"FID-InceptionV3 ({im['inception_params']} parameters, seeded "
          f"weights): batch {INCEPTION_BATCH} of 299^2 in "
          f"{im['batch_ms']:.3f} ms, {im['images_per_s']:.1f} images/sec, "
          f"{im['conv_tflops']:.2f} TFLOP/s of convolutions (f32 bound at "
          f"67 TFLOP/s {im['f32_bound_ms']:.3f} ms), peak memory "
          f"{im['peak_gib_above_weights']:.3f} GiB above the weights; card "
          f"vs CPU features max err {im['feat_err_of_peak']:.3e} of the "
          f"peak [{card}]")
    print(f"fid_cli (seeded weights, no FID of the paper): FID "
          f"{im['fid']['fid']:.6g}, KID {im['fid']['kid']:.6g} over "
          f"{im['fid']['n_real']} GT / {im['fid']['n_fake']} generated "
          f"renders")
    print(f"image details: {json.dumps(im)}; phase 10 took "
          f"{time.perf_counter() - t0:.1f} s")
    entries[2:2] = f32_entries + [k2_train]
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
