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
       TFLOP/s, share of the bound, the ratio to the yardstick, the host time
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
       share of the bound and the host
       time of one wrapper call;
     * K1 / K2 on f32 inputs (f32 sampling and training), the 3xTF32
       kernel (`csrc/flash_attention_tf32x3.cu`) at the same shapes and
       ragged ones (D 8 to 256): against the plain version in f32, max abs
       error <= 2^-14 of the plain output's peak and mean abs error <= 1e-5
       of its mean magnitude, a tolerance that must reject the plain
       version with its last 32 keys left out; times beside the f32 bound
       (three TF32 products per product at 495 TFLOP/s, exp2, 4-byte
       elements; the f32 FMA route at 67 TFLOP/s beside it), its pre-pass
       alone, SDPA in f32 with TF32 off, the plain
       version and the host time of one wrapper call;
     * K1 / K2 at the training step's shapes ((8, 1024, 8, 56), the VQ
       encoder's (8, 4096, 1, 256)), a tp rank's (8, 1024, 4, 56), the
       ragged (2, 333, 8, 56) and (2, 77, 3, 200), a D_pad 128 shape
       (1, 200, 2, 128), one with fewer backward tiles than SMs
       (3, 301, 2, 256) and one whose tiles lie a few past a multiple of
       132 (1, 250, 67, 56) through the
       differentiable Function, whose bf16 backward is the hand kernel of
       `csrc/flash_attention_bwd.cu` (no TPU counterpart: JAX's `_fa_bwd`
       is XLA): one forward and one backward launch; dq, dk, dv within the
       bf16 limits of `error_ratios` against plain autograd through
       `attention_plain` from the same inputs and upstream gradient, a max
       error against float64 within GRAD_F64_FACTOR (2) times plain
       autograd's, dq with the last 32 keys left out failing both limits,
       two runs bit-equal, the forward's lse against
       `attention_plain_lse` and its output bit-equal to the forward
       without lse; phase 1 fails if the backward's ptxas report shows a
       spill; times the kernel forward + backward, the backward kernel
       alone and the host time of one `attention_backward` call, the plain
       forward + backward and backward alone, SDPA's forward + backward
       and its backward alone, beside the bounds
       (`attention_backward_bound` for the backward alone);
     * Q1 / Q2 (the int8 W8A8 convolution, `csrc/int8_conv.cu`, hand
       kernels with no TPU counterpart) at each of the 33 distinct
       convolutions of the flagship's int8 torso at the main path's rows
       (`int8_conv.torso_conv_sites`: conv_in, the ResBlocks' 3x3x3 and
       1x1x1 convolutions on the concatenated inputs, the strided
       Downsamples, the factored upsamples' (3, 2, 2) sub-convolutions,
       the output conv) and a ragged case: Q1 bit-equal to its plain
       version (int8 values and scale), Q2's bf16 output within 1 bf16 ulp
       of its plain version (a float64 convolution of the int8 values,
       exact) on every element of all rows, a tolerance the plain version
       with the last input channel left out must fail; times
       beside the bound (max(2 M K taps C_in / 1,979 TOP/s, bytes / 3.35
       TB/s)), the plain versions, the bf16 cuDNN
       F.conv3d at the same shape (the call the int8 mode replaces) and the
       library route of the same function, an im2col then torch._int_mm
       (cuBLASLt's int8 GEMM) timed together and _int_mm alone, none of
       which the port calls;
     * Q1's two passes as two calls (`quantize_amax`, `quantize_with_amax`,
       the form a tensor-parallel rank's row-split convolution takes) at
       every torso input shape: the word equal to the plain one and the
       int8 values and scale bit-equal to the fused Q1 and the plain
       version; at each row-split site of the flagship (a ResBlock's
       `out_layers.3`, 224, 448 and 672 channels), a tp rank's channel
       shard (112 padded to 128, 224, 336 padded to 352) quantized with
       the whole tensor's word, bit-equal to the plain version and to its
       slice of the whole tensor's Q1; Q2's int32 epilogue
       (`int8_conv3d_acc`) at that shard, the accumulators exactly equal to
       the plain version's, and `dequantize` of them (torch ops) bit-equal
       to Q2's fused epilogue; times of each of the split Q1's passes
       alone (inputs from memory, not L2) and of both together, and of the
       int32 Q2, beside their bounds, the plain versions (and
       `quantize_amax` beside torch.linalg.vector_norm(x, inf)), the bf16 Q2 at the same
       shape, the bf16 cuDNN F.conv3d and the im2col + _int_mm route (the
       same int32 function); and a rank's column-split Q2 at K = 112 (half
       of the 224-wide tile empty) beside the whole K = 224;
     * the fused GroupNorm (+ shift) + activation (`csrc/group_norm_act.cu`,
       a hand kernel with no TPU counterpart) at each distinct norm of the
       flagship's shape step at 272 rows (`unet3d.torso_norm_sites`),
       with the bf16 twin's activation and, after a ResBlock's or the
       output's norm, the int8 twin's RoundedSiLU: the norm within 2^-20
       of the slab's and the bias's scale of the plain path's f32 norm
       plus half a bf16 ulp (the summation order, rounding to nearest),
       the activation bit-equal to the plain one on the kernel's norm
       (`group_norm.gap_to_plain`), the worst gap to the plain output in
       bf16 ulps printed; times beside the bytes bound (2 + 2 bytes an
       element at 3.35 TB/s), the plain path and F.group_norm + F.silu on
       the bf16 tensor, which the port does not call; phases 4 and 13
       require every norm of every shape step fused (its launches);
  3. check the port on the card against the port on the CPU: the tiny
     test configuration in f32 (same weights, same injected noise; max abs
     error <= 1e-4 on boxes and SDFs), one tiny-config f32 training step
     (same weights and draws, the CPU forced down the ReLU branches the
     card took, each flipped input within 1e-4 of its call's peak; loss
     within 1e-5 relative, each gradient leaf within 1e-3 of its part's
     gradient peak + 1e-7, then two AdamW steps on each from the CPU's
     gradients, parameters within 1e-6), and MMD /
     COV / 1-NN over 6 clouds of 256 points (CD values within 1e-5
     relative, auction-EMD values within 1e-4);
  4. drive the main path once: full-width flagship generation (1000-step
     layout DDPM + 100-step shape DDIM + chunked VQ decode) on the seeded
     8-scene synthetic batch, with every kernel launch count set to 0 just
     before and read just after; checks finite outputs of the JAX output
     shapes and the launch counts (K1 = 5 per DDIM step, K2 = one per
     decode chunk);
  5. each upsample site of the flagship (the UNet's at
     16x4x4 x 672 and 16x8x8 x 448 channels, the decoder's 16^3 x 256 and
     32^3 x 128) factored against interpolate + conv: the two agree in
     f32 within 1e-5 of the peak;
  6. drive the evaluation path: a fake SG-FRONT dataset (test split) ->
     `SceneEvaluator` generating every scene at flagship width with SDF
     dumps (at the service's DPM++ 50 / 20; phase 4 drives the protocol's
     chains; the model stays on it for the later phases) -> the
     consistency CLI on the same-category instances -> MMD /
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
     encoder; 9 steps (the
     peak memory; K1 / K2 counts set to 0 just before and read just after:
     K1 = 10 a step, 5 forward + 5 in the remat recompute, K2 = 1, one
     encoder chunk; K1's backward kernel 5 a step), finite losses, the
     parts that get gradients moved, the VQ-VAE bit-unchanged; 2 steps through
     `Trainer.train` over a fake dataset whose SDFs come from an in-memory
     loader (K1 = 20, K2 = 2, the K1 backward 10, finite logged losses); a
     `Trainer.save` -> `restore_checkpoint` round trip into a model with
     other weights, bit-exact, and one step after it with the same loss as
     the saved model's; one step at the yaml's diffusion_bs of 64 (K1 = 10,
     K2 = 8, the K1 backward 5), its peak memory; one step with
     compute_dtype float32 (K1 = 10 and K2 = 1 launches, all f32, and no
     backward kernel; finite loss, its peak memory);
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
     weights and analytic SDFs: 3 f32 steps (peak memory; K2 f32
     = 2 a step, the encoder's and the decoder's mid attention), 3
     bf16 steps (peak memory; K2 bf16 and its backward
     kernel 2 a step, f32 masters), eval_iou over 64 grids (K2 = 2 a
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
     from latents on the phase-4 model, as phase 7's (K1 = 10, K2 =
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
     peak memory, and the wall seconds of each part;
 11. drive data parallelism on the one card: (a) the dp step and the
     ZeRO-1 step at full width over one rank of an NCCL group on phase 7's
     batch and draws, each from the same state as a single-device step
     under deterministic algorithms (dp parameters bit-equal, ZeRO-1
     within 1e-6; K1 = 10, K2 = 1 a step; ms per step, peak memory, the
     flat ZeRO-1 update against the per-tensor AdamW on the card's clock,
     the flat buffers' bytes); (b) the tiny config over 2 gloo ranks
     sharing cuda:0 (collectives through host memory): a dp step and
     ZeRO-1 at grad_accum 2 against the same ranks on the CPU (phase 3's
     limits on the loss and the first moments) and a ZeRO-1 resume
     between micro-steps bit-equal to the uninterrupted run; (c) the
     service over ["cuda:0", "cuda:0"] at DPM++ 50 / 20: 16 requests in
     one call bit-equal to a single-device service's, K1 = 100 and K2 = 6
     a shard a call, 8 concurrent clients' p50 / p95 and requests/sec
     beside phase 8's; (d) `python -m echoscene_torch.parallel.dryrun
     --n 1` on NCCL, in its own process beside (b);
 12. drive tensor parallelism on the one card: (a) one shape-denoiser
     forward at full width on the flagship's step inputs, sampling twin,
     f32 module and the int8 twin of `sample_dtype: int8`, sharded over 2
     gloo ranks sharing cuda:0, against the single-device forward of a
     freshly seeded flagship (bf16 within 2^-4 of the peak and 2^-5 of the
     mean magnitude, f32 within 1e-4 of the peak, int8 within twice one
     device's int8 twin's distance from its bf16 twin, in the max of the
     peak and the mean of the mean magnitude: the int8 rule of
     tests/test_torch_quant.py), 4 heads and K1 = 5 launches a forward
     per rank, under int8 Q2 = 57 a forward per rank (the bf16 epilogue
     and the int32 one together) with the split Q1 and the int32 Q2 once
     per row-split site (`int8_conv.torso_conv_sites`' `row_split_calls`,
     17), the int8 twin's first row-split `Int8Conv3d` (224 channels at
     16^3) on each rank bit-equal to the unsharded one on the gathered
     input and to the other rank's, ms per forward per rank beside one
     device's (one card through host memory: not a scaling number); (b)
     `python -m
     echoscene_torch.parallel.dryrun --n 4 --devices
     cuda:0,cuda:0,cuda:0,cuda:0` (a (2, 2) mesh), in its own process
     beside (c); (c) the tiny dp x tp step over 4 gloo ranks on cuda:0
     against the same ranks on the CPU forced down the card's ReLU branches (phase 3's limits on the loss
     and the first moments);
 13. drive bench.py's fast profile at full width: `build_flagship(
     fast_profile=True)`, int8 torso convolutions with DPM++ 50 layout / 20
     shape steps, on the flagship batch: one generation with every count
     set to 0 just before and read just after (K1 = 5 and Q2 = 57, Q1 = 51
     a shape step, K2 = one a decode chunk), finite outputs of the JAX
     shapes; one shape step of the int8 twin and of the bf16 twin (the
     outputs' difference); the service with
     sample_dtype int8 (warmup, 8 requests from 4 clients, the counts per
     dispatch); one shape step of the `sample_conv: winograd` twin and of
     the direct bf16 twin (the outputs' difference).

The speed of the paths and their layers is `python3 -m portbench`'s job.

Prints the total seconds, the `kernels` JSON line (K1 / K2 in bf16 and in
f32, each entry with its dtype; K1 / K2 also carry their training launches,
serving launches and forward + backward times;
`attention_backward_onepass_attention` / `_stream_attention` are the bf16
backward kernel at K1's and K2's training shapes, their launches phase 7's
2 steps (5 a step) and phase 9's 3 bf16 VQ-VAE steps (2 a
step), with the dp / ZeRO-1 counts a rank and step; the f32 entries' launches
are phase 8's f32 request; the f32 K2 entry also carries its VQ-VAE
launches; `stream_attention_f32_train` is K2 f32 forward + plain backward
at the VQ-VAE site, its launches phase 9's 3 f32 steps; every entry's
`image_metrics_launches` is its wrapper's count over the whole of phase 10,
the counts set to 0 at the phase's start and read at its end; K1 / K2
bf16 also carry phase 11's launches per rank and train step, dp and
ZeRO-1, and per shard and serving call; K4's `dp_launches` is its count
over the whole of phase 11, set to 0 at the phase's start and read at its
end; `onepass_attention_tp_shard` is K1 at a tensor-parallel rank's 4
heads, its launches phase 12 (a)'s per rank and forward; Q1 / Q2
`quantize_act` / `int8_conv3d`, hand kernels with no TPU counterpart,
their launches phase 13's generation, each with every torso shape and
the per-step totals; Q1's passes `quantize_amax` / `quantize_with_amax`
and Q2's int32 form `int8_conv3d_acc` at a tp rank's row-split shapes,
their launches phase 12 (a)'s int8 form per rank and forward), the card's
name
and power limit (nvidia-smi), and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs one card; exits 2 without CUDA or without the repository beside it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
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
# the bf16 backward kernel's dq, dk, dv: the bf16 limits of error_ratios
# against plain autograd, and a max error against float64 within this many
# times plain autograd's own
GRAD_F64_FACTOR = 2.0
BWD_REPLACES = ("none: a hand kernel of the port for JAX's `_fa_bwd` "
                "(echoscene_tpu/kernels/flash_attention.py:237, jax.vjp of "
                "the einsum reference: XLA, no Pallas kernel)")
LOSS_RTOL = 1e-5             # tiny training step, card vs CPU
GRAD_LEAF_RTOL = 1e-3        # ... each gradient leaf, of its part's peak
PARAM_ATOL = 1e-6            # ... parameters after AdamW on the same grads
# a ReLU input whose sign differs between the card and the CPU, as a share
# of its call's peak |input|: f32 rounding accumulated over the layers
# before it (phases 3, 11 b and 12 c)
RELU_MARGIN = 1e-4
# K1 / K2 in phase 7's training step: the shape UNet's self-attention at
# diffusion_bs 8 rows, the frozen VQ encoder's mid attention on 8 SDFs
TRAIN_K1_SHAPE = (8, 1024, 8, 56)
TRAIN_K2_SHAPE = (8, 4096, 1, 256)
# the backward kernel's phase-2 shapes: the training shapes first, a tensor
# parallel rank's 4 heads, ragged ones, then (backward_plan's tiles):
# (1, 200, 2, 128) the D_pad 128 instantiation (8 tiles); (1, 250, 67, 56)
# 67 (2 + 2) = 268 tiles = 2 x 132 + 4, so the persistent D_pad 64 launch's
# first 4 CTAs take a third tile; (3, 301, 2, 256) 6 (5 + 5) = 60 tiles,
# fewer than the SMs (L % 4 != 0 as well)
BWD_SHAPES = {"onepass_attention": [TRAIN_K1_SHAPE, (8, 1024, 4, 56),
                                    (2, 333, 8, 56), (1, 200, 2, 128),
                                    (1, 250, 67, 56)],
              "stream_attention": [TRAIN_K2_SHAPE, (2, 77, 3, 200),
                                   (3, 301, 2, 256)]}
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


def cuda_ms(fn, iters: int, warmup: int = 2,
            sleep_cycles: int = 5_000_000) -> float:
    import torch
    for _ in range(warmup):
        fn()
    # the card waits on a sleep (~2.5 ms by default) while the host enqueues
    # the calls, so a call shorter than its host time is timed on the card
    # alone as long as all `iters` calls are enqueued within the sleep
    torch.cuda._sleep(sleep_cycles)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    ms = cuda_ms(lambda: wrapper(q, k, v), iters=20)
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
            "shape": list(shape),
            "bound_detail": {key: bound[key] for key in (
                "by", "tensor_core_ms", "exp2_ms", "bytes_ms")},
            "tflops": bound["flops"] / ms * 1e-9,
            "share_of_bound": bound["ms"] / ms, "vs_library": ms / library_ms,
            "host_us_per_call": host_us, "err_of_limit": ratios,
            "keys_dropped_err_of_limit": dropped}


INT8_REPLACES = ("none: a hand kernel of the port; JAX's int8 convolution is "
                 "XLA's lax.conv_general_dilated, echoscene_tpu/nn/quant.py:89")
INT8_RAGGED = [  # a small ragged case: odd sizes, channels not a multiple
    dict(name="ragged", x_shape=(3, 37, 5, 7, 9), k=19, taps=(3, 3, 3),
         stride=(1, 2, 2), pads=((1, 1),) * 3, bias=True, x_dtype="bfloat16",
         calls=0)]


def im2col_int8(xq, taps, stride, pads):
    """The (M, taps x Cp) int8 matrix of Q2's implicit GEMM, built
    explicitly (for torch._int_mm, the cuBLASLt yardstick)."""
    import torch.nn.functional as F
    (pd0, pd1), (ph0, ph1), (pw0, pw1) = pads
    x = F.pad(xq.permute(0, 4, 1, 2, 3), (pw0, pw1, ph0, ph1, pd0, pd1))
    x = x.unfold(2, taps[0], stride[0]).unfold(3, taps[1], stride[1]).unfold(
        4, taps[2], stride[2])     # (N, Cp, Do, Ho, Wo, kd, kh, kw)
    return x.permute(0, 2, 3, 4, 5, 6, 7, 1).reshape(
        -1, taps[0] * taps[1] * taps[2] * xq.shape[-1]).contiguous()


def check_int8_kernels(rows: int) -> dict:
    """Phase 2 for Q1 / Q2 (`kernels/int8_conv.py`, `csrc/int8_conv.cu`) at
    every distinct convolution of the flagship's int8 torso at `rows` rows
    (`int8_conv.torso_conv_sites`) and a ragged case: Q1 bit-equal to its
    plain version (int8 values and scale), Q2's bf16 output within 1 ulp of
    its plain version (float64 convolution of the int8 values, exact) on
    every element, over all rows, a tolerance the plain version with the
    last input channel left out must fail; times of Q1, Q2,
    their plain versions, the bf16 cuDNN F.conv3d at
    the same shape (the call the int8 mode replaces), the library route of
    the same function (an im2col then torch._int_mm, cuBLASLt's int8 GEMM,
    timed together) and torch._int_mm alone, beside the bounds."""
    import torch
    import torch.nn.functional as F
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.models.config import ShapeDenoiserConfig
    from echoscene_torch.nn.quant import quantize_weight

    sites, q1_calls = q8.torso_conv_sites(ShapeDenoiserConfig(), rows)
    gen = torch.Generator(device="cuda").manual_seed(12)
    q1_rows, q2_rows = [], []
    seen_q1 = set()
    for site in sites + INT8_RAGGED:
        shape, dtype = site["x_shape"], getattr(torch, site["x_dtype"])
        x = (2 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
        xq, xs = q8.quantize_act(x)
        torch.cuda.synchronize()
        pq, ps = q8.quantize_plain(x)
        word = q8.quantize_amax(x)
        if not torch.equal(word, q8.quantize_amax_plain(x)):
            fail(f"Q1's abs-max pass at {shape}: word "
                 f"{word.view(torch.float32).item()!r}, plain "
                 f"{q8.quantize_amax_plain(x).view(torch.float32).item()!r}")
        sq, ss = q8.quantize_with_amax(x, word)
        if not (torch.equal(sq, xq) and torch.equal(ss, xs)):
            fail(f"Q1's two passes as two calls at {shape}: not bit-equal "
                 f"to the fused Q1")
        del word, sq, ss
        if not (torch.equal(xq, pq) and torch.equal(xs, ps)):
            fail(f"Q1 at {shape} {site['x_dtype']}: not bit-equal to its "
                 f"plain version (scale {xs.item()!r} / {ps.item()!r}, "
                 f"{int((xq != pq).sum())} int8 values differ)")
        if (shape, site["x_dtype"]) not in seen_q1:
            seen_q1.add((shape, site["x_dtype"]))
            b1 = q8.quantize_bound(x.numel(), x.element_size(), xq.numel())
            q1_rows.append({
                "shape": list(shape), "dtype": site["x_dtype"],
                "ms": cuda_ms(lambda: q8.quantize_act(x), iters=10),
                "plain_ms": cuda_ms(lambda: q8.quantize_plain(x), iters=3,
                                    warmup=1),
                "bound_ms": b1["ms"], "bound_by": b1["bound_by"],
                "calls_per_step": 0})
        k, taps = site["k"], site["taps"]
        w = torch.randn((k, shape[1]) + taps, generator=gen,
                        device="cuda") / math.sqrt(shape[1] * math.prod(taps))
        wq, ws = quantize_weight(w)
        bias = (0.1 * torch.randn(k, generator=gen, device="cuda")
                if site["bias"] else None)
        args = (xq, wq, xs, ws, bias, site["stride"], site["pads"])
        out = q8.int8_conv3d(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = q8.int8_conv3d_plain(*args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        ulps = int(q8.bf16_ulps(out, ref).max())
        if ulps > 1:
            fail(f"Q2 {site['name']} at {shape}: {ulps} bf16 ulps from its "
                 f"plain version (limit 1)")
        cut = xq.clone()
        cut[..., shape[1] - 1] = 0
        cut_ulps = int(q8.bf16_ulps(q8.int8_conv3d_plain(cut, *args[1:]),
                                 ref).max())
        if cut_ulps <= 1:
            fail(f"Q2 {site['name']}: the 1-ulp tolerance passes the plain "
                 f"version with the last input channel left out")
        del cut
        max_err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: q8.int8_conv3d(*args), iters=10)
        osize = tuple(out.shape[2:])
        b2 = q8.int8_conv_bound(shape[0], shape[2:], shape[1], xq.shape[-1],
                                k, taps, osize, bias is not None)
        # the bf16 cuDNN convolution at the same shape (TF32 is moot: bf16)
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        (pd0, pd1), (ph0, ph1), (pw0, pw1) = site["pads"]
        xpad = F.pad(xb, (pw0, pw1, ph0, ph1, pd0, pd1))
        bb = None if bias is None else bias.to(torch.bfloat16)
        cudnn_ms = cuda_ms(lambda: F.conv3d(xpad, wb, bb,
                                            stride=site["stride"]), iters=10)
        del xpad
        kp = -(-k // 8) * 8    # _int_mm wants N % 8 == 0
        bmat = torch.zeros((math.prod(taps) * xq.shape[-1], kp),
                           dtype=torch.int8, device="cuda")
        bmat[:, :k] = wq.reshape(k, -1).t()
        # the library route: im2col and the GEMM, timed together
        int_mm_route_ms = cuda_ms(lambda: torch._int_mm(im2col_int8(
            xq, taps, site["stride"], site["pads"]), bmat), iters=5)
        a = im2col_int8(xq, taps, site["stride"], site["pads"])
        int_mm_ms = cuda_ms(lambda: torch._int_mm(a, bmat), iters=10)
        del a, bmat
        q2_rows.append({
            "name": site["name"], "shape": list(shape), "k": k,
            "taps": list(taps), "stride": list(site["stride"]),
            "pads": [list(p) for p in site["pads"]],
            "calls_per_step": site["calls"], "ms": ms,
            "plain_ms": plain_s * 1e3, "bound_ms": b2["ms"],
            "bound_by": b2["bound_by"], "share_of_bound": b2["ms"] / ms,
            "tops": b2["ops"] / ms * 1e-9,
            "cudnn_bf16_ms": cudnn_ms, "int_mm_route_ms": int_mm_route_ms,
            "int_mm_ms": int_mm_ms, "max_ulps": ulps,
            "last_channel_cut_ulps": cut_ulps, "max_abs_err": max_err})
        del x, xq, out, ref
    torch.cuda.empty_cache()
    for r in q1_rows:
        r["calls_per_step"] = sum(
            s["calls"] for s in sites
            if list(s["x_shape"]) == r["shape"] and s["x_dtype"] == r["dtype"])
    return {"sites": sites, "q1_calls_per_step": q1_calls,
            "q2_calls_per_step": sum(s["calls"] for s in sites),
            "q1": q1_rows, "q2": q2_rows}


def int8_entries(chk: dict) -> list:
    """The `kernels` entries of Q1 and Q2: the numbers of the main path's
    most frequent shape (Q1: the 16^3 x 224 bf16 input; Q2: the 3x3x3
    224 -> 224 convolution at 16^3), every shape under `per_shape`, and the
    per-step totals of the torso's shapes (ms, bound;
    Q2: cuDNN bf16, im2col + _int_mm, _int_mm alone) weighted by their
    calls.  Q2's `library_ms` is the im2col + _int_mm route of the same
    function; Q1 has no library call."""
    out = []
    for name, rows, pick in (
            ("quantize_act", chk["q1"],
             lambda r: r["shape"][1:] == [224, 16, 16, 16]
             and r["dtype"] == "bfloat16"),
            ("int8_conv3d", chk["q2"],
             lambda r: r["shape"][1:] == [224, 16, 16, 16]
             and r["taps"] == [3, 3, 3] and r["k"] == 224
             and r["stride"] == [1, 1, 1])):
        main = next(r for r in rows if pick(r))
        step = {key: sum(r[key] * r["calls_per_step"] for r in rows)
                for key in ("ms", "bound_ms") + (
                    ("cudnn_bf16_ms", "int_mm_route_ms", "int_mm_ms")
                    if name == "int8_conv3d" else ())}
        out.append({
            "name": name, "route": "cuda", "dtype": "int8",
            "source": "echoscene_torch/csrc/int8_conv.cu",
            "replaces": INT8_REPLACES, "launches": None,
            "max_abs_err": max(r.get("max_abs_err", 0.0) for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            # the same function by PyTorch calls: an im2col, then the
            # integer GEMM; no single PyTorch call computes Q1
            "library_ms": main.get("int_mm_route_ms"),
            "library": ("im2col + torch._int_mm" if name == "int8_conv3d"
                        else "none: no single PyTorch call computes it"),
            "int_mm_alone_ms": main.get("int_mm_ms"),
            "cudnn_bf16_ms": main.get("cudnn_bf16_ms"),
            "shape": main["shape"], "per_step_totals": step,
            "per_shape": rows,
            "status": "hand kernel of the port, no TPU counterpart"})
    return out


GN_ROWS = 272   # the generation cells' middle row count (256 / 272 / 288)
GN_REPLACES = ("none: a hand kernel of the port; JAX's group_norm_fast "
               "(echoscene_tpu/nn/blocks.py) + SiLU is fused by XLA")


def check_group_norm_kernel(rows: int = GN_ROWS) -> dict:
    """Phase 2 for the fused GroupNorm (+ shift) + activation
    (`kernels/group_norm.py`, `csrc/group_norm_act.cu`) at every distinct
    norm of the flagship's shape step at `rows` rows
    (`unet3d.torso_norm_sites`), with the bf16 twin's activation and,
    after a ResBlock's or the output's norm, the int8 twin's RoundedSiLU
    too: the norm within its error model and the activation exact
    (`group_norm.gap_to_plain`; fatal otherwise), the worst gap to the
    plain path in bf16 ulps; times of the kernel, the plain path (the code
    it replaces), F.group_norm + F.silu on the bf16 tensor (no shift),
    beside the bytes bound; `calls_per_step`, the norms of a shape step."""
    import torch
    import torch.nn.functional as F
    from echoscene_torch.kernels import group_norm as gnk
    from echoscene_torch.models.config import ShapeDenoiserConfig
    from echoscene_torch.nn.unet3d import torso_norm_sites

    sites = torso_norm_sites(ShapeDenoiserConfig(), rows)
    gen = torch.Generator(device="cuda").manual_seed(24)
    out = []
    for site in sites:
        shape = site["x_shape"]
        n, c = shape[:2]
        g, eps = site["groups"], site["eps"]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2.5
             + 0.3).bfloat16()
        shift = (torch.randn((n, c), generator=gen, device="cuda").bfloat16()
                 if site["shift"] else None)
        acts = [site["act"]] + (["rounded_silu"] if site["act"] == "silu"
                                else [])
        for act in acts:
            pdt = torch.float32 if act == "rounded_silu" else torch.bfloat16
            w = (1 + 0.3 * torch.randn(c, generator=gen, device="cuda")
                 ).to(pdt)
            b = (0.2 * torch.randn(c, generator=gen, device="cuda")).to(pdt)
            got = gnk.group_norm_act(x, g, eps, w, b, shift, act)
            gap = gnk.gap_to_plain(x, g, eps, w, b, shift, act, got)
            if gap["norm_of_bound"] > 1 or not gap["act_exact"]:
                fail(f"group_norm_act {site['name']} {act}: {gap}")
            row = dict(name=site["name"], shape=list(shape), groups=g,
                       act=act, shift=site["shift"],
                       calls_per_step=site["calls"], **gap)
            del got
            row["ms"] = cuda_ms(lambda: gnk.group_norm_act(
                x, g, eps, w, b, shift, act), 10)
            row["plain_ms"] = cuda_ms(lambda: gnk.group_norm_act_plain(
                x, g, eps, w, b, shift, act), 3, warmup=1)
            row["library_ms"] = cuda_ms(lambda: F.silu(F.group_norm(
                x, g, w.bfloat16(), b.bfloat16(), eps)), 3, warmup=1)
            row["bound_ms"] = gnk.group_norm_bound(x.numel())["ms"]
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            out.append(row)
            torch.cuda.empty_cache()
    step = {key: sum(r[key] * r["calls_per_step"] for r in out
                     if r["act"] != "rounded_silu")
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    step_int8 = {key: sum(r[key] * r["calls_per_step"] for r in out
                          if r["act"] != "silu")
                 for key in ("ms", "plain_ms", "bound_ms")}
    return {"rows": out, "per_step_bf16": step, "per_step_int8": step_int8,
            "calls_per_step": sum(site["calls"] for site in sites)}


def group_norm_entry(chk: dict, launches: int) -> dict:
    """The `kernels` entry of the fused norm: its `launches` in the main
    path's generation, the numbers of the level-0 224-channel norm (the
    most frequent shape at 16^3), every shape under `per_shape`, the
    per-step totals of the bf16 and int8 twins."""
    main = next(r for r in chk["rows"] if r["shape"][1:] == [224, 16, 16, 16]
                and r["act"] == "silu" and not r["shift"])
    return {"name": "group_norm_act", "route": "cuda", "dtype": "bfloat16",
            "source": "echoscene_torch/csrc/group_norm_act.cu",
            "replaces": GN_REPLACES, "launches": launches,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": main["library_ms"],
            "library": "F.silu(F.group_norm(x)) on the bf16 tensor",
            "max_ulps": max(r["max_ulps"] for r in chk["rows"]),
            "norm_of_bound": max(r["norm_of_bound"] for r in chk["rows"]),
            "shape": main["shape"],
            "per_step_totals": chk["per_step_bf16"],
            "per_step_totals_int8": chk["per_step_int8"],
            "per_shape": chk["rows"],
            "status": "hand kernel of the port, no TPU counterpart"}


def print_group_norm(chk: dict, card: str) -> None:
    for r in chk["rows"]:
        print(f"kernel group_norm_act {r['name']} {r['shape']} {r['act']}"
              f"{' + shift' if r['shift'] else ''}: {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms (bytes), share "
              f"{r['share_of_bound']:.3f}; plain {r['plain_ms']:.4f} ms; "
              f"F.group_norm + F.silu {r['library_ms']:.4f} ms; "
              f"{r['calls_per_step']} a shape step; the norm at "
              f"{r['norm_of_bound']:.6f} of its bound, the activation "
              f"exact; worst {r['max_ulps']} bf16 ulp to the plain output, "
              f"{r['differ']:.2e} of the outputs differ [{card}]")
    print(f"kernel group_norm_act per shape step (bf16 twin): "
          f"{json.dumps(chk['per_step_bf16'])}; int8 twin: "
          f"{json.dumps(chk['per_step_int8'])} [{card}]")


def l2_rotation(t):
    """A function that returns, call after call, the next of copies of `t`
    that fill twice the card's L2 (at least two copies)."""
    import torch
    l2 = torch.cuda.get_device_properties(t.device).L2_cache_size
    n = max(2, -(-2 * l2 // (t.numel() * t.element_size())) + 1)
    copies = itertools.cycle([t.clone() for _ in range(n)])
    return lambda: next(copies)


def check_tp_int8_kernels(rows: int) -> dict:
    """Phase 2 for tensor parallelism's int8 kernels at the flagship's
    row-split sites (each ResBlock's `out_layers.3`, from
    `int8_conv.torso_conv_sites`), on a rank's half of the input channels:
    the split Q1 (`quantize_amax` of the whole tensor, then
    `quantize_with_amax` of the shard, as the MAX over the group gives it)
    bit-equal to the plain passes and to its slice of the whole tensor's
    Q1; the int32 Q2 (`int8_conv3d_acc`) exactly equal to the plain
    accumulators; `dequantize` of them bit-equal to the fused Q2; times of
    each of the split Q1's passes alone (its input from memory, not L2:
    `l2_rotation`) beside its own bound (`quantize_amax` also beside
    `torch.linalg.vector_norm(x, inf)`, the same word in one PyTorch call)
    and of both together, the int32 Q2 beside `int8_conv_bound`, the plain
    versions, the bf16 Q2 at the same shape, the bf16 cuDNN F.conv3d and
    the im2col + _int_mm route (the same int32 function, which the port
    does not call).  Then a rank's column-split Q2 at K = 112 beside the
    whole K = 224."""
    import torch
    import torch.nn.functional as F
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.models.config import ShapeDenoiserConfig
    from echoscene_torch.nn.quant import quantize_weight, weight_amax

    sites, _ = q8.torso_conv_sites(ShapeDenoiserConfig(), rows)
    gen = torch.Generator(device="cuda").manual_seed(16)
    q1_rows, q2_rows = [], []
    for site in [s for s in sites if s["row_split_calls"]]:
        full_shape, k, taps = site["x_shape"], site["k"], site["taps"]
        c = full_shape[1]
        half = c // 2
        shape = (full_shape[0], half) + tuple(full_shape[2:])
        x = (2 * torch.randn(full_shape, generator=gen,
                             device="cuda")).to(torch.bfloat16)
        shard = x[:, :half].contiguous()
        own = q8.quantize_amax(shard)       # this rank's word, before the MAX
        own_plain = q8.quantize_amax_plain(shard)
        # max |x| in one PyTorch call (exact in any dtype)
        library = torch.linalg.vector_norm(shard, float("inf"),
                                           dtype=torch.float32).reshape(1)
        word = q8.quantize_amax(x)          # the MAX over both shards
        sq, ss = q8.quantize_with_amax(shard, word)
        fq, fs = q8.quantize_plain(x)
        pq, ps = q8.quantize_with_amax_plain(shard, word)
        torch.cuda.synchronize()
        if not (torch.equal(own, own_plain)
                and torch.equal(library.view(torch.int32), own_plain)):
            fail(f"Q1's abs-max pass at a rank's shard {shape}: word "
                 f"{own.view(torch.float32).item()!r}, plain "
                 f"{own_plain.view(torch.float32).item()!r}, vector_norm "
                 f"{library.item()!r}")
        if not (torch.equal(sq, pq) and torch.equal(ss, ps)
                and torch.equal(ss, fs)
                and torch.equal(sq[..., :half], fq[..., :half])):
            fail(f"split Q1 at a rank's shard {shape} of {full_shape}: not "
                 f"bit-equal to the plain passes or to the whole tensor's "
                 f"slice")
        # each pass alone, with its own bound: the abs-max reads x and
        # writes one word; the quantize reads x and the word and writes q
        # and the scale (`quantize_bound` counts the scale's 4 bytes).
        # A shard (7-39 MB) fits in the card's L2, so each timed call
        # takes the next of copies that fill twice the L2: its input comes
        # from memory, as the bound assumes
        nxt = l2_rotation(shard)
        b_amax = q8.quantize_bound(shard.numel(), shard.element_size(), 0)
        b_with = q8.quantize_bound(shard.numel(), shard.element_size(),
                                   sq.numel() + 4)
        both_b = q8.quantize_bound(2 * shard.numel(), shard.element_size(),
                                   sq.numel() + 8)
        q1_rows.append({
            "shape": list(shape), "dtype": "bfloat16",
            "whole_tensor": list(full_shape),
            "calls_per_rank_step": site["row_split_calls"],
            "amax": {
                "ms": cuda_ms(lambda: q8.quantize_amax(nxt()), iters=10),
                "plain_ms": cuda_ms(lambda: q8.quantize_amax_plain(nxt()),
                                    iters=3, warmup=1),
                "library_ms": cuda_ms(lambda: torch.linalg.vector_norm(
                    nxt(), float("inf"), dtype=torch.float32), iters=10),
                "bound_ms": b_amax["ms"], "bound_by": b_amax["bound_by"],
                "max_abs_err": (own.view(torch.float32)
                                - own_plain.view(torch.float32)
                                ).abs().max().item()},
            "with_amax": {
                "ms": cuda_ms(lambda: q8.quantize_with_amax(nxt(), word),
                              iters=10),
                "plain_ms": cuda_ms(lambda: q8.quantize_with_amax_plain(
                    nxt(), word), iters=3, warmup=1),
                "bound_ms": b_with["ms"], "bound_by": b_with["bound_by"],
                "max_abs_err": max((sq.int() - pq.int()).abs().max().item(),
                                   (ss - ps).abs().max().item())},
            "both_ms": cuda_ms(lambda: (lambda t: q8.quantize_with_amax(
                t, q8.quantize_amax(t)))(nxt()), iters=10),
            "both_bound_ms": both_b["ms"],
            "fused_ms": cuda_ms(lambda: q8.quantize_act(nxt()), iters=10)})
        del nxt
        del x, fq
        w_full = torch.randn((k, c) + taps, generator=gen,
                             device="cuda") / math.sqrt(c * math.prod(taps))
        w = w_full[:, :half].contiguous()
        wq, ws = quantize_weight(w, weight_amax(w_full))
        bias = 0.1 * torch.randn(k, generator=gen, device="cuda")
        stride, pads = site["stride"], site["pads"]
        acc = q8.int8_conv3d_acc(sq, wq, stride, pads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = q8.int8_conv3d_acc_plain(sq, wq, stride, pads)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if not torch.equal(acc, ref):
            fail(f"int32 Q2 at a rank's shard {shape} -> {k}: "
                 f"{int((acc != ref).sum())} accumulators differ from the "
                 f"plain version")
        fused = q8.int8_conv3d(sq, wq, ss, ws, bias, stride, pads)
        deq = q8.dequantize(acc, ss, ws, bias)
        torch.cuda.synchronize()
        if not torch.equal(deq, fused):
            fail(f"dequantize of the int32 Q2 at {shape} -> {k}: "
                 f"{int((deq != fused).sum())} values differ from Q2's "
                 f"fused epilogue")
        ms = cuda_ms(lambda: q8.int8_conv3d_acc(sq, wq, stride, pads),
                     iters=10)
        bf16_q2_ms = cuda_ms(lambda: q8.int8_conv3d(sq, wq, ss, ws, bias,
                                                    stride, pads), iters=10)
        b2 = q8.int8_conv_bound(shape[0], shape[2:], half, sq.shape[-1], k,
                                taps, tuple(acc.shape[2:]), False,
                                out_bytes=4)
        (pd0, pd1), (ph0, ph1), (pw0, pw1) = pads
        xpad = F.pad(shard, (pw0, pw1, ph0, ph1, pd0, pd1))
        wb = w.to(torch.bfloat16)
        cudnn_ms = cuda_ms(lambda: F.conv3d(xpad, wb, stride=stride),
                           iters=10)
        del xpad
        bmat = torch.zeros((math.prod(taps) * sq.shape[-1], k),
                           dtype=torch.int8, device="cuda")
        bmat[:] = wq.reshape(k, -1).t()
        int_mm_route_ms = cuda_ms(lambda: torch._int_mm(im2col_int8(
            sq, taps, stride, pads), bmat), iters=5)
        del bmat
        q2_rows.append({
            "name": site["name"] + " (row split)", "shape": list(shape),
            "cp": sq.shape[-1], "k": k, "taps": list(taps),
            "calls_per_rank_step": site["row_split_calls"], "ms": ms,
            "plain_ms": plain_s * 1e3, "bound_ms": b2["ms"],
            "bound_by": b2["bound_by"], "share_of_bound": b2["ms"] / ms,
            "bf16_q2_ms": bf16_q2_ms, "cudnn_bf16_ms": cudnn_ms,
            "int_mm_route_ms": int_mm_route_ms,
            "max_abs_err": (acc - ref).abs().max().item()})
        del shard, sq, acc, ref, fused, deq
    # a rank's column-split in_layers.2 at 224 -> 112: the N tile of 224
    # half empty, beside the whole 224 -> 224 convolution
    x = (2 * torch.randn((rows, 224, 16, 16, 16), generator=gen,
                         device="cuda")).to(torch.bfloat16)
    xq, xs = q8.quantize_act(x)
    col = {}
    for k in (112, 224):
        wq, ws = quantize_weight(torch.randn((k, 224, 3, 3, 3),
                                             generator=gen, device="cuda"))
        bias = torch.zeros(k, device="cuda")
        ms = cuda_ms(lambda: q8.int8_conv3d(xq, wq, xs, ws, bias), iters=10)
        b = q8.int8_conv_bound(rows, (16, 16, 16), 224, 224, k, (3, 3, 3),
                               (16, 16, 16), True)
        col[k] = {"ms": ms, "bound_ms": b["ms"],
                  "share_of_bound": b["ms"] / ms}
    del x, xq
    torch.cuda.empty_cache()
    return {"q1": q1_rows, "q2": q2_rows, "column_split": col}


def tp_int8_entries(chk: dict) -> list:
    """The `kernels` entries of the split Q1's two passes and of the int32
    Q2 at a tp rank's row-split shapes: the numbers of the 224-channel
    site (16^3, a rank's 112 channels), every row-split shape under
    `per_shape`; `launches` is filled from phase 12 (a)."""
    q1 = chk["q1"][0]
    q2 = chk["q2"][0]
    base = {"route": "cuda", "dtype": "int8",
            "source": "echoscene_torch/csrc/int8_conv.cu",
            "replaces": INT8_REPLACES, "launches": None,
            "status": "hand kernel of the port, no TPU counterpart"}
    out = []
    for name, key, what, lib in (
            ("quantize_amax", "amax", "Q1's abs-max pass",
             "torch.linalg.vector_norm(x, inf, dtype=float32)"),
            ("quantize_with_amax", "with_amax", "Q1's quantize pass",
             "none: no single PyTorch call computes it")):
        p = q1[key]
        out.append(dict(
            base, name=name, max_abs_err=max(r[key]["max_abs_err"]
                                             for r in chk["q1"]),
            ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
            bound_by=p["bound_by"], library_ms=p.get("library_ms"),
            library=lib, part=what, shape=q1["shape"],
            both_passes_ms=q1["both_ms"],
            both_passes_bound_ms=q1["both_bound_ms"],
            fused_ms=q1["fused_ms"],
            per_shape=[dict(r[key], shape=r["shape"]) for r in chk["q1"]]))
    out.append(dict(
        base, name="int8_conv3d_acc", max_abs_err=q2["max_abs_err"],
        ms=q2["ms"], plain_ms=q2["plain_ms"], bound_ms=q2["bound_ms"],
        bound_by=q2["bound_by"], library_ms=q2["int_mm_route_ms"],
        library="im2col + torch._int_mm", bf16_q2_ms=q2["bf16_q2_ms"],
        cudnn_bf16_ms=q2["cudnn_bf16_ms"], shape=q2["shape"],
        per_shape=chk["q2"], column_split_k112=chk["column_split"]))
    return out


def check_kernel_f32(name, wrapper, shape, ragged_shapes, replaces,
                     sm_clock_hz):
    """Phase 2 for the f32 kernel of one attention wrapper (3xTF32 on the
    tensor cores): f32 inputs against `attention_plain` in f32 at the path
    shape and the ragged ones (`error_ratios`' f32 limits: max abs err <=
    2^-14 of the plain output's peak, mean abs err <= 1e-5 of its mean
    magnitude, which must reject the plain version with its last 32 keys
    left out); times beside the f32 bound (the 3xTF32 products, exp2,
    bytes; the f32 FMA route beside it), its pre-pass alone, SDPA in f32
    with TF32 off, the plain version and the host time of one wrapper
    call.  Returns its `kernels` entry."""
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
            "prepass_ms": prepass_ms, "shape": list(shape),
            "bound_detail": {key: bound[key] for key in (
                "by", "fma_ms", "tf32x3_ms", "exp2_ms", "bytes_ms")},
            "tflops": bound["flops"] / ms * 1e-9,
            "share_of_bound": bound["ms"] / ms, "vs_library": ms / library_ms,
            "host_us_per_call": host_us, "err_of_limit": ratios,
            "keys_dropped_err_of_limit": dropped}


def check_backward_at(name, wrapper, shape, seed):
    """Phase 2, training, at one shape: the bf16 forward kernel's output
    carries the differentiable Function; one forward and one backward kernel
    launch (the counts); dq, dk, dv (the backward kernel of
    csrc/flash_attention_bwd.cu) meet the bf16 limits of `error_ratios`
    against plain autograd through `attention_plain` from the same inputs
    and upstream gradient, and their max error against float64 is within
    GRAD_F64_FACTOR times plain autograd's; the same backward with the last
    32 keys left out fails both limits on dq; two runs are bit-equal; the
    forward's lse matches `attention_plain_lse` and its output is bit-equal
    to the forward without lse.  Returns the numbers and the inputs."""
    import torch
    from echoscene_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fa.reset_launches()
    out = wrapper(*leaves)
    if type(out.grad_fn).__name__ != "KernelAttentionBackward":
        fail(f"{name} at {shape}: output grad_fn {out.grad_fn}, want the "
             "differentiable kernel Function")
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    want_count = {(name, "bfloat16"): 1}
    if (fa.LAUNCHES_BY_DTYPE != want_count
            or fa.BACKWARD_LAUNCHES != want_count):
        fail(f"{name} at {shape}: forward + backward launched "
             f"{fa.LAUNCHES_BY_DTYPE} forward and {fa.BACKWARD_LAUNCHES} "
             f"backward kernels, want one each")
    fwd = fa.error_ratios(out.detach(), fa.attention_plain(q, k, v))
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(*plain), plain, g)
    exact = fa.attention_grads_float64(q, k, v, g)
    ratios = [fa.error_ratios(a, b) for a, b in zip(got, want)]
    f64 = [((a.double() - e).abs().max() / (b.double() - e).abs().max()
            ).item() for a, b, e in zip(got, want, exact)]
    del exact
    if not (max(fwd) <= 1.0 and max(max(r) for r in ratios) <= 1.0
            and max(f64) <= GRAD_F64_FACTOR):
        fail(f"{name} at {shape}: forward at {fwd} of the limits; dq, dk, "
             f"dv at {ratios} of the limits against plain autograd, max "
             f"err against float64 {f64} x plain autograd's (limit "
             f"{GRAD_F64_FACTOR})")
    s = k.shape[1]
    cut = [x.clone().requires_grad_(True) for x in (q, k[:, :s - 32],
                                                    v[:, :s - 32])]
    dropped = fa.error_ratios(torch.autograd.grad(
        fa.attention_plain(*cut), cut, g)[0], want[0])
    if not min(dropped) > 1.0:
        fail(f"{name} at {shape}: the tolerance passes dq with 32 keys left "
             f"out ({dropped[0]:.3f} / {dropped[1]:.3f} of the limits)")
    again = torch.autograd.grad(wrapper(*leaves), leaves, g)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{name} at {shape}: two backward runs differ")
    o, lse = fa._launch(name, q, k, v, lse=True)
    ref_o, ref_lse = fa.attention_plain_lse(q, k, v)
    lse_diff = (lse - ref_lse).abs().max().item()
    if not (lse_diff <= 1e-4 * max(1.0, ref_lse.abs().max().item())
            and torch.equal(o, fa._launch(name, q, k, v))):
        fail(f"{name} at {shape}: lse off by {lse_diff:.3e}, or the "
             "forward with lse differs from the forward without it")
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    return {"shape": list(shape), "fwd_err_of_limit": fwd,
            "grad_err_of_limit": dict(zip(("dq", "dk", "dv"), ratios)),
            "grad_f64_max_err_vs_plain": dict(zip(("dq", "dk", "dv"), f64)),
            "dq_keys_dropped_err_of_limit": dropped, "max_abs_err": err,
            "lse_max_diff": lse_diff, "bit_equal_runs": True}, (
                q, k, v, g, o, lse)


def check_kernel_backward(name, wrapper, shapes, sm_clock_hz):
    """Phase 2, training: `check_backward_at` at each of `shapes` (the
    training shape first), then at the training shape the times of the
    kernel's forward + backward, the backward kernel alone, the host time
    of one `attention_backward` call,
    plain autograd's forward + backward, the plain backward alone
    (`attention_backward_plain`), SDPA's forward + backward and its backward
    alone, beside the bounds of forward + backward (three times the
    forward's products, its exp2, twice its bytes) and of the backward
    alone (`attention_backward_bound`).  Returns (the fields for the
    forward kernel's entry, the backward kernel's `kernels` entry)."""
    import torch
    import torch.nn.functional as F
    from echoscene_torch.kernels import flash_attention as fa

    checks = []
    for i, shape in enumerate(shapes):
        res, inputs = check_backward_at(name, wrapper, shape, 1 + i)
        checks.append(res)
        if i == 0:
            main = inputs
        del inputs
    q, k, v, g, o, lse = main
    shape = shapes[0]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

    def fwd_bwd(fn, xs, gx):
        return lambda: torch.autograd.grad(fn(*xs), xs, gx)

    # autograd's host time for a forward + backward (~0.3-0.4 ms) exceeds
    # K1's device time: a ~30 ms sleep keeps all 10 calls' enqueue within it
    long_sleep = 60_000_000
    kernel_ms = cuda_ms(fwd_bwd(wrapper, leaves, g), iters=10,
                        sleep_cycles=long_sleep)
    def backward():
        return fa.attention_backward(name, q, k, v, o, lse, g)

    backward_ms = cuda_ms(backward, iters=10, sleep_cycles=long_sleep)
    # host time of one backward call: enqueue 10 calls without waiting
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        backward()
    host_us = (time.perf_counter() - t0) / 10 * 1e6
    torch.cuda.synchronize()
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    plain_ms = cuda_ms(fwd_bwd(fa.attention_plain, plain, g), iters=3,
                       warmup=1)
    plain_bwd_ms = cuda_ms(lambda: fa.attention_backward_plain(
        q, k, v, o, lse, g), iters=3, warmup=1)
    tr = [x.detach().transpose(1, 2).contiguous().requires_grad_(True)
          for x in (q, k, v)]
    gt = g.transpose(1, 2).contiguous()
    library_ms = cuda_ms(fwd_bwd(F.scaled_dot_product_attention, tr, gt),
                         iters=10, sleep_cycles=long_sleep)
    out_t = F.scaled_dot_product_attention(*tr)
    library_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out_t, tr, gt, retain_graph=True), iters=10, sleep_cycles=long_sleep)
    del out_t
    fwd = fa.attention_bound(*shape, sm_clock_hz=sm_clock_hz)
    parts = {"operations": max(3 * fwd["tensor_core_ms"], fwd["exp2_ms"]),
             "bytes": 2 * fwd["bytes_ms"]}
    by = max(parts, key=parts.get)
    bwd = fa.attention_backward_bound(*shape, sm_clock_hz=sm_clock_hz)
    fields = {"train_shape": list(shape), "fwd_bwd_ms": kernel_ms,
              "backward_ms": backward_ms, "plain_fwd_bwd_ms": plain_ms,
              "library_fwd_bwd_ms": library_ms,
              "fwd_bwd_bound_ms": parts[by], "fwd_bwd_bound_by": by,
              "fwd_bwd_vs_library": kernel_ms / library_ms}
    entry = {"name": f"attention_backward_{name}", "route": "cuda",
             "dtype": "bfloat16",
             "source": f"echoscene_torch/csrc/{fa.SOURCE_BWD}",
             "replaces": BWD_REPLACES, "launches": None,
             "max_abs_err": checks[0]["max_abs_err"], "ms": backward_ms,
             "plain_ms": plain_bwd_ms, "bound_ms": bwd["ms"],
             "bound_by": bwd["bound_by"], "library_ms": library_bwd_ms,
             "host_us_per_call": host_us,
             "shape": list(shape),
             "bound_detail": {key: bwd[key] for key in (
                 "by", "tensor_core_ms", "exp2_ms", "bytes_ms")},
             "tflops": bwd["flops"] / backward_ms * 1e-9,
             "share_of_bound": bwd["ms"] / backward_ms,
             "vs_library": backward_ms / library_bwd_ms,
             "backward_vs_library": backward_ms / library_bwd_ms,
             "plan": fa.backward_plan(*shape,
                                      sms=fa._sm_count(q.device.index)),
             "checks": checks,
             "what": f"dq, dk, dv of {name} (bf16): the delta pre-pass, then "
                     "one launch of the key tiles' dK / dV and the query "
                     "tiles' dQ (persistent at D_pad 64)"}
    return fields, entry


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
            "share_of_bound": bound["ms"] / ms,
            "pair_tflops": bound["flops"] / ms * 1e-9,
            "host_us_per_call": host_us, "err_of_limit": ratios,
            "ulp": ulps, "ulp_floor": floor, "chamfer_rel_err": cd_rel})
        torch.cuda.empty_cache()
    top = per_shape[0]
    entry = {"name": "nn_distance", "route": "cuda", "dtype": "float32",
             "source": "echoscene_torch/csrc/chamfer.cu",
             "replaces": "echoscene_tpu/kernels/chamfer_pallas.py:27",
             "launches": None}
    entry.update({key: top[key] for key in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "shape", "share_of_bound",
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
        # the service's DPM++ 50 / 20, not the protocol's DDPM 1000 / DDIM
        # 100 that phase 4 drives: the same evaluator, dumps, renders and
        # metrics in a fraction of the chains' time (the smoke's budget)
        cfg = sg.cfg
        cfg.layout_diffusion.sampler = "dpmpp"
        cfg.layout_diffusion.sample_steps = 50
        cfg.shape_branch.sampler, cfg.shape_branch.ddim_steps = "dpmpp", 20
        sg.layout_fast_tables["dpmpp"] = sg.layout_diff.make_dpmpp_tables(50)
        sg.ddim_tables = sg.shape_diff.make_dpmpp_tables(20)
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
    on the CPU from the same weights and draws, the CPU forced down the
    branches every ReLU took on the card (`dryrun.ReluBranches`, as phase
    11 (b)): a few GCN ReLU inputs of this batch lie within f32 rounding of
    0, and a branch taken the other way moves the leaves above it past the
    limit.  Each input whose CPU sign disagrees with the card's branch must
    lie within RELU_MARGIN of its call's peak; then the loss within
    LOSS_RTOL, each gradient leaf within GRAD_LEAF_RTOL of its part's peak
    + 1e-7; then AdamW on each from the CPU's own gradients (parameters
    within PARAM_ATOL).  The tiny config reaches no kernel, so f32 runs on
    the card here."""
    import torch
    from echoscene_torch.benchmarks import seeded_weights_, synthetic_batch
    from echoscene_torch.models.config import tiny_config
    from echoscene_torch.models.sgdiff import SGDiff, trainable_parameters
    from echoscene_torch.parallel.dryrun import ReluBranches

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
    runs, masks = {}, None
    # the card first: its branches are recorded, then forced on the CPU
    for device in ("cuda", "cpu"):
        torch.manual_seed(0)
        sg = SGDiff(cfg, 9, 16, device=device)
        seeded_weights_(sg.module.cpu(), 0)
        sg.module.to(device)
        branches = ReluBranches(sg.module, masks)
        loss, _ = sg.loss_fn(batch.to(device), draws={
            k: v.to(device) for k, v in draws.items()})
        loss.backward()
        branches.remove()
        masks = branches.masks
        params = trainable_parameters(sg.module)
        names = [n for n, _ in params]
        grads = [p.grad.detach().cpu() if p.grad is not None
                 else torch.zeros(p.shape) for _, p in params]
        runs[device] = (sg, loss.item(), grads)
    (cpu, loss_c, grads_c), (card, loss_g, grads_g) = runs["cpu"], \
        runs["cuda"]
    if not branches.margin <= RELU_MARGIN:
        fail(f"tiny training step: {branches.flips} CPU ReLU inputs on the "
             f"other side of 0 from the card's branch, the largest "
             f"{branches.margin:.3e} of its call's peak (limit "
             f"{RELU_MARGIN})")
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
            "param_abs_err_after_2_steps": param_err,
            "relu_flips": branches.flips, "relu_margin": branches.margin}


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
        backward = dict(fa.BACKWARD_LAUNCHES)
        with open(os.path.join(exp, "loss_log.txt")) as f:
            lines = f.read().splitlines()
    want = {"onepass_attention": 10 * steps, "stream_attention": steps}
    want_bwd = {("onepass_attention", "bfloat16"): 5 * steps}
    if state.step - first != steps or launches != want or backward != want_bwd:
        fail(f"Trainer.train took {state.step - first} steps and launched "
             f"{launches} forward and {backward} backward kernels, want "
             f"{steps} steps, {want} and {want_bwd}")
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
            "backward_launches": 5 * steps, "log": lines}


def train_path(sg, card: str) -> dict:
    """Phase 7: the joint training step at full width, bf16, remat on, on
    the phase-4 model with bench.py's train batch (8 scenes, max_nodes 48,
    max_triples 112, diffusion_bs 8, seeded analytic 64^3 SDFs through the
    frozen encoder): 9 steps (K1 / K2 counts set to 0
    just before, read just after), frozen VQ-VAE
    and moved parameters, a save -> restore round trip, and one step at the
    yaml's diffusion_bs of 64."""
    import torch
    from echoscene_torch.benchmarks import (NUM_OBJS, NUM_PREDS,
                                            synthetic_batch)
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
    gen = torch.Generator(device="cuda").manual_seed(17)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    k = 8
    losses = torch.stack([sg.train_step(state, batch, gen)["loss"]
                          for _ in range(k + 1)]).cpu()
    launches = dict(fa.LAUNCHES)
    backward = dict(fa.BACKWARD_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"onepass_attention": 10 * (k + 1),
            "stream_attention": 1 * (k + 1)}
    want_bwd = {("onepass_attention", "bfloat16"): 5 * (k + 1)}
    if launches != want or backward != want_bwd:
        fail(f"training launched {launches} forward and {backward} backward "
             f"kernels in {k + 1} steps, want {want} (K1: 5 sites forward + "
             "5 in the remat recompute; K2: one encoder chunk of 8 rows, no "
             f"gradient) and {want_bwd} (K1: one backward a site)")
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
    backward64 = dict(fa.BACKWARD_LAUNCHES)
    if (launches64 != {"onepass_attention": 10, "stream_attention": 8}
            or backward64 != {("onepass_attention", "bfloat16"): 5}):
        fail(f"the diffusion_bs 64 step launched {launches64} forward and "
             f"{backward64} backward kernels, want K1 10 and K2 8 (eight "
             "encoder chunks of 8) and the K1 backward 5")
    if not bool(torch.isfinite(loss64)):
        fail("the diffusion_bs 64 step's loss is not finite")
    del batch64
    torch.cuda.empty_cache()

    # one step in f32 (compute_dtype float32, f32 masters used as they
    # are): K1 / K2 launch their f32 kernels; f32 takes
    # KernelAttention's plain-recompute backward, no backward kernel
    cfg.compute_dtype = "float32"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        loss32 = sg.train_step(state, batch, gen)["loss"]
        torch.cuda.synchronize()
        peak32 = torch.cuda.max_memory_allocated()
        launches32 = dict(fa.LAUNCHES_BY_DTYPE)
        backward32 = dict(fa.BACKWARD_LAUNCHES)
    finally:
        cfg.compute_dtype = "bfloat16"
    if launches32 != {("onepass_attention", "float32"): 10,
                      ("stream_attention", "float32"): 1} or backward32:
        fail(f"the f32 training step launched {launches32} forward and "
             f"{backward32} backward kernels, want K1 10 and K2 1, all f32, "
             "and no backward kernel (f32 takes the plain recompute)")
    if not bool(torch.isfinite(loss32)):
        fail("the f32 training step's loss is not finite")
    return {"losses": losses.tolist(), "launches": launches,
            "backward_launches_per_step": 5, "steps": k + 1,
            "peak_gib": peak / 2**30,
            "trainer": trainer,
            "moved": moved, "checkpoint_bytes": size, "save_s": save_s,
            "load_s": load_s, "peak_gib_diffusion_bs_64": peak64 / 2**30,
            "loss_diffusion_bs_64": loss64.item(),
            "launches_diffusion_bs_64": launches64,
            "f32_peak_gib": peak32 / 2**30,
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
    before, read just after: 2 a step), 3 bf16 steps (K2 bf16 and its
    backward kernel 2 a step), and eval_iou over 64 grids (2 K2 launches a
    batch).  Returns the numbers and the f32 state."""
    import numpy as np
    import torch
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
    losses = [trainer.train_step(state, batches[i])["loss_total"].item()
              for i in range(3)]
    launches = dict(fa.LAUNCHES_BY_DTYPE)
    peak = torch.cuda.max_memory_allocated()
    if launches != {("stream_attention", "float32"): 6} or \
            fa.BACKWARD_LAUNCHES:
        fail(f"3 f32 VQ-VAE steps launched {launches} forward and "
             f"{fa.BACKWARD_LAUNCHES} backward kernels, want K2 f32 6 (the "
             "encoder's and the decoder's mid attention, each step) and no "
             "backward kernel")
    if not all(math.isfinite(x) for x in losses):
        fail(f"VQ-VAE losses not finite: {losses}")

    bf16 = VQVAETrainer(cfg, compute_dtype="bfloat16", device="cuda")
    st16 = bf16.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses16 = [bf16.train_step(st16, batches[1 + i])["loss_total"].item()
                for i in range(3)]
    peak16 = torch.cuda.max_memory_allocated()
    launches16 = dict(fa.LAUNCHES_BY_DTYPE)
    backward16 = dict(fa.BACKWARD_LAUNCHES)
    if (launches16 != {("stream_attention", "bfloat16"): 6}
            or backward16 != {("stream_attention", "bfloat16"): 6}):
        fail(f"3 bf16 VQ-VAE steps launched {launches16} forward and "
             f"{backward16} backward kernels, want K2 bf16 2 and its "
             "backward 2 a step")
    loss16 = losses16[-1]
    if not all(math.isfinite(x) for x in losses16):
        fail(f"the bf16 VQ-VAE losses are not finite: {losses16}")
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
    res = {"params": n_params, "f32_peak_gib": peak / 2**30,
           "f32_losses": losses, "f32_launches_per_step": 2,
           "bf16_peak_gib": peak16 / 2**30,
           "bf16_backward_launches_per_step": 2,
           "bf16_loss": loss16, "eval_iou": iou, "eval_iou_std": iou_std,
           "eval_iou_s": iou_s, "eval_iou_launches": 2 * len(batches)}
    print(f"VQ-VAE training ({n_params} parameters, batch {VQ_BATCH}, 64^3): "
          f"peak memory {peak / 2**30:.2f} GiB in f32, "
          f"{peak16 / 2**30:.2f} GiB in bf16; eval_iou over "
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
    if fa.LAUNCHES_BY_DTYPE != {("stream_attention", "float32"): 1} or \
            fa.BACKWARD_LAUNCHES:
        fail(f"K2 f32 forward + backward launched {fa.LAUNCHES_BY_DTYPE} "
             f"forward and {fa.BACKWARD_LAUNCHES} backward kernels, want "
             "one f32 forward and the plain recompute")
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
    same step on the phase-4 model from a latent batch, as many steps as
    phase 7 (K1 10, K2 0 a step)."""
    import numpy as np
    import torch
    from echoscene_torch.benchmarks import synthetic_batch
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
        backward = dict(fa.BACKWARD_LAUNCHES)
        want = {("onepass_attention", "bfloat16"): 10 * steps + 5 * 20,
                ("stream_attention", "bfloat16"): nodes // 8}
        want_bwd = {("onepass_attention", "bfloat16"): 5 * steps}
        if state.step != steps or launches != want or backward != want_bwd:
            fail(f"train.cli took {state.step} steps and launched "
                 f"{launches} forward and {backward} backward kernels, want "
                 f"{steps} steps, {want} (K1 10 a step and 5 x 20 for the "
                 "preview; K2 0 a step and one per decode chunk of the "
                 f"preview) and {want_bwd} (K1's backward 5 a step)")
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

    # the joint step from latents on the phase-4 model: phase 7's batch
    # with the frozen encoder's latents of its SDFs in place of the grids
    batch = synthetic_batch(8, 48, 112, seed=0, diffusion_bs=8,
                            sdf_res=64).to("cuda")
    with torch.no_grad():
        lat = sg.module.vqvae.encode_no_quant(batch.shapes.sdf).float()
    batch = dataclasses.replace(batch, shapes=ShapeSelection(
        sdf=None, latent=lat, num_valid=batch.shapes.num_valid,
        indices=batch.shapes.indices, mp_valid=batch.shapes.mp_valid))
    state = sg.init_train_state()
    gen = torch.Generator(device="cuda").manual_seed(17)
    torch.cuda.synchronize()
    fa.reset_launches()
    k = 8
    losses = torch.stack([sg.train_step(state, batch, gen)["loss"]
                          for _ in range(k + 1)])
    launches = dict(fa.LAUNCHES)
    backward = dict(fa.BACKWARD_LAUNCHES)
    if launches != {"onepass_attention": 10 * (k + 1),
                    "stream_attention": 0} or backward != {
                        ("onepass_attention", "bfloat16"): 5 * (k + 1)}:
        fail(f"the joint step from latents launched {launches} forward and "
             f"{backward} backward kernels in {k + 1} steps, want K1 10, K2 "
             "0 and K1's backward 5 a step")
    if not bool(torch.isfinite(losses).all()):
        fail("the joint step from latents gave non-finite losses")
    res.update(cache_step_launches={"onepass_attention": 10,
                                    "stream_attention": 0})
    print(f"pipeline: VQ checkpoint -> precompute_latents over "
          f"{res['precompute_paths']} SDFs in {res['precompute_s']:.2f} s "
          f"(K2 f32 {res['precompute_launches']}) -> train.cli with "
          f"--latent_cache, --vq_ckpt and one preview at the fast profile: "
          f"{steps} steps in {res['cli_s']:.1f} s with model build, saves "
          f"and preview, launches {json.dumps(res['cli_launches'])}, "
          f"{len(images)} preview images; the joint step from latents on the "
          f"phase-4 model (K1 10, K2 0 a step) [{card}]")
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


def dp_train_path(sg, card: str) -> dict:
    """Phase 11 (a): the dp step and the ZeRO-1 step at full width on the
    phase-4 model over one rank of an NCCL group, phase 7's batch and
    draws, each from the same state as a single-device `train_step` (under
    deterministic cuDNN / torch algorithms): the dp step's parameters and
    batch-norm statistics bit-equal to the single step's, ZeRO-1's within
    PARAM_ATOL; K1 = 10 and K2 = 1 a step, counted; ms per step (one warm
    and 3 timed each), peak memory; the flat ZeRO-1 update alone against
    the per-tensor AdamW, on the card's clock."""
    import torch
    from echoscene_torch.benchmarks import synthetic_batch
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.models.sgdiff import trainable_parameters
    from echoscene_torch.parallel import mesh
    from echoscene_torch.parallel.dp import dp_train_step
    from echoscene_torch.parallel.zero import (flat_length, init_zero1_state,
                                               zero1_train_step,
                                               zero1_update_shard)

    batch = synthetic_batch(8, 48, 112, seed=0, diffusion_bs=8,
                            sdf_res=64).to("cuda")
    start = {n: t.detach().cpu().clone()
             for n, t in sg.module.state_dict().items()}
    named = trainable_parameters(sg.module)
    n, n_pad = flat_length(sg.module, 1)
    gen = lambda: torch.Generator(device="cuda").manual_seed(41)
    steps = {
        "single": (sg.init_train_state,
                   lambda st: sg.train_step(st, batch, gen())),
        "dp": (sg.init_train_state,
               lambda st: dp_train_step(sg, st, batch, gen())),
        "zero1": (lambda: init_zero1_state(sg, sg.init_train_state()),
                  lambda st: zero1_train_step(sg, st, batch, gen()))}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    runs, after = {}, {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        mesh.init_process_group(0, 1, "nccl", os.path.join(tmp, "rendezvous"))
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for name, (make, step) in steps.items():
                sg.module.load_state_dict(start)
                state = make()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fa.reset_launches()
                metrics = step(state)
                torch.cuda.synchronize()
                launches = dict(fa.LAUNCHES)
                backward = {f"{k[0]}/{k[1]}": c
                            for k, c in fa.BACKWARD_LAUNCHES.items()}
                peak = torch.cuda.max_memory_allocated()
                after[name] = {k: v.detach().cpu().clone() for k, v in
                               sg.module.state_dict().items()}
                if launches != {"onepass_attention": 10,
                                "stream_attention": 1} or backward != {
                                    "onepass_attention/bfloat16": 5}:
                    fail(f"the {name} step launched {launches} forward and "
                         f"{backward} backward kernels, want K1 10, K2 1 "
                         "and K1's backward 5")
                if not math.isfinite(float(metrics["loss"])):
                    fail(f"the {name} step's loss is not finite")
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(state)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                runs[name] = {"loss": float(metrics["loss"]),
                              "launches": launches,
                              "backward_launches": backward,
                              "peak_gib": peak / 2**30,
                              "ms": sorted(walls)[1], "ms_all": walls}
                if name == "zero1":
                    z = state.optimizer
                    p_shard = torch.cat([p.detach().reshape(-1)
                                         for _, p in named])
                    g = torch.randn_like(p_shard) * 1e-3
                    update_ms = cuda_ms(lambda: zero1_update_shard(
                        g, p_shard, z.mu, z.nu, z.count, z.train_mask,
                        z.clip_mask, lambda c: 1e-4), 3, 1)
                    del p_shard, g
                if name == "single":
                    grads = [torch.full_like(p, 1e-3) for _, p in named]
                    adamw_ms = cuda_ms(lambda: sg.apply_gradients(
                        state, grads), 3, 1)
                    del grads
                del state
        finally:
            mesh.destroy_process_group()
            torch.backends.cudnn.deterministic = flags[0]
            torch.backends.cudnn.benchmark = flags[1]
            torch.use_deterministic_algorithms(flags[2], warn_only=flags[3])
            sg.module.load_state_dict(start)
    del start
    keys = [k for k in after["single"]
            if not k.startswith("vqvae.")]
    dp_equal = [k for k in keys
                if not torch.equal(after["dp"][k], after["single"][k])]
    dp_diff = max((after["dp"][k].float() - after["single"][k].float()
                   ).abs().max().item() for k in keys)
    z_diff = max((after["zero1"][k].float() - after["single"][k].float()
                  ).abs().max().item() for k in keys)
    del after
    if dp_equal:
        fail(f"the dp step over one rank differs from the single-device "
             f"step in {len(dp_equal)} tensors (max {dp_diff:.3e}), e.g. "
             f"{dp_equal[:4]}")
    if not z_diff <= PARAM_ATOL:
        fail(f"the ZeRO-1 step differs from the AdamW step by {z_diff:.3e} "
             f"(limit {PARAM_ATOL})")
    bytes_ = {"dp_bucket_gb": 4 * n / 1e9,
              "zero1_flat_grad_and_shard_gb": 8 * n_pad / 1e9,
              "zero1_param_slice_and_gather_gb": 8 * n_pad / 1e9,
              "zero1_masks_gb": 2 * n_pad / 1e9,
              "moments_gb": 8 * n / 1e9}
    print(f"dp over one NCCL rank, full width (phase 7's batch, bf16, "
          f"remat, {n} trainable parameters): single step "
          f"{runs['single']['ms']:.3f} ms, dp {runs['dp']['ms']:.3f} ms, "
          f"ZeRO-1 {runs['zero1']['ms']:.3f} ms (medians of 3); peak memory "
          f"{runs['single']['peak_gib']:.2f} / {runs['dp']['peak_gib']:.2f} "
          f"/ {runs['zero1']['peak_gib']:.2f} GiB; dp parameters bit-equal "
          f"to the single step's, ZeRO-1 within {z_diff:.3e}; flat ZeRO-1 "
          f"update {update_ms:.3f} ms against the per-tensor AdamW "
          f"{adamw_ms:.3f} ms (card clock); buffers {json.dumps(bytes_)}; "
          f"launches a step {json.dumps(runs['dp']['launches'])} [{card}]")
    return {"runs": runs, "zero1_param_max_diff": z_diff,
            "dp_param_max_diff": dp_diff, "zero1_update_ms": update_ms,
            "adamw_ms": adamw_ms, "trainable": n, "buffers": bytes_}


def run_against(a, b):
    """Two rank jobs' results of one run (`dryrun.train_job`): (loss rel
    err, the largest first-moment error as a share of its part's peak, the
    leaves off by more than GRAD_LEAF_RTOL of it)."""
    part = lambda name: name.split(".")[0]
    rel = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
              for x, y in zip(a["metrics"], b["metrics"]))
    peak = {}
    for name, (mu, _) in b["moments"].items():
        peak[part(name)] = max(peak.get(part(name), 0.0),
                               mu.abs().max().item())
    errs = {name: (a["moments"][name][0] - mu).abs().max().item()
            for name, (mu, _) in b["moments"].items()}
    bad = [name for name, e in errs.items()
           if not e <= GRAD_LEAF_RTOL * peak[part(name)] + 1e-8]
    of_part = max(e / peak[part(name)] for name, e in errs.items()
                  if peak[part(name)] > 0)
    return rel, of_part, bad


def dp_tiny_gloo(card: str) -> dict:
    """Phase 11 (b): the tiny config (layout width 512, as phase 3) over 2
    gloo ranks sharing cuda:0, every collective through host memory, with
    draws made on the CPU: a dp step and ZeRO-1 at grad_accum 2 (two calls,
    a checkpoint saved between them) on SDF batches, which the frozen
    VQ-VAE encodes on each rank's device (the default training input), and
    a dp step on batches carrying latents encoded on the CPU (the latent
    cache's path).  The same ranks on the CPU take the same runs with every
    ReLU forced down the branch it took on the card
    (`dryrun.ReluBranches`): on these batches a few ReLU inputs lie within
    rounding of 0, and a sign that differs by rounding passes that
    element's gradient on one system and not on the other, which moves the
    GCN leaves above it past GRAD_LEAF_RTOL.  So: each element whose own
    sign on the CPU disagrees with the card's branch must lie within
    RELU_MARGIN of its call's peak, and given the card's branches the
    losses agree within LOSS_RTOL and the first moments within
    GRAD_LEAF_RTOL of their part's peak.  The CPU's runs on their own
    branches are compared too and printed, not held.  A model with other
    weights resumed from the ZeRO-1 checkpoint ends bit-equal to the
    uninterrupted run on the card (deterministic algorithms in the
    ranks)."""
    import concurrent.futures

    import torch
    from echoscene_torch.models.config import tiny_config
    from echoscene_torch.parallel.dryrun import run_job, tiny_job

    cfg = tiny_config()
    cfg.layout_denoiser.model_channels = 512
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    names = ("dp", "zero1_accum2", "dp_latents")
    # the jobs are made one after the other (their models' default
    # initialisation draws from the process's RNG)
    lat = tiny_job(["cpu", "cpu"], steps=1, cfg=cfg, draws=True,
                   latents=True)["shards"]
    jobs = []
    for where in ("cuda:0", "cpu", "cpu"):
        job = tiny_job([where, where], steps=2, cfg=cfg, draws=True)
        sdf = job.pop("shards")
        job["deterministic"] = True
        job["runs"] = [
            {"name": names[0], "mode": "dp", "shards": [r[:1] for r in sdf]},
            {"name": names[1], "mode": "zero1", "grad_accum": 2,
             "shards": sdf, "resume_at": 1},
            {"name": names[2], "mode": "dp", "shards": lat}]
        jobs.append(job)

    def run(job):
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "build")) as tmp:
            job["runs"][1]["ckpt_dir"] = tmp
            return run_job(job, "gloo")

    # the card's ranks (recording their branches) and the CPU's on their
    # own branches run at once; then the CPU's on the card's branches
    t0 = time.perf_counter()
    jobs[0]["relu"] = "record"
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        card_res, own_res = pool.map(run, (jobs[0], jobs[2]))
    jobs[1]["relu"] = {n: card_res[n]["relu_masks"] for n in names}
    cpu_res = run(jobs[1])
    seconds = time.perf_counter() - t0
    # the tiny config's attention (64 tokens, f32) takes the einsum path:
    # no attention kernel runs on the card's ranks
    kernel_runs = {n: (card_res[n]["attention_launches"],
                       card_res[n]["attention_backward_launches"])
                   for n in names}
    if any(a or b for a, b in kernel_runs.values()):
        fail(f"the tiny dp runs launched attention kernels {kernel_runs}, "
             "want none (64 tokens, f32)")

    worst, own = {}, {}
    for run_name in names:
        rel, of_part, bad = run_against(card_res[run_name],
                                        cpu_res[run_name])
        flips = cpu_res[run_name]["relu_flips"]
        margin = cpu_res[run_name]["relu_margin"]
        if not (rel <= LOSS_RTOL and not bad and margin <= RELU_MARGIN):
            fail(f"dp run {run_name}, 2 gloo ranks on cuda:0 vs the CPU on "
                 f"the card's ReLU branches: loss rel err {rel:.3e} (limit "
                 f"{LOSS_RTOL}); first moments off by more than "
                 f"{GRAD_LEAF_RTOL} of their part's peak: {bad[:6]}; "
                 f"{flips} ReLU inputs on the other side of 0, the largest "
                 f"{margin:.3e} of its call's peak (limit {RELU_MARGIN})")
        worst[run_name] = {"loss_rel_err": rel,
                           "moment_err_of_part_peak": of_part,
                           "relu_flips": flips, "relu_margin": margin}
        rel, of_part, bad = run_against(card_res[run_name],
                                        own_res[run_name])
        own[run_name] = {"loss_rel_err": rel,
                         "moment_err_of_part_peak": of_part,
                         "leaves_past_limit": len(bad)}
    r = card_res["zero1_accum2"]
    same = all(torch.equal(r["resumed"]["params"][k], v)
               for k, v in r["params"].items())
    if not same:
        diff = max((r["resumed"]["params"][k] - v).abs().max().item()
                   for k, v in r["params"].items())
        fail(f"the ZeRO-1 resume on the card differs from the "
             f"uninterrupted run by {diff:.3e}")
    hops = card_res["host_hops"]
    if not hops:
        fail("gloo on cuda:0 ran no collective through host memory")
    print(f"dp over 2 gloo ranks sharing cuda:0 (tiny config): dp and "
          f"ZeRO-1 at grad_accum 2 on SDF batches, dp on CPU latents, "
          f"against the CPU ranks on the card's ReLU branches "
          f"{json.dumps(worst)}; against the CPU ranks on their own "
          f"branches (not held) {json.dumps(own)}; the ZeRO-1 resume "
          f"between micro-steps bit-equal; collectives through host memory "
          f"on rank 0 {json.dumps(hops)}; {seconds:.1f} s for the three "
          f"runs (spawn included) [{card}]")
    return {"against_cpu": worst, "against_cpu_own_branches": own,
            "resume_bit_equal": same, "host_hops_rank0": hops,
            "seconds": seconds}


def dp_serve_path(sg, card: str, phase8: dict) -> dict:
    """Phase 11 (c): the service on ["cuda:0", "cuda:0"] at DPM++ 50 / 20
    (phase 8's vocabulary, bucket and request stream, rows pinned at 48):
    warmup of both devices' replica, 16 requests in one call bit-equal to
    a single-device seed-0 service's (each group draws the seed of its
    single-device dispatch), K1 = 100 and K2 = 6 a shard (the counts
    under the wrappers' lock), then 8 concurrent clients through the
    MicroBatcher, which takes up to one bucket a device in a call (a call
    runs one shard a group, none padded): p50 / p95 and requests/sec
    beside phase 8's."""
    import numpy as np
    import torch
    from echoscene_torch.benchmarks import concurrent_latency
    from echoscene_torch.data.clip_text import ClipTextEncoder
    from echoscene_torch.data.collate import CollateSpec
    from echoscene_torch.data.fake import make_fake_dataset
    from echoscene_torch.data.sgfront import SGFrontDataset
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.serve.service import GenerationService

    clip = ClipTextEncoder("hash")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        root = make_fake_dataset(os.path.join(tmp, "data"), num_scenes=8,
                                 min_objs=3, max_objs=6, with_sdf=False,
                                 seed=0)
        ds = SGFrontDataset(root, split="test", shuffle_objs=False,
                            use_sdf=False, with_changes=False, clip=clip,
                            seed=47)
    spec = CollateSpec(max_nodes=48, max_triples=160, max_scenes=8,
                       diffusion_bs=48, with_sdf=False)
    cfg = sg.cfg
    cfg.layout_diffusion.sampler, cfg.layout_diffusion.sample_steps = (
        "dpmpp", 50)
    cfg.shape_branch.sampler, cfg.shape_branch.ddim_steps = "dpmpp", 20
    cfg.sample_dtype = "bfloat16"
    sg.layout_fast_tables["dpmpp"] = sg.layout_diff.make_dpmpp_tables(50)
    sg.ddim_tables = sg.shape_diff.make_dpmpp_tables(20)
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
    reqs = [request(f"s{i}") for i in range(16)]

    def service(**kw):
        return GenerationService(sg, spec, ds.box_stats, ds.classes,
                                 ds.rel_dict, clip=clip, gen_shape=True,
                                 seed=0, result_format="arrays",
                                 row_buckets=(48,), **kw)
    t0 = time.perf_counter()
    dp = service(devices=["cuda:0", "cuda:0"])
    n_warm = dp.warmup(verbose=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    calls = []
    sample_dp = dp._sample_dp

    def counted_sample_dp(batches, manip):
        calls.append(len(batches))
        return sample_dp(batches, manip)
    dp._sample_dp = counted_sample_dp
    fa.reset_launches()
    t0 = time.perf_counter()
    got = dp.generate(reqs)
    torch.cuda.synchronize()
    one_call_s = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    one_call_groups = list(calls)
    shards = sum(calls)
    want = {"onepass_attention": 5 * 20 * shards,
            "stream_attention": 6 * shards}
    if launches != want:
        fail(f"the dp service's {len(calls)} calls ({calls} groups) "
             f"launched {launches}, want {want} (K1 = 100, K2 = 6 a shard)")
    t0 = time.perf_counter()
    ref = service().generate(reqs)
    single_s = time.perf_counter() - t0
    for a, b in zip(got, ref):
        if a["id"] != b["id"] or not all(
                np.array_equal(np.asarray(a[f]), np.asarray(b[f]))
                for f in ("sizes", "translations", "angles", "sdfs")):
            fail(f"the dp service's result {a['id']} differs from the "
                 "single-device service's")
    calls.clear()
    fa.reset_launches()
    stream = concurrent_latency(dp, reqs, 10.0, 8)
    torch.cuda.synchronize()
    if sorted(stream["results"]) != list(range(len(reqs))):
        fail("the dp service's concurrent stream lost requests")
    stream_launches = dict(fa.LAUNCHES)
    if stream_launches["onepass_attention"] != 100 * sum(calls):
        fail(f"the dp stream launched {stream_launches} over {len(calls)} "
             f"calls of {sum(calls)} shards, want K1 = 100 a shard")
    lat = np.asarray(stream["latencies_s"])
    res = {"warmup_s": warm_s, "variants": n_warm,
           "one_call_s": one_call_s, "one_call_groups": one_call_groups,
           "single_device_s": single_s, "launches": launches,
           "shards": shards,
           "latency_p50_s": float(np.percentile(lat, 50)),
           "latency_p95_s": float(np.percentile(lat, 95)),
           "req_per_sec": stream["req_per_sec"],
           "stream_calls": len(calls), "stream_shards": sum(calls),
           "stream_launches": stream_launches}
    print(f"dp service on [cuda:0, cuda:0] (DPM++ 50 / 20, rows 48): "
          f"warmup {warm_s:.3f} s; 16 requests in one call {one_call_s:.3f} "
          f"s over {shards} shards, bit-equal to a single-device service "
          f"({single_s:.3f} s); launches {json.dumps(launches)}; 8 clients: "
          f"p50 {res['latency_p50_s']:.3f} s, p95 {res['latency_p95_s']:.3f}"
          f" s, {res['req_per_sec']:.4f} requests/sec over "
          f"{len(calls)} calls of {sum(calls)} shards (phase 8, one device: "
          f"p50 "
          f"{phase8['latency_p50_s']:.3f} s, p95 "
          f"{phase8['latency_p95_s']:.3f} s, {phase8['req_per_sec']:.4f} "
          f"requests/sec) [{card}]")
    return res


def dryrun_start(*args: str):
    """`python -m echoscene_torch.parallel.dryrun` with `args`, as a user
    runs it, started in the background beside a phase's tiny step (phase
    11 (d): `--n 1` on NCCL; phase 12 (b): `--n 4 --devices
    cuda:0,cuda:0,cuda:0,cuda:0`, 4 gloo ranks, a (2, 2) mesh), its output
    in temporary files: (start time, process, args, stdout, stderr)."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m",
                             "echoscene_torch.parallel.dryrun", *args],
                            cwd=ROOT, stdout=out, stderr=err, text=True)
    return time.perf_counter(), proc, args, out, err


def dryrun_wait(started, card: str) -> dict:
    """A dry run of `dryrun_start`, awaited: its exit code and its stage
    lines."""
    t0, proc, args, out, err = started
    proc.wait(timeout=600)
    seconds = time.perf_counter() - t0
    out.seek(0)
    err.seek(0)
    lines = [ln for ln in out.read().splitlines()
             if ln.startswith("[dryrun]")]
    cmd = " ".join(args)
    if proc.returncode != 0:
        fail(f"parallel.dryrun {cmd} exited {proc.returncode}: "
             f"{err.read()[-2000:]}")
    for ln in lines:
        print(f"  {ln}")
    print(f"parallel.dryrun {cmd}: {seconds:.1f} s, beside the phase's tiny "
          f"step [{card}]")
    return {"seconds": seconds, "lines": lines}


def stop(started) -> None:
    """Stop a dry run of `dryrun_start` that is still running."""
    if started[1].poll() is None:
        started[1].kill()
        started[1].wait()


def dp_path(sg, card: str, phase8: dict) -> dict:
    """Phase 11: data parallelism on the one card, (a) to (d), (d) in its
    own process beside (b) (the timed (a) and (c) run alone); K4's count
    over the whole phase (set to 0 before it, read after it)."""
    from echoscene_torch.kernels import chamfer as k4

    t0 = time.perf_counter()
    k4.reset_launches()
    out = {"train": dp_train_path(sg, card)}
    started = dryrun_start("--n", "1")
    try:
        out["gloo"] = dp_tiny_gloo(card)
        out["dryrun"] = dryrun_wait(started, card)
    finally:
        stop(started)
    out["serve"] = dp_serve_path(sg, card, phase8)
    out["k4_launches"] = k4.LAUNCHES["nn_distance"]
    out["phase_s"] = time.perf_counter() - t0
    return out


BF16_TP_MAX = 2.0 ** -4       # phase 12 (a): bf16 tp vs one device, of peak
BF16_TP_MEAN = 2.0 ** -5      # ... mean err of the mean magnitude
F32_TP_MAX = 1e-4             # ... f32, of the peak
# ... int8 vs one device's int8 twin, in units of that twin's own distance
# from its bf16 twin: the repo's int8 rule (tests/test_torch_quant.py's
# INT8_DRIFTS).  The tp path's bf16 rounding differs from one device's by
# ~1% (the head split, the f32 sums of bf16 partials), and the per-tensor
# int8 scales turn that into int8 noise of the int8 error's own size, as
# they do between the port and JAX; the row split itself is exact (phase 2)
INT8_TP_DRIFTS = 2.0


def upsample_sites(rows: int) -> list:
    """Phase 5: each upsample site of the flagship (the shape UNet's two at
    the path's rows, the VQ decoder's two at a decode chunk of 8) in the
    factored form against interpolate + conv: the two forms agree in f32
    (TF32 off) within 1e-5 of the peak."""
    import torch
    import torch.nn.functional as F
    from echoscene_torch.nn.blocks import factored_upsample_conv

    sites = [("unet level 2, 16x4x4", (rows, 672, 16, 4, 4), (1, 2)),
             ("unet level 1, 16x8x8", (rows, 448, 16, 8, 8), (1, 2)),
             ("decoder 16^3", (8, 256, 16, 16, 16), (0, 1, 2)),
             ("decoder 32^3", (8, 128, 32, 32, 32), (0, 1, 2))]
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for name, shape, up in sites:
        c = shape[1]
        x = torch.randn(shape, generator=gen, device="cuda")
        w = torch.randn((c, c, 3, 3, 3), generator=gen,
                        device="cuda") / math.sqrt(27 * c)
        b = 0.02 * torch.randn((c,), generator=gen, device="cuda")
        scale = [2 if a in up else 1 for a in range(3)]

        def direct(x, w, b):
            return F.conv3d(F.interpolate(x, scale_factor=scale,
                                          mode="nearest"), w, b, padding=1)

        want = direct(x, w, b)
        err = ((factored_upsample_conv(x, w, b, up) - want).abs().max()
               / want.abs().max()).item()
        if not err <= 1e-5:
            fail(f"factored upsample at {name} {shape}: f32 max err {err:.3e}"
                 f" of the peak against interpolate + conv (limit 1e-5)")
        del want
        out.append({"site": name, "shape": list(shape), "up_axes": list(up),
                    "f32_err_of_peak": err})
    return out


def tp_forward(sg, batch, rows: int, card: str) -> dict:
    """Phase 12 (a): one shape-denoiser forward at full width on the
    flagship's step inputs, sampling twin, f32 module and int8 twin, over
    2 gloo ranks sharing cuda:0 (`dryrun.tp_forward_job`: each rank builds
    the seeded flagship and shards it), against the single-device forward
    of the same seeded flagship: bf16 within BF16_TP_MAX of the peak and
    BF16_TP_MEAN of the mean magnitude, f32 within F32_TP_MAX of the peak,
    int8 within INT8_TP_DRIFTS times the single-device int8 twin's distance
    from the single-device bf16 twin (max of the peak, mean of the mean
    magnitude; the ranks' own int8 twin's distance from their bf16 twin
    printed beside it);
    each rank runs 4 heads a site and launches K1 5 times a forward (at
    (rows, 1024, 4, 56)); under int8, Q2 57 times a forward per rank (the
    bf16 and the int32 epilogue together), the split Q1 and the int32 Q2
    once per row-split site (`torso_conv_sites`' `row_split_calls`) and
    the fused Q1 at the other Q1 sites; on each rank the int8 twin's first
    row-split convolution (`dryrun.row_split_check`, on the input the
    forward gave it) bit-equal to the unsharded Int8Conv3d on the gathered
    input, and the ranks' outputs bit-equal (the collectives of the row
    split held exact on the card, beside the end-to-end limit); ms per
    forward per rank beside one device's, through host memory on one card:
    not a scaling number."""
    import torch
    from echoscene_torch.benchmarks import part_calls
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.models.config import ShapeDenoiserConfig
    from echoscene_torch.parallel.dryrun import run_job, tp_forward_job

    single = {}
    with torch.no_grad():
        calls = part_calls(sg, batch, rows)
        x = calls["inputs"]
        args = [x[k] for k in ("z", "t", "obj_embed", "triples", "obj_mask",
                               "triple_mask")]
        sg.cfg.sample_dtype = "int8"
        int8_twin = sg.inference_module()
        sg.cfg.sample_dtype = "bfloat16"
        for form, fn in (("bf16", calls["shape_step"]),
                         ("f32", lambda: sg.module.eval().shape_eps(*args)),
                         ("int8", lambda: int8_twin.shape_eps(*args))):
            torch.cuda.synchronize()
            fa.reset_launches()
            q8.reset_launches()
            y = fn()
            torch.cuda.synchronize()
            launches = dict(fa.LAUNCHES, **q8.LAUNCHES)
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            single[form] = {"out": y.float().cpu(), "launches": launches,
                            "ms": (time.perf_counter() - t0) * 1e3 / 3}
    del calls, int8_twin
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_job({"devices": ["cuda:0", "cuda:0"], "iters": 1,
                   "inputs": {k: v.cpu() for k, v in x.items()}}, "gloo",
                  fn=tp_forward_job)
    seconds = time.perf_counter() - t0
    out = {"seconds": seconds, "ranks": res["ranks"], "errors": {},
           "single_ms": {f: single[f]["ms"] for f in single},
           "single_launches": {f: single[f]["launches"] for f in single}}
    sites, q1_calls = q8.torso_conv_sites(ShapeDenoiserConfig(), rows)
    q2_calls = sum(s["calls"] for s in sites)
    split = sum(s["row_split_calls"] for s in sites)
    first_split = next(s for s in sites if s["row_split_calls"])
    want_int8 = {"int8_conv3d": q2_calls - split, "int8_conv3d_acc": split,
                 "quantize_act": q1_calls - split, "quantize_amax": split,
                 "quantize_with_amax": split}
    out["int8_launches_wanted_per_rank"] = want_int8
    if single["int8"]["launches"]["int8_conv3d"] != q2_calls:
        fail(f"the single-device int8 twin launched Q2 "
             f"{single['int8']['launches']['int8_conv3d']} times, want "
             f"{q2_calls}")
    for rank in res["ranks"]:
        if rank["heads"] != [4]:
            fail(f"a tp rank's attention runs {rank['heads']} heads, want 4")
        for form in ("bf16", "f32", "int8"):
            got = rank[f"{form}_launches"]["onepass_attention"]
            if got != 5:
                fail(f"K1 launched {got} times in a tp rank's {form} "
                     f"forward, want 5")
        got = {k: rank["int8_launches"][k] for k in want_int8}
        q2 = got["int8_conv3d"] + got["int8_conv3d_acc"]
        if got != want_int8 or q2 != q2_calls:
            fail(f"a tp rank's int8 forward launched {got} (Q2 {q2}), want "
                 f"{want_int8} (Q2 {q2_calls}, {split} row-split sites)")
        chk = rank["row_split_check"]
        if chk["whole_x_shape"] != list(first_split["x_shape"]):
            fail(f"the row-split check ran at {chk}, want the first "
                 f"row-split site {first_split['x_shape']}")
        if not (chk["bit_equal_to_unsharded"] and chk["ranks_bit_equal"]):
            fail(f"the row-split Int8Conv3d at {chk['site']} on the card: "
                 f"{chk['differing']} outputs differ from the unsharded "
                 f"Int8Conv3d on the gathered input, ranks bit-equal "
                 f"{chk['ranks_bit_equal']}")
    for form, (lim_max, lim_mean) in (("bf16", (BF16_TP_MAX, BF16_TP_MEAN)),
                                      ("f32", (F32_TP_MAX, None))):
        a, b = res["outputs"][form], single[form]["out"]
        if not bool(torch.isfinite(a).all()):
            fail(f"the tp {form} forward is not finite")
        err = ((a - b).abs().max() / b.abs().max()).item()
        mean = ((a - b).abs().mean() / b.abs().mean()).item()
        out["errors"][form] = {"max_of_peak": err, "mean_of_mean": mean}
        if not (err <= lim_max and (lim_mean is None or mean <= lim_mean)):
            fail(f"tp {form} shape step vs one device: max err {err:.3e} of "
                 f"the peak (limit {lim_max}), mean err {mean:.3e} of the "
                 f"mean magnitude (limit {lim_mean})")
    # int8: the tp ranks' distance from one device's int8 twin against one
    # device's int8 twin's own distance from its bf16 twin
    dist = lambda a, b: {"max_of_peak": ((a - b).abs().max()
                                         / b.abs().max()).item(),
                         "mean_of_mean": ((a - b).abs().mean()
                                          / b.abs().mean()).item()}
    a, b = res["outputs"]["int8"], single["int8"]["out"]
    if not bool(torch.isfinite(a).all()):
        fail("the tp int8 forward is not finite")
    out["errors"]["int8"] = dist(a, b)
    out["errors"]["int8_single_vs_bf16_single"] = drift = dist(
        b, single["bf16"]["out"])
    out["errors"]["int8_tp_vs_bf16_tp"] = dist(a, res["outputs"]["bf16"])
    if not all(out["errors"]["int8"][m] <= INT8_TP_DRIFTS * drift[m]
               for m in drift):
        fail(f"tp int8 shape step vs one device's int8 twin "
             f"{out['errors']['int8']}: farther than {INT8_TP_DRIFTS} times "
             f"one device's int8 twin's distance from its bf16 twin {drift}")
    r0 = res["ranks"][0]
    print(f"tp shape step at full width, 2 gloo ranks sharing cuda:0 (one "
          f"card through host memory, not a scaling number): bf16 "
          f"{r0['bf16_ms']:.3f} / {res['ranks'][1]['bf16_ms']:.3f} ms a "
          f"forward per rank against {single['bf16']['ms']:.3f} ms on one "
          f"device; f32 {r0['f32_ms']:.3f} / {res['ranks'][1]['f32_ms']:.3f}"
          f" against {single['f32']['ms']:.3f}; int8 {r0['int8_ms']:.3f} / "
          f"{res['ranks'][1]['int8_ms']:.3f} against "
          f"{single['int8']['ms']:.3f}; K1 5 a forward per rank at "
          f"({rows}, 1024, 4, 56); int8 launches a forward per rank "
          f"{json.dumps(want_int8)}; the row-split Int8Conv3d at "
          f"{r0['row_split_check']['site']} (a rank's "
          f"{r0['row_split_check']['x_shape']}) bit-equal to the unsharded "
          f"one and between the ranks; vs one device "
          f"{json.dumps(out['errors'])}; {seconds:.1f} s with the ranks' "
          f"start [{card}]")
    return out


def tp_tiny_gloo(card: str) -> dict:
    """Phase 12 (c): the tiny dp x tp step (layout width 512, as phase 3)
    over 4 gloo ranks sharing cuda:0, a (2, 2) mesh, against the same ranks
    on the CPU forced down the card's ReLU branches, as phase 11 (b): the
    loss within LOSS_RTOL, the first moments (gathered to full tensors)
    within GRAD_LEAF_RTOL of their part's peak, each flipped input within
    RELU_MARGIN of its call's peak."""
    from echoscene_torch.models.config import tiny_config
    from echoscene_torch.parallel.dryrun import run_job, tiny_job

    cfg = tiny_config()
    cfg.layout_denoiser.model_channels = 512
    jobs = []
    for where in ("cuda:0", "cpu"):
        job = tiny_job([where] * 4, steps=1, cfg=cfg, draws=True,
                       model_par=2)
        job["deterministic"] = True
        job["runs"] = [{"name": "dp_tp", "mode": "dp",
                        "shards": job.pop("shards")}]
        jobs.append(job)
    t0 = time.perf_counter()
    jobs[0]["relu"] = "record"
    card_res = run_job(jobs[0], "gloo")
    jobs[1]["relu"] = {"dp_tp": card_res["dp_tp"]["relu_masks"]}
    cpu_res = run_job(jobs[1], "gloo")
    seconds = time.perf_counter() - t0
    kernel_runs = (card_res["dp_tp"]["attention_launches"],
                   card_res["dp_tp"]["attention_backward_launches"])
    if any(kernel_runs):
        fail(f"the tiny dp x tp step launched attention kernels "
             f"{kernel_runs}, want none (64 tokens, f32)")
    rel, of_part, bad = run_against(card_res["dp_tp"], cpu_res["dp_tp"])
    flips = cpu_res["dp_tp"]["relu_flips"]
    margin = cpu_res["dp_tp"]["relu_margin"]
    if not (rel <= LOSS_RTOL and not bad and margin <= RELU_MARGIN):
        fail(f"dp x tp step, 4 gloo ranks on cuda:0 vs the CPU on the card's "
             f"ReLU branches: loss rel err {rel:.3e} (limit {LOSS_RTOL}); "
             f"first moments off by more than {GRAD_LEAF_RTOL} of their "
             f"part's peak: {bad[:6]}; {flips} ReLU inputs on the other side "
             f"of 0, the largest {margin:.3e} of its call's peak (limit "
             f"{RELU_MARGIN})")
    hops = card_res["host_hops"]
    if not hops:
        fail("gloo on cuda:0 ran no collective through host memory")
    out = {"loss_rel_err": rel, "moment_err_of_part_peak": of_part,
           "relu_flips": flips, "relu_margin": margin,
           "host_hops_rank0": hops, "seconds": seconds}
    print(f"dp x tp step (tiny config, mesh 2 x 2) over 4 gloo ranks sharing "
          f"cuda:0 against the CPU's ranks on the card's ReLU branches: "
          f"{json.dumps(out)} [{card}]")
    return out


def tp_path(rows: int, card: str) -> dict:
    """Phase 12: tensor parallelism on the one card, (a) to (c).  (a) holds
    the ranks against a freshly built seeded flagship (the phase-4 model
    has trained since); (b) runs in its own process beside (c), both on
    tiny models, and is stopped if (c) fails."""
    import torch
    from echoscene_torch.benchmarks import build_flagship

    t0 = time.perf_counter()
    ref, batch = build_flagship(device="cuda")
    out = {"forward": tp_forward(ref, batch, rows, card)}
    del ref
    torch.cuda.empty_cache()
    started = dryrun_start("--n", "4", "--devices",
                           ",".join(["cuda:0"] * 4))
    try:
        out["tiny"] = tp_tiny_gloo(card)
        out["dryrun"] = dryrun_wait(started, card)
    finally:
        stop(started)
    out["phase_s"] = time.perf_counter() - t0
    return out


def int8_path(card: str, sites: dict, norms_per_step: int) -> dict:
    """Phase 13: bench.py's fast profile at full width, `build_flagship(
    fast_profile=True)`: int8 W8A8 shape-torso convolutions, DPM++ 50
    layout / 20 shape steps, on the flagship batch.  One generation with
    every count set to 0 just before and read just after (K1 = 5 a shape
    step, K2 = one a decode chunk, Q2 = `q2_calls_per_step` and Q1 =
    `q1_calls_per_step` a shape step, the fused norm `norms_per_step` a
    shape step), finite outputs of the JAX shapes; one shape step of the
    int8 twin and of the bf16 twin on the same weights and inputs (the
    difference of the outputs); the service at the fast profile with
    sample_dtype int8 (warmup, a short stream of 8 requests from 4
    clients, the counts per dispatch); one shape step of the
    `sample_conv: winograd` twin and of the direct bf16 twin (the error)."""
    import numpy as np
    import torch
    from echoscene_torch.benchmarks import (NUM_OBJS, NUM_PREDS,
                                            build_flagship,
                                            concurrent_latency, part_calls)
    from echoscene_torch.data.clip_text import ClipTextEncoder
    from echoscene_torch.data.collate import CollateSpec
    from echoscene_torch.data.fake import make_fake_dataset
    from echoscene_torch.data.sgfront import SGFrontDataset
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.kernels import group_norm as gnk
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.models.sgdiff import (inference_twin,
                                               shape_row_capacity)
    from echoscene_torch.serve.service import GenerationService

    t_phase = time.perf_counter()
    sg, batch = build_flagship(device="cuda", fast_profile=True)
    cfg = sg.cfg
    assert cfg.sample_dtype == "int8" and cfg.shape_branch.ddim_steps == 20
    rows = shape_row_capacity(batch, multiple=1)
    steps = sg.ddim_tables.num_steps
    out = {"rows": rows, "shape_steps": steps,
           "layout_steps": cfg.layout_diffusion.sample_steps}

    def reset():
        torch.cuda.synchronize()
        fa.reset_launches()
        q8.reset_launches()
        gnk.reset_launches()

    def counts():
        torch.cuda.synchronize()
        return {**fa.LAUNCHES, **q8.LAUNCHES, **gnk.LAUNCHES}

    # 1. one generation, counted
    reset()
    gen = sg.sample_fn(batch, torch.Generator(device=sg.device).manual_seed(1),
                       shape_rows=rows)
    got = counts()
    want = {"onepass_attention": 5 * steps,
            "stream_attention": math.ceil(rows / 8),
            "quantize_act": sites["q1_calls_per_step"] * steps,
            "int8_conv3d": sites["q2_calls_per_step"] * steps,
            "group_norm_act": norms_per_step * steps,
            # one device: no row-split convolution
            "quantize_amax": 0, "quantize_with_amax": 0,
            "int8_conv3d_acc": 0}
    if got != want:
        fail(f"int8 fast profile launched {got}, want {want}")
    n = batch.num_nodes
    for key, shp in {"sizes": (n, 3), "translations": (n, 3),
                     "angles": (n, 1), "shapes": (n, 64, 64, 64, 1)}.items():
        if tuple(gen[key].shape) != shp or not bool(
                torch.isfinite(gen[key].float()).all()):
            fail(f"int8 fast profile output {key}: shape "
                 f"{tuple(gen[key].shape)}, want {shp}, or not finite")
    if not bool(gen["shapes"][:rows].float().abs().sum() > 0):
        fail("int8 fast profile: the real rows' SDFs are all zero")
    out.update(launches=got)
    print(f"int8 fast profile generation (DPM++ 50 / 20, int8 torso): "
          f"launches {json.dumps(got)} (Q2 "
          f"{sites['q2_calls_per_step']} and Q1 "
          f"{sites['q1_calls_per_step']} a shape step) [{card}]")

    # 2. one shape step int8 beside bf16
    twin8 = sg.inference_module()
    twin16 = inference_twin(sg.module, torch.bfloat16)
    with torch.no_grad():
        a = part_calls(sg, batch, rows, twin8)["shape_step"]().float()
        b = part_calls(sg, batch, rows, twin16)["shape_step"]().float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail("int8 / bf16 shape step not finite")
    diff = {"max_of_peak": ((a - b).abs().max() / b.abs().max()).item(),
            "mean_of_mean": ((a - b).abs().mean() / b.abs().mean()).item()}
    out.update(int8_vs_bf16=diff)
    print(f"int8 vs bf16 twin shape step outputs: {json.dumps(diff)} "
          f"[{card}]")
    del a, b, twin16

    # 3. the service at the fast profile, sample_dtype int8
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
    svc = GenerationService(sg, spec, ds.box_stats, ds.classes, ds.rel_dict,
                            clip=clip, row_buckets=(16, 32, 48),
                            result_format="arrays", gen_shape=True, seed=0)
    dispatch_rows = []
    sample_fn = sg.sample_fn

    def logged(batch_, generator=None, **kw):
        dispatch_rows.append(kw["shape_rows"])
        return sample_fn(batch_, generator, **kw)
    sg.sample_fn = logged
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_warm = svc.warmup(manips=(False,), verbose=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    names = [c for c in ds.classes if c != "_scene_"]
    preds = list(ds.rel_dict)
    rng = np.random.default_rng(13)

    def request(rid):
        k = int(rng.integers(3, 7))
        return {"id": rid,
                "objects": [names[int(i)] for i in rng.integers(
                    0, len(names), k)],
                "triples": [[0, preds[int(rng.integers(len(preds)))], j]
                            for j in range(1, k)]}
    reqs = [request(f"q{i}") for i in range(8)]
    dispatch_rows.clear()
    reset()
    stream = concurrent_latency(svc, reqs, 10.0, 4)
    got = counts()
    sg.sample_fn = sample_fn
    nd = len(dispatch_rows)
    want = {"onepass_attention": 5 * steps * nd,
            "stream_attention": sum(math.ceil(r / 8) for r in dispatch_rows),
            "quantize_act": sites["q1_calls_per_step"] * steps * nd,
            "int8_conv3d": sites["q2_calls_per_step"] * steps * nd,
            "group_norm_act": norms_per_step * steps * nd,
            "quantize_amax": 0, "quantize_with_amax": 0,
            "int8_conv3d_acc": 0}
    results = stream["results"]
    if not nd or got != want:
        fail(f"int8 service: {nd} dispatches at rows {dispatch_rows} "
             f"launched {got}, want {want}")
    if sorted(results) != list(range(len(reqs))) or not all(
            np.isfinite(np.asarray(r[k])).all() for r in results.values()
            for k in ("sizes", "translations", "angles", "sdfs") if k in r):
        fail("int8 service: results missing or not finite")
    lat = np.asarray(stream["latencies_s"])
    out["service"] = {
        "warmup_variants": n_warm, "warmup_s": warm_s, "requests": len(reqs),
        "dispatch_rows": list(dispatch_rows),
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p95_s": float(np.percentile(lat, 95)),
        "req_per_sec": stream["req_per_sec"], "launches": got}
    print(f"int8 service (fast profile): warmup {n_warm} variants in "
          f"{warm_s:.3f} s; {len(reqs)} requests from 4 clients, p50 "
          f"{out['service']['latency_p50_s']:.3f} s, p95 "
          f"{out['service']['latency_p95_s']:.3f} s, "
          f"{stream['req_per_sec']:.4f} requests/sec, dispatches at rows "
          f"{dispatch_rows}; launches {json.dumps(got)} [{card}]")
    del svc

    # 4. the Winograd twin's shape step beside the direct bf16 twin's
    wino = inference_twin(sg.module, torch.bfloat16, winograd=True)
    direct = inference_twin(sg.module, torch.bfloat16)
    with torch.no_grad():
        a = part_calls(sg, batch, rows, wino)["shape_step"]().float()
        b = part_calls(sg, batch, rows, direct)["shape_step"]().float()
    if not torch.isfinite(a).all():
        fail("the Winograd twin's shape step is not finite")
    w_diff = {"max_of_peak": ((a - b).abs().max() / b.abs().max()).item(),
              "mean_of_mean": ((a - b).abs().mean()
                               / b.abs().mean()).item()}
    out.update(winograd_vs_direct=w_diff)
    print(f"Winograd twin vs direct bf16 twin shape step outputs: "
          f"{json.dumps(w_diff)} [{card}]")
    del wino, direct, a, b, sg, twin8
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
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
    from echoscene_torch.benchmarks import build_flagship, synthetic_batch
    from echoscene_torch.kernels import build
    from echoscene_torch import native
    from echoscene_torch.kernels import chamfer as k4
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.kernels import group_norm as gnk
    from echoscene_torch.kernels import int8_conv as q8
    from echoscene_torch.models.sgdiff import set_precision, shape_row_capacity

    set_precision()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build: one nvcc per source, all started together
    sources = (fa.SOURCE, fa.SOURCE_BWD, fa.SOURCE_F32, k4.SOURCE, q8.SOURCE,
               gnk.SOURCE)
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
    # the backward kernel's instantiations must not spill
    spills = re.findall(r"(\d+) bytes spill stores", built[fa.SOURCE_BWD][1])
    if not spills or any(int(x) for x in spills):
        fail(f"{fa.SOURCE_BWD}: spill stores {spills} in its ptxas report")

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
              f"time), plain "
              f"{e['plain_ms']:.3f} ms; host {e['host_us_per_call']:.1f} us "
              f"per wrapper call; max abs err {e['max_abs_err']:.3e}, max / "
              f"mean err at {e['err_of_limit'][0]:.3f} / "
              f"{e['err_of_limit'][1]:.3f} of their limits, 32 keys left out "
              f"at {e['keys_dropped_err_of_limit'][0]:.3f} / "
              f"{e['keys_dropped_err_of_limit'][1]:.3f} [{card}]")
    # K1 at a tensor-parallel rank's head shard (phase 12: 4 of the 8)
    tp_entry = check_kernel("onepass_attention", fa.onepass_attention,
                            (rows, 1024, 4, 56), [],
                            "echoscene_tpu/kernels/flash_attention.py:73",
                            clock)
    tp_entry["name"] = "onepass_attention_tp_shard"
    print(f"kernel onepass_attention {tp_entry['shape']} (a tp rank's 4 "
          f"heads): {tp_entry['ms']:.4f} ms, {tp_entry['share_of_bound']:.3f}"
          f" of the bound {tp_entry['bound_ms']:.4f} ms (by "
          f"{tp_entry['bound_by']}); sdpa {tp_entry['library_ms']:.4f} ms, "
          f"plain {tp_entry['plain_ms']:.3f} ms; max abs err "
          f"{tp_entry['max_abs_err']:.3e} [{card}]")
    # K1 / K2 at the training shapes, through the differentiable Function:
    # the bf16 backward kernel
    t0 = time.perf_counter()
    bwd_entries = []
    for e in entries:
        fields, bwd = check_kernel_backward(
            e["name"], getattr(fa, e["name"]), BWD_SHAPES[e["name"]], clock)
        e.update(fields)
        bwd_entries.append(bwd)
        for c in bwd["checks"]:
            r = c["grad_err_of_limit"]
            print(f"kernel {bwd['name']} {c['shape']}: dq / dk / dv max err "
                  f"at {r['dq'][0]:.3f} / {r['dk'][0]:.3f} / "
                  f"{r['dv'][0]:.3f} and mean err at {r['dq'][1]:.3f} / "
                  f"{r['dk'][1]:.3f} / {r['dv'][1]:.3f} of the bf16 limits "
                  f"against plain autograd; max err against float64 "
                  f"{json.dumps(c['grad_f64_max_err_vs_plain'])} x plain "
                  f"autograd's; dq with 32 keys left out at "
                  f"{c['dq_keys_dropped_err_of_limit'][0]:.1f} / "
                  f"{c['dq_keys_dropped_err_of_limit'][1]:.1f}; two runs "
                  f"bit-equal; lse within {c['lse_max_diff']:.2e} [{card}]")
        d = bwd["bound_detail"]
        print(f"kernel {e['name']} {e['train_shape']} forward + backward: "
              f"{e['fwd_bwd_ms']:.4f} ms (backward kernel alone "
              f"{bwd['ms']:.4f} ms, {bwd['tflops']:.1f} TFLOP/s, "
              f"{bwd['share_of_bound']:.3f} of its bound {bwd['bound_ms']:.4f}"
              f" ms by {d['by']}: tensor cores {d['tensor_core_ms']:.4f}, "
              f"exp2 {d['exp2_ms']:.4f}, bytes {d['bytes_ms']:.4f}); bound "
              f"of forward + backward {e['fwd_bwd_bound_ms']:.4f} ms (by "
              f"{e['fwd_bwd_bound_by']}); sdpa forward"
              f" + backward {e['library_fwd_bwd_ms']:.4f} ms "
              f"({e['fwd_bwd_vs_library']:.3f} x its time), its backward "
              f"alone {bwd['library_ms']:.4f} ms (the backward kernel "
              f"{bwd['backward_vs_library']:.3f} x its time); host "
              f"{bwd['host_us_per_call']:.1f} us per attention_backward call;"
              f" plain forward + backward "
              f"{e['plain_fwd_bwd_ms']:.4f} ms, plain backward alone "
              f"{bwd['plain_ms']:.4f} ms [{card}]")
    print(f"backward kernel checks took {time.perf_counter() - t0:.1f} s")
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
              f"x its time), plain "
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
              f"pair); cdist+amin {p['library_ms']:.4f} ms, plain "
              f"{p['plain_ms']:.3f} ms; host "
              f"{p['host_us_per_call']:.1f} us per wrapper call; max abs err "
              f"{p['max_abs_err']:.3e}, max / mean err at "
              f"{p['err_of_limit'][0]:.3f} / {p['err_of_limit'][1]:.3f} of "
              f"their limits, {p['ulp']:.0f} ulp (floor {p['ulp_floor']:.2e})"
              f", chamfer rel err {p['chamfer_rel_err']:.3e} [{card}]")
    print(f"kernel {e['name']}: 64 targets left out at "
          f"{e['targets_dropped_err_of_limit'][0]:.1f} / "
          f"{e['targets_dropped_err_of_limit'][1]:.1f} of the limits")

    # Q1 / Q2 (int8 W8A8) at every convolution of the flagship's int8 torso
    t0 = time.perf_counter()
    q8chk = check_int8_kernels(rows)
    int8_kernel_entries = int8_entries(q8chk)
    for r in q8chk["q1"]:
        print(f"kernel quantize_act {r['shape']} {r['dtype']}: "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes), "
              f"share {r['bound_ms'] / r['ms']:.3f}; plain "
              f"{r['plain_ms']:.3f} ms; {r['calls_per_step']} a shape step; "
              f"bit-equal [{card}]")
    for r in q8chk["q2"]:
        print(f"kernel int8_conv3d {r['name']} {r['shape']} -> {r['k']} taps "
              f"{r['taps']} stride {r['stride']}: {r['ms']:.4f} ms, "
              f"{r['tops']:.1f} TOP/s, {r['share_of_bound']:.3f} of the "
              f"bound {r['bound_ms']:.4f} ms (by {r['bound_by']}); cuDNN bf16 "
              f"{r['cudnn_bf16_ms']:.4f} ms, im2col + _int_mm "
              f"{r['int_mm_route_ms']:.4f} ms (_int_mm alone "
              f"{r['int_mm_ms']:.4f}), plain {r['plain_ms']:.2f} ms; "
              f"{r['calls_per_step']} a shape step; {r['max_ulps']} ulp (last"
              f" input channel cut: {r['last_channel_cut_ulps']}) [{card}]")
    for e in int8_kernel_entries:
        print(f"kernel {e['name']} per shape step (the torso's shapes x "
              f"their calls): {json.dumps(e['per_step_totals'])} [{card}]")
    gnchk = check_group_norm_kernel()
    print_group_norm(gnchk, card)
    tpchk = check_tp_int8_kernels(rows)
    tp_int8_kernel_entries = tp_int8_entries(tpchk)
    for r in tpchk["q1"]:
        a, w = r["amax"], r["with_amax"]
        print(f"kernel quantize_amax at a tp rank's shard {r['shape']} of "
              f"{r['whole_tensor']}: {a['ms']:.4f} ms, bound "
              f"{a['bound_ms']:.4f} ms (bytes), share "
              f"{a['bound_ms'] / a['ms']:.3f}; vector_norm(inf) "
              f"{a['library_ms']:.4f} ms; plain {a['plain_ms']:.3f} ms; "
              f"quantize_with_amax {w['ms']:.4f} ms, bound "
              f"{w['bound_ms']:.4f} ms, share {w['bound_ms'] / w['ms']:.3f}; "
              f"plain {w['plain_ms']:.3f} ms; both passes {r['both_ms']:.4f}"
              f" ms (fused Q1 on the shard {r['fused_ms']:.4f}); "
              f"{r['calls_per_rank_step']} a rank's shape step; bit-equal "
              f"[{card}]")
    for r in tpchk["q2"]:
        print(f"kernel int8_conv3d_acc {r['name']} {r['shape']} (Cp "
              f"{r['cp']}) -> {r['k']}: {r['ms']:.4f} ms, "
              f"{r['share_of_bound']:.3f} of the bound {r['bound_ms']:.4f} "
              f"ms (by {r['bound_by']}); bf16 Q2 at the same shape "
              f"{r['bf16_q2_ms']:.4f} ms; cuDNN bf16 {r['cudnn_bf16_ms']:.4f}"
              f" ms; im2col + _int_mm {r['int_mm_route_ms']:.4f} ms; plain "
              f"{r['plain_ms']:.2f} ms; {r['calls_per_rank_step']} a rank's "
              f"shape step; exact, dequantize bit-equal to the fused "
              f"epilogue [{card}]")
    col = tpchk["column_split"]
    print(f"kernel int8_conv3d, a tp rank's column split 224 -> 112 at "
          f"16^3: {col[112]['ms']:.4f} ms ({col[112]['share_of_bound']:.3f}"
          f" of its bound) against the whole 224 -> 224 "
          f"{col[224]['ms']:.4f} ms ({col[224]['share_of_bound']:.3f}): "
          f"{col[112]['ms'] / col[224]['ms']:.3f} of the time for half the "
          f"work [{card}]")
    print(f"int8 kernel checks took {time.perf_counter() - t0:.1f} s")

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
    gnk.reset_launches()
    out = sg.sample_fn(batch, torch.Generator(device=sg.device).manual_seed(1),
                       shape_rows=rows)
    torch.cuda.synchronize()
    launches = {**fa.LAUNCHES, **gnk.LAUNCHES}
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
            "stream_attention": math.ceil(rows / 8),
            # every norm of every shape step fused
            "group_norm_act": (gnchk["calls_per_step"]
                               * sg.ddim_tables.num_steps)}
    for name, count in want.items():
        if launches[name] != count:
            fail(f"{name} launched {launches[name]} times, want {count}")
    for e in entries[:2]:
        e["launches"] = launches[e["name"]]
    gn_launches = launches["group_norm_act"]
    print(f"generation: {batch.num_scenes} scenes, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    print(f"launches on the main path: {json.dumps(launches)}")

    # 5. the twin's factored upsamples against interpolate + conv
    ups = upsample_sites(rows)
    print(f"factored upsamples against interpolate + conv in f32: "
          f"{json.dumps(ups)} [{card}]")

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
    # the backward kernel's main path: phase 7's K1 (5 a step), phase 9's
    # bf16 VQ-VAE step for K2 (2 a step, set below)
    bwd_entries[0]["launches"] = tr["backward_launches_per_step"] * tr["steps"]
    bwd_entries[0]["train_launches_per_step"] = tr[
        "backward_launches_per_step"]
    print(f"training: {tr['steps']} steps (8 scenes, diffusion_bs 8, bf16, "
          f"remat), peak memory {tr['peak_gib']:.2f} GiB; diffusion_bs 64: "
          f"peak memory {tr['peak_gib_diffusion_bs_64']:.2f} GiB [{card}]")
    print(f"training in f32 (compute_dtype float32): one step, peak memory "
          f"{tr['f32_peak_gib']:.2f} GiB, loss {tr['f32_loss']:.6g}, launches "
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
    bwd_entries[1]["launches"] = 3 * vq["bf16_backward_launches_per_step"]
    bwd_entries[1]["vq_bf16_launches_per_step"] = vq[
        "bf16_backward_launches_per_step"]
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
    # 11. data parallelism on the one card: the dp and ZeRO-1 steps at full
    # width over one NCCL rank, tiny ranks on gloo sharing the card, the
    # service over two shards of the card, the dry run
    dp = dp_path(sg, card, sv)
    for e, b in zip(entries[:2], bwd_entries):
        b["dp_train_launches_per_rank_step"] = dp["train"]["runs"]["dp"][
            "backward_launches"].get(f"{e['name']}/bfloat16", 0)
        b["zero1_train_launches_per_rank_step"] = dp["train"]["runs"][
            "zero1"]["backward_launches"].get(f"{e['name']}/bfloat16", 0)
    for e in entries[:2]:
        e["dp_train_launches_per_rank_step"] = dp["train"]["runs"]["dp"][
            "launches"][e["name"]]
        e["zero1_train_launches_per_rank_step"] = dp["train"]["runs"][
            "zero1"]["launches"][e["name"]]
        e["dp_serve_launches_per_shard_call"] = dp["serve"]["launches"][
            e["name"]] // dp["serve"]["shards"]
    entries[2]["dp_launches"] = dp["k4_launches"]
    print(f"dp details: {json.dumps(dp)}; phase 11 took "
          f"{dp['phase_s']:.1f} s")
    # 12. tensor parallelism on the one card: the full-width shape step
    # over 2 gloo ranks, the (2, 2) dry run, the tiny dp x tp step vs CPU
    tp = tp_path(rows, card)
    tp_entry["launches"] = tp["forward"]["ranks"][0]["bf16_launches"][
        "onepass_attention"]
    tp_entry["launches_per_rank"] = [
        r["bf16_launches"]["onepass_attention"]
        for r in tp["forward"]["ranks"]]
    for e in tp_int8_kernel_entries:
        e["launches"] = tp["forward"]["ranks"][0]["int8_launches"][e["name"]]
        e["launches_per_rank"] = [r["int8_launches"][e["name"]]
                                  for r in tp["forward"]["ranks"]]
    print(f"tp details: {json.dumps(tp)}; phase 12 took "
          f"{tp['phase_s']:.1f} s")
    # 13. bench.py's fast profile: int8 torso, DPM++ 50 / 20, at full width
    i8 = int8_path(card, q8chk, gnchk["calls_per_step"])
    for e in int8_kernel_entries:
        e["launches"] = i8["launches"][e["name"]]
        e["service_launches"] = i8["service"]["launches"][e["name"]]
    for e in entries[:2]:
        e["int8_profile_launches"] = i8["launches"][e["name"]]
    gn_int8_launches = {"int8_profile_launches": i8["launches"][
        "group_norm_act"], "service_launches": i8["service"]["launches"][
        "group_norm_act"]}
    print(f"int8 details: {json.dumps(i8)}; phase 13 took "
          f"{i8['phase_s']:.1f} s")
    entries.append(tp_entry)
    entries[2:2] = f32_entries + [k2_train]
    entries[2:2] = bwd_entries
    for e in entries:
        e["status"] = "ported: built, matches its plain version, on the path"
    entries += int8_kernel_entries + tp_int8_kernel_entries
    entries.append(dict(group_norm_entry(gnchk, gn_launches),
                        **gn_int8_launches))

    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
