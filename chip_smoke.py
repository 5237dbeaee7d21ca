#!/usr/bin/env python3
"""Smoke run of the PyTorch port (echoscene_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):
  1. build the CUDA kernels from the source in the checkout and print the
     build seconds;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it, plus one small ragged case (bf16 inputs,
     against the f32-accumulated plain version: max abs error <= 2^-6 of the
     plain output's peak and mean abs error <= 1e-2 of its mean magnitude,
     `flash_attention.error_ratios`); check that this tolerance rejects the
     plain version with its last 32 keys left out; and time the kernel, the
     plain version and, as a yardstick the port never calls, torch's
     scaled_dot_product_attention;
  3. check the port on the card against the port on the CPU at the tiny
     test configuration in f32 (same weights, same injected noise;
     max abs error <= 1e-4 on boxes and SDFs);
  4. drive the main path once: full-width flagship generation (1000-step
     layout DDPM + 100-step shape DDIM + chunked VQ decode) on the seeded
     8-scene synthetic batch, with every kernel launch count set to 0 just
     before and read just after; checks finite outputs of the JAX output
     shapes and the launch counts (K1 = 5 per DDIM step, K2 = one per
     decode chunk);
  5. time each part of that path alone (graph context, one layout step, one
     shape step, one decode chunk): wall clock per call, and the device busy
     share and kernel launches of one call under torch.profiler.

Prints the `kernels` JSON line, the card's name and power limit
(nvidia-smi), and as its last line
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
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ATOL_TINY = 1e-4
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3


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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(name, wrapper, shape, ragged_shape, replaces):
    """Phase 2 for one attention kernel; returns its `kernels` entry."""
    import torch
    import torch.nn.functional as F
    from echoscene_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shp in (ragged_shape, shape):
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
    b, l, h, d = shape
    ms = cuda_ms(lambda: wrapper(q, k, v), iters=20)
    plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v), iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                         iters=20)
    # bound: two products of 2 L S D flops per head; q, k, v read once and
    # o (q-sized) written once
    flop_s = 4 * b * h * l * k.shape[1] * d / PEAK_BF16_FLOPS
    byte_s = (2 * q.numel() + k.numel() + v.numel()) * 2 / PEAK_BYTES
    return {"name": name, "route": "cuda",
            "source": "echoscene_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(flop_s, byte_s) * 1e3,
            "bound_by": "operations" if flop_s >= byte_s else "bytes",
            "library_ms": library_ms, "shape": list(shape),
            "err_of_limit": ratios, "keys_dropped_err_of_limit": dropped}


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


def main() -> int:
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
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.models.sgdiff import set_precision, shape_row_capacity

    set_precision()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    report = build.build(fa.SOURCE)
    build.load(fa.SOURCE)
    print(f"build: {time.perf_counter() - t0:.2f} s for {fa.SOURCE}")
    for line in report.splitlines():
        fn = re.search(r"Compiling entry function '(\S+)'", line)
        if fn:
            print(f"  {fn.group(1)}")
        elif "registers" in line or "spill" in line:
            print(f"    {line.strip()}")

    # the main path's row count fixes K1's batch dimension
    rows = shape_row_capacity(synthetic_batch(), multiple=1)

    # 2. kernels against their plain versions at the main path's shapes
    entries = [
        check_kernel("onepass_attention", fa.onepass_attention,
                     (rows, 1024, 8, 56), (3, 200, 2, 24),
                     "echoscene_tpu/kernels/flash_attention.py:73"),
        check_kernel("stream_attention", fa.stream_attention,
                     (8, 4096, 1, 256), (2, 77, 3, 130),
                     "echoscene_tpu/kernels/flash_attention.py:35"),
    ]
    for e in entries:
        print(f"kernel {e['name']} {e['shape']}: {e['ms']:.4f} ms "
              f"(bound {e['bound_ms']:.4f} ms by {e['bound_by']}, plain "
              f"{e['plain_ms']:.3f} ms, sdpa {e['library_ms']:.4f} ms), "
              f"max abs err {e['max_abs_err']:.3e}; max / mean err at "
              f"{e['err_of_limit'][0]:.3f} / {e['err_of_limit'][1]:.3f} of "
              f"their limits, 32 keys left out at "
              f"{e['keys_dropped_err_of_limit'][0]:.3f} / "
              f"{e['keys_dropped_err_of_limit'][1]:.3f} [{card}]")

    # 3. the rest of the port on the card vs on the CPU, tiny config
    err = check_tiny_against_cpu()
    print(f"tiny config, CUDA vs CPU f32 sample: max abs err {err:.3e}")

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
    for e in entries:
        e["launches"] = launches[e["name"]]
        e["status"] = "ported: built, matches its plain version, on the path"
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

    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
