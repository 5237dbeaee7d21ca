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
     * K4 (nearest-neighbour distance): surface-like f32 clouds (points on
       spheres of radius 0.3-0.5) against the plain version in float64, max
       abs error <= 1e-6 (max|a|^2 + max|b|^2) per point and each mean
       distance and chamfer value within 1e-5 relative (`chamfer.
       error_ratios`), a tolerance that must reject the plain version with
       its last 64 targets left out; yardstick cdist(a, b)^2 min;
  3. check the port on the card against the port on the CPU: the tiny
     test configuration in f32 (same weights, same injected noise; max abs
     error <= 1e-4 on boxes and SDFs), and MMD / COV / 1-NN over 6 clouds of
     256 points (CD values within 1e-5 relative, auction-EMD values within
     1e-4);
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
     the launch counts (K1 / K2 of the generation; K4 = 48 for the metrics
     plus 2 per scene with an annotated pair for the consistency), with
     every count set to 0 just before and read just after.

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
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ATOL_TINY = 1e-4
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
CD_RTOL = 1e-5               # chamfer values, card vs plain / CPU
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
    return {"name": name, "route": "cuda",
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


def sphere_clouds(b: int, n: int, gen, device="cuda"):
    """(b, n, 3) f32 points on one sphere per batch entry (radius 0.3-0.5,
    centre within 0.1 of the origin): surface-like clouds whose neighbour
    distances are small, as in sampled meshes."""
    import torch
    radius = 0.3 + 0.2 * torch.rand((b, 1, 1), generator=gen, device=device)
    centre = 0.2 * torch.rand((b, 1, 3), generator=gen, device=device) - 0.1
    dirs = torch.randn((b, n, 3), generator=gen, device=device)
    return (centre + radius * dirs / dirs.norm(dim=-1, keepdim=True)).float()


def check_chamfer_kernel(shape, ragged_shape):
    """Phase 2 for K4; returns its `kernels` entry."""
    import torch
    from echoscene_torch.kernels import chamfer as k4
    from echoscene_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, n, m in (ragged_shape, shape):
        # one sphere per entry for both clouds: draw them together
        both = sphere_clouds(b, n + m, gen)
        a, t = both[:, :n].contiguous(), both[:, n:].contiguous()
        out = k4.nn_distance_oneway(a, t)
        torch.cuda.synchronize()
        ref = k4.nn_distance_plain(a.double(), t.double())
        ratios = k4.error_ratios(out, ref, a, t)
        cd = k4.chamfer(a, t).double()
        cd_ref = ref.mean(1) + k4.nn_distance_plain(t.double(),
                                                    a.double()).mean(1)
        cd_rel = ((cd - cd_ref).abs() / cd_ref).max().item()
        if not (max(ratios) <= 1.0 and cd_rel <= CD_RTOL):
            fail(f"nn_distance at {(b, n, m)}: max err / mean err at "
                 f"{ratios[0]:.3f} / {ratios[1]:.3f} of their limits, "
                 f"chamfer rel err {cd_rel:.3e} (limit {CD_RTOL})")
    err = (out.double() - ref).abs().max().item()
    dropped = k4.error_ratios(
        k4.nn_distance_plain(a.double(), t[:, :-64].double()), ref, a, t)
    if not min(dropped) > 1.0:
        fail(f"nn_distance: the tolerance passes the plain version with 64 "
             f"targets left out ({dropped[0]:.3f} / {dropped[1]:.3f})")
    ms = cuda_ms(lambda: k4.nn_distance_oneway(a, t), iters=20)
    plain_ms = cuda_ms(lambda: k4.nn_distance_plain(a, t), iters=3, warmup=1)
    library_ms = cuda_ms(lambda: torch.cdist(a, t).square().amin(2),
                         iters=10)
    # bound: 8 flops per (query, target) pair on the f32 pipes; a and b read
    # once, the (B, N) distances written once
    flop_s = 8 * b * n * m / PEAK_F32_FLOPS
    byte_s = (b * n * 3 + b * m * 3 + b * n) * 4 / fa.PEAK_BYTES
    return {"name": "nn_distance", "route": "cuda",
            "source": "echoscene_torch/csrc/chamfer.cu",
            "replaces": "echoscene_tpu/kernels/chamfer_pallas.py:27",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(flop_s, byte_s) * 1e3,
            "bound_by": "operations" if flop_s >= byte_s else "bytes",
            "library_ms": library_ms, "shape": [b, n, m],
            "err_of_limit": ratios, "chamfer_rel_err": cd_rel,
            "targets_dropped_err_of_limit": dropped}


def check_metrics_against_cpu() -> dict:
    """Phase 3: MMD / COV / 1-NN on the card vs on the CPU, 6 + 6 clouds of
    256 points, chamfer via K4 vs the Gram form, auction EMD on each."""
    import torch
    from echoscene_torch.eval.pointcloud_metrics import (compute_all_metrics,
                                                         emd_auction)

    gen = torch.Generator().manual_seed(3)
    sample = sphere_clouds(6, 256, gen, device="cpu").numpy()
    ref = sphere_clouds(6, 256, gen, device="cpu").numpy()
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


def analytic_sdf(kind: int, res: int, rng):
    """A seeded analytic SDF on a [-1, 1]^3 grid: sphere, box or ellipsoid
    (the ellipsoid's is the scaled-radius approximation)."""
    import numpy as np
    c = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    p = np.stack([x, y, z], -1)
    if kind == 0:
        return np.linalg.norm(p, axis=-1) - rng.uniform(0.3, 0.7)
    half = rng.uniform(0.25, 0.6, 3)
    if kind == 1:
        q = np.abs(p) - half
        return (np.linalg.norm(np.maximum(q, 0), axis=-1)
                + np.minimum(q.max(-1), 0))
    return (np.linalg.norm(p / half, axis=-1) - 1.0) * half.min()


def eval_path(sg, card: str) -> dict:
    """Phase 6: the evaluation path at flagship width; returns the K4 launch
    count of its metric steps and the wall seconds of each part."""
    import numpy as np
    import torch
    from echoscene_torch import native
    from echoscene_torch.benchmarks import NUM_OBJS, NUM_PREDS
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
        anns, pairs = {}, 0
        for ex in examples:
            by_cat = {}
            d = dumps[ex.scan_id]
            for iid, cat in zip(d["instance_ids"], d["categories"]):
                if iid >= 0:
                    by_cat.setdefault(str(cat), []).append(int(iid))
            groups = [g for g in by_cat.values() if len(g) > 1]
            if groups:
                anns[ex.scan_id] = groups
                pairs += sum(len(g) * (len(g) - 1) // 2 for g in groups)
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
        t0 = time.perf_counter()
        mmd = compute_all_metrics(gen_pcs, ref_pcs, batch_size=16,
                                  emd_fn=emd_auction)
        torch.cuda.synchronize()
        mmd_s = time.perf_counter() - t0
        launches = k4.LAUNCHES["nn_distance"]
        if not all(math.isfinite(v) for v in mmd.values()):
            fail(f"MMD / COV / 1-NN is not finite: {mmd}")
        want_k4 = 3 * 8 * 2 + 2 * len(anns)
        if launches != want_k4:
            fail(f"nn_distance launched {launches} times in the metric "
                 f"steps, want {want_k4}")
    print(f"eval SDF -> clouds: 16 clouds of 5000 points, {cloud_s:.3f} s "
          f"wall; native library: {native.available()} [{card}]")
    print(f"eval consistency: {pairs} pairs in {len(anns)} scenes, total "
          f"{agg['total']:.6g}, {cons_s:.3f} s wall [{card}]")
    print(f"eval MMD / COV / 1-NN: 8 vs 8 clouds, {json.dumps(mmd)}, "
          f"{mmd_s:.3f} s wall [{card}]")
    return {"nn_distance_launches": launches, "generation_s": gen_s,
            "clouds_s": cloud_s, "consistency_s": cons_s, "mmd_s": mmd_s}


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
    from echoscene_torch import native
    from echoscene_torch.kernels import chamfer as k4
    from echoscene_torch.kernels import flash_attention as fa
    from echoscene_torch.models.sgdiff import set_precision, shape_row_capacity

    set_precision()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build: one nvcc per source, all started together
    sources = (fa.SOURCE, BASELINE_SOURCE, k4.SOURCE)
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
                     (rows, 1024, 8, 56), [(3, 200, 2, 24), (3, 333, 8, 56)],
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
    # K4 at the metric shapes: a CD matrix row at batch_size 16 and 5000
    # points, and a ragged case
    e = check_chamfer_kernel((16, 5000, 5000), (3, 777, 1001))
    entries.append(e)
    print(f"kernel {e['name']} {e['shape']}: {e['ms']:.4f} ms (bound "
          f"{e['bound_ms']:.4f} ms by {e['bound_by']}, plain "
          f"{e['plain_ms']:.3f} ms, cdist+amin {e['library_ms']:.4f} ms), "
          f"max abs err {e['max_abs_err']:.3e}; max / mean err at "
          f"{e['err_of_limit'][0]:.3f} / {e['err_of_limit'][1]:.3f} of their "
          f"limits, chamfer rel err {e['chamfer_rel_err']:.3e}; 64 targets "
          f"left out at {e['targets_dropped_err_of_limit'][0]:.1f} / "
          f"{e['targets_dropped_err_of_limit'][1]:.1f} [{card}]")

    # 3. the rest of the port on the card vs on the CPU
    err = check_tiny_against_cpu()
    print(f"tiny config, CUDA vs CPU f32 sample: max abs err {err:.3e}")
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
    print(f"eval path wall seconds: {json.dumps(ev)}; native library "
          f"available: {native.available()} [{card}]")
    for e in entries:
        e["status"] = "ported: built, matches its plain version, on the path"

    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
