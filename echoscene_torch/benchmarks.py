"""Flagship model construction, generation / training / serving timing.

Port of `build_flagship`, `time_generation` and `time_train_step` of
echoscene_tpu/benchmarks.py, and of `concurrent_latency` of
scripts/bench_serve.py.  The flagship is EchoScene at full
`configs/full_mp.yaml` widths with seeded random weights (no checkpoint is
in the repository), on a seeded synthetic scene batch at the bench's shape:
8 scenes of 3-5 objects plus their `_scene_` root node, `max_nodes=48`,
`max_triples=112`, scene-major nodes with all padding at the tail, 512-d
unit-norm text / relation features in place of CLIP's, and for training a
greedy shape sub-batch of seeded analytic 64^3 SDFs (the card's machine has
no h5py to read a fake dataset's grids).
"""
from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .core.graphbatch import GraphBatch, SceneBatch, ShapeSelection
from .models.config import EchoSceneConfig, load_config
from .models.sgdiff import (SGDiff, TrainState, compact_graph,
                            shape_row_capacity)

# the fake SG-FRONT vocabulary of the JAX package's data/fake.py: 9 coarse
# classes (index 0 = `_scene_`) and "in" + 15 relationships
NUM_OBJS = 9
NUM_PREDS = 16
CLIP_DIM = 512

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def analytic_sdf(kind: int, res: int, rng: np.random.Generator
                 ) -> np.ndarray:
    """A seeded analytic SDF on a [-1, 1]^3 grid of res^3 points: sphere
    (kind 0), box (1) or ellipsoid (2; the scaled-radius approximation)."""
    c = np.linspace(-1, 1, res, dtype=np.float32)
    p = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1)
    if kind == 0:
        return np.linalg.norm(p, axis=-1) - rng.uniform(0.3, 0.7)
    half = rng.uniform(0.25, 0.6, 3)
    if kind == 1:
        q = np.abs(p) - half
        return (np.linalg.norm(np.maximum(q, 0), axis=-1)
                + np.minimum(q.max(-1), 0))
    return (np.linalg.norm(p / half, axis=-1) - 1.0) * half.min()


def synthetic_batch(batch_scenes: int = 8, max_nodes: int = 48,
                    max_triples: int = 112, seed: int = 0, min_objs: int = 3,
                    max_objs: int = 5, diffusion_bs: int = 0,
                    sdf_res: int = 64) -> SceneBatch:
    """A collated-layout SceneBatch (CPU tensors) made from `seed`.

    Each scene has k in [min_objs, max_objs] objects and a `_scene_` root
    node; every object has an "in" (predicate 0) edge to the root and one
    random relation to the next object of its scene.  With diffusion_bs > 0
    it carries the training shape sub-batch: the greedy whole-scene prefix
    of at most diffusion_bs rows (collate's rule), each real row a seeded
    analytic SDF grid clamped to [-0.2, 0.2] like the dataset's, the
    other rows zeros."""
    rng = np.random.default_rng(seed)
    n_cap, t_cap = max_nodes, max_triples
    objs = np.zeros(n_cap, np.int64)
    obj_mask = np.zeros(n_cap, np.float32)
    obj_to_scene = np.full(n_cap, batch_scenes, np.int64)
    boxes = np.zeros((n_cap, 7), np.float32)
    triples = np.zeros((t_cap, 3), np.int64)
    triple_mask = np.zeros(t_cap, np.float32)
    triple_to_scene = np.full(t_cap, batch_scenes, np.int64)
    off_n = off_t = 0
    for si in range(batch_scenes):
        k = int(rng.integers(min_objs, max_objs + 1))
        if off_n + k + 1 > n_cap or off_t + 2 * k > t_cap:
            raise ValueError("scenes exceed the node / triple capacity")
        root = off_n + k
        objs[off_n:root] = rng.integers(1, NUM_OBJS, k)
        objs[root] = 0
        obj_mask[off_n:root + 1] = 1.0
        obj_to_scene[off_n:root + 1] = si
        boxes[off_n:root] = np.concatenate(
            [rng.uniform(-1, 1, (k, 6)), rng.uniform(-np.pi, np.pi, (k, 1))], 1)
        for i in range(k):
            j = (i + 1) % k
            triples[off_t] = (off_n + i, 0, root)
            triples[off_t + 1] = (off_n + i, rng.integers(1, NUM_PREDS),
                                  off_n + j)
            triple_mask[off_t:off_t + 2] = 1.0
            triple_to_scene[off_t:off_t + 2] = si
            off_t += 2
        off_n = root + 1

    def unit(shape, mask):
        x = rng.normal(size=shape).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return torch.from_numpy(x * mask[:, None])

    t = torch.from_numpy
    shapes = None
    if diffusion_bs:
        sizes = np.bincount(obj_to_scene[obj_mask > 0],
                            minlength=batch_scenes)
        valid = 0
        for k in sizes:
            if valid + k > diffusion_bs:
                break
            valid += int(k)
        sdf = np.zeros((diffusion_bs, sdf_res, sdf_res, sdf_res, 1),
                       np.float32)
        for i in range(valid):
            sdf[i, ..., 0] = np.clip(analytic_sdf(i % 3, sdf_res, rng),
                                     -0.2, 0.2)
        shapes = ShapeSelection(sdf=t(sdf),
                                num_valid=torch.tensor(valid))
    view = GraphBatch(objs=t(objs), triples=t(triples), obj_mask=t(obj_mask),
                      triple_mask=t(triple_mask),
                      text_feats=unit((n_cap, CLIP_DIM), obj_mask),
                      rel_feats=unit((t_cap, CLIP_DIM), triple_mask))
    return SceneBatch(enc=view, dec=view, objs_grained=t(objs.copy()),
                      obj_to_scene=t(obj_to_scene),
                      triple_to_scene=t(triple_to_scene), boxes=t(boxes),
                      change_flags=torch.zeros(n_cap),
                      enc_obj_mask=t(obj_mask.copy()),
                      num_scenes=batch_scenes, shapes=shapes)


def seeded_weights_(module: torch.nn.Module, seed: int,
                    head_std: float = 0.02) -> None:
    """Re-draw the parameters from `seed` on their device: matrices and
    kernels uniform in +-1/sqrt(fan_in) (torch's default bound), vectors
    kept, and N(0, head_std) for everything initialised to zero (the output
    heads, norm biases), so every attention site reaches the outputs."""
    gen = None
    with torch.no_grad():
        for _, p in sorted(module.named_parameters()):
            if gen is None:
                gen = torch.Generator(device=p.device).manual_seed(seed)
            if p.dim() >= 2:
                bound = 1.0 / float(np.sqrt(p[0].numel()))
                p.uniform_(-bound, bound, generator=gen)
            if not bool(p.any()):
                p.normal_(0.0, head_std, generator=gen)


def flagship_config(config_path: Optional[str] = None) -> EchoSceneConfig:
    return load_config(config_path
                       or os.path.join(REPO_ROOT, "configs", "full_mp.yaml"))


def build_flagship(max_nodes: int = 48, max_triples: int = 112,
                   batch_scenes: int = 8, seed: int = 0, device="cuda",
                   cfg: Optional[EchoSceneConfig] = None
                   ) -> Tuple[SGDiff, SceneBatch]:
    """Flagship SGDiff (full_mp.yaml widths unless `cfg` is given) with
    seeded random weights, and the synthetic batch on `device`."""
    cfg = cfg or flagship_config()
    cfg.max_nodes, cfg.max_triples = max_nodes, max_triples
    cfg.batch_scenes = batch_scenes
    torch.manual_seed(seed)
    sg = SGDiff(cfg, NUM_OBJS, NUM_PREDS, device=device)
    seeded_weights_(sg.module, seed)
    batch = synthetic_batch(batch_scenes, max_nodes, max_triples, seed)
    return sg, batch.to(device)


def time_generation(sg: SGDiff, batch: SceneBatch, batch_scenes: int,
                    n_iters: int = 1, seed: int = 1, warmup: bool = True):
    """Wall seconds of a full `sample_fn` call over the exact real-node rows,
    averaged over n_iters (after one untimed call when `warmup`); returns
    (scenes_per_sec, seconds, last output)."""
    rows = shape_row_capacity(batch, multiple=1)
    gen = torch.Generator(device=sg.device).manual_seed(seed)
    if warmup:
        sg.sample_fn(batch, gen, shape_rows=rows)
    torch.cuda.synchronize(sg.device)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = sg.sample_fn(batch, gen, shape_rows=rows)
    torch.cuda.synchronize(sg.device)
    dt = (time.perf_counter() - t0) / n_iters
    return batch_scenes / dt, dt, out


def time_train_step(sg: SGDiff, state: TrainState, batch: SceneBatch,
                    batch_scenes: int, k: int = 8, seed: int = 17):
    """Train scenes/sec as bench.py defines it: batch_scenes x k steps over
    the wall seconds of k steps, after one untimed warm step; returns
    (scenes_per_sec, seconds per step, the k losses)."""
    gen = torch.Generator(device=sg.device).manual_seed(seed)
    sg.train_step(state, batch, gen)
    torch.cuda.synchronize(sg.device)
    t0 = time.perf_counter()
    losses = [sg.train_step(state, batch, gen)["loss"] for _ in range(k)]
    torch.cuda.synchronize(sg.device)
    dt = time.perf_counter() - t0
    return batch_scenes * k / dt, dt / k, torch.stack(losses).cpu()


@torch.no_grad()
def device_busy_shares(sg: SGDiff, batch: SceneBatch, rows: int,
                       iters: int = 5) -> dict:
    """For each part of `sample_fn` (the graph context, one layout denoiser
    step, one shape denoiser step, one decode chunk): wall ms per call on
    the card, and the device time and kernel launches of one call under
    torch.profiler (device-side events only), whose ratio to the wall time
    is the share of the call the device is busy."""
    model = sg.inference_module()
    dev = sg.device
    cfg = sg.cfg
    gen = torch.Generator(device=dev).manual_seed(7)
    change = torch.zeros((batch.num_nodes, cfg.embedding_dim), device=dev)
    ctx = model.encode_context(batch, change, False)
    triples, obj_mask, tri_mask = compact_graph(batch, rows)
    r = cfg.shape_branch.denoiser.image_size
    x = torch.randn((rows, cfg.layout_denoiser.in_channels), generator=gen,
                    device=dev)
    z = torch.randn((rows, r, r, r, cfg.shape_branch.vqvae.embed_dim),
                    generator=gen, device=dev)
    t = torch.full((rows,), 500, dtype=torch.long, device=dev)
    obj_embed, uc_s = ctx["obj_embed"][:rows], ctx["uc_s"][:rows, None, :]
    parts = {
        "context": lambda: model.encode_context(batch, change, False),
        "layout_step": lambda: model.layout_eps(
            x, t, obj_embed, triples, obj_mask, tri_mask),
        "shape_step": lambda: model.shape_eps(
            z, t, uc_s, triples, obj_mask, tri_mask),
        "decode_chunk": lambda: model.decode_latent(z[:8]),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(dev)
        out[name] = profile_call(fn, dev,
                                 (time.perf_counter() - t0) / iters * 1e3)
    return out


def profile_call(fn, device, wall_ms: float) -> dict:
    """The device time and kernel launches of one call of `fn` under
    torch.profiler (device-side events only), and their ratio to `wall_ms`,
    the call's wall time measured without the profiler: the share of the
    call the device is busy."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize(device)
    # CPU ops also carry the device time of their kernels: count only the
    # device-side events
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_ms": dev_ms if dev_ms > 0 else None,
            "busy_share": dev_ms / wall_ms if dev_ms > 0 else None,
            "kernel_launches": sum(e.count for e in kernels)}


def concurrent_latency(service, requests, window_ms: float, n_clients: int,
                       timeout: float = 600.0) -> dict:
    """`n_clients` threads, each sending its share of `requests` one at a
    time through a MicroBatcher with a `window_ms` window in front of
    `service` (scripts/bench_serve.py:51-86).  Returns each request's
    latency in seconds (`latencies_s`, in completion order), `req_per_sec`
    over the wall time of the whole stream, `wall_s`, the batcher's
    `stats` and the `results` by request index."""
    import threading

    from .serve.batcher import MicroBatcher

    mb = MicroBatcher(service, max_wait_ms=window_ms)
    latencies, results, errors = [], {}, []
    lock = threading.Lock()

    def client(idx):
        for i in idx:
            t0 = time.perf_counter()
            try:
                (res,) = mb.generate([requests[i]], timeout=timeout)
            except Exception as e:  # reported after the stream, not lost
                with lock:
                    errors.append((i, e))
                continue
            dt = time.perf_counter() - t0
            with lock:
                latencies.append(dt)
                results[i] = res

    threads = [threading.Thread(target=client,
                                args=(range(c, len(requests), n_clients),))
               for c in range(n_clients)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        wall = time.perf_counter() - t0
        stats = mb.stats()
    finally:
        mb.close()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"concurrent clients failed: {errors[:3]}")
    return {"latencies_s": latencies, "req_per_sec": len(requests) / wall,
            "wall_s": wall, "stats": stats, "results": results}
