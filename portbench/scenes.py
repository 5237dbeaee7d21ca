"""The general traffic generator: scene-graph batches from a mix's
parameters (`traffic/<name>.json`) and a seed.

A copy of the rule of `echoscene_torch/benchmarks.py` `synthetic_batch`,
widened: each scene has k objects and a `_scene_` root node, every object
an "in" edge (predicate 0) to the root and one random relation to the next
object of its scene; nodes are scene-major with all padding at the tail;
512-d unit-norm text / relation features stand in for CLIP's.

Objects per scene are uniform on [objects_min, objects_max], drawn from the
seed for every batch, stratified by the batch's total: the totals of the
`strata` equal-probability strata of the sum of `scenes` such draws (each
stratum's median) take turns in the mix's `stratum_order`, and each
batch's counts are drawn with its total.  So batches differ in rows, and
batch i has the same rows under every seed: every seed does the same work,
and a run meets the `strata` row counts that set-up warms.  Training batches also carry the shape sub-batch: the greedy prefix
of whole scenes of at most `shape_rows` rows, each real row a seeded
analytic SDF (sphere, box, ellipsoid) made on the device and clipped as the
dataset's grids are.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CLIP_DIM = 512


def load(name: str) -> Dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def batch_totals(mix: Dict) -> List[int]:
    """Objects of batches 0, 1, ... of a stream, in turn (module
    docstring)."""
    lo, hi, n, k = (mix["objects_min"], mix["objects_max"], mix["scenes"],
                    mix["strata"])
    one = np.full(hi - lo + 1, 1.0 / (hi - lo + 1))
    dist = np.ones(1)
    for _ in range(n):
        dist = np.convolve(dist, one)
    cdf = np.cumsum(dist)
    medians = [n * lo + int(np.searchsorted(cdf, (j + 0.5) / k))
               for j in range(k)]
    return [medians[j] for j in mix["stratum_order"]]


def object_counts(mix: Dict, rng: np.random.Generator,
                  total: int) -> np.ndarray:
    """Each scene's objects, uniform draws moved one object at a time
    (random scenes within the bounds) until they sum to `total`."""
    lo, hi = mix["objects_min"], mix["objects_max"]
    k = rng.integers(lo, hi + 1, mix["scenes"])
    while k.sum() != total:
        if k.sum() < total:
            k[rng.choice(np.flatnonzero(k < hi))] += 1
        else:
            k[rng.choice(np.flatnonzero(k > lo))] -= 1
    return k


def capacities(mix: Dict):
    """(node, triple) capacities of a batch: nothing a draw makes
    overflows them."""
    n = mix["scenes"]
    return n * (mix["objects_max"] + 1), n * 2 * mix["objects_max"]


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), *stream])


def torch_seed(seed: int, *stream: int) -> int:
    return int(np.random.SeedSequence([int(seed), *stream]).generate_state(
        1, np.uint64)[0] >> 1)


def graph_batch(mix: Dict, num_objs: int, num_preds: int, seed: int,
                index: int) -> Dict:
    """Batch `index` of the stream of `seed`: a dict of CPU tensors (objs,
    triples, obj_mask, triple_mask, text_feats, rel_feats, obj_to_scene,
    triple_to_scene, boxes, change_flags, enc_obj_mask) and num_scenes,
    real_nodes."""
    rng = rng_for(seed, 1, index)
    scenes = mix["scenes"]
    n_cap, t_cap = capacities(mix)
    totals = batch_totals(mix)
    counts = object_counts(mix, rng, totals[index % len(totals)])
    objs = np.zeros(n_cap, np.int64)
    obj_mask = np.zeros(n_cap, np.float32)
    obj_to_scene = np.full(n_cap, scenes, np.int64)
    boxes = np.zeros((n_cap, 7), np.float32)
    triples = np.zeros((t_cap, 3), np.int64)
    triple_mask = np.zeros(t_cap, np.float32)
    triple_to_scene = np.full(t_cap, scenes, np.int64)
    off_n = off_t = 0
    for si, k in enumerate(counts):
        k = int(k)
        root = off_n + k
        objs[off_n:root] = rng.integers(1, num_objs, k)
        obj_mask[off_n:root + 1] = 1.0
        obj_to_scene[off_n:root + 1] = si
        boxes[off_n:root] = np.concatenate(
            [rng.uniform(-1, 1, (k, 6)), rng.uniform(-np.pi, np.pi, (k, 1))],
            1)
        rel = rng.integers(1, num_preds, k)
        for i in range(k):
            triples[off_t] = (off_n + i, 0, root)
            triples[off_t + 1] = (off_n + i, rel[i], off_n + (i + 1) % k)
            triple_mask[off_t:off_t + 2] = 1.0
            triple_to_scene[off_t:off_t + 2] = si
            off_t += 2
        off_n = root + 1

    def unit(shape, mask):
        x = rng.normal(size=shape).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return torch.from_numpy(x * mask[:, None])

    t = torch.from_numpy
    return {"objs": t(objs), "triples": t(triples), "obj_mask": t(obj_mask),
            "triple_mask": t(triple_mask),
            "text_feats": unit((n_cap, CLIP_DIM), obj_mask),
            "rel_feats": unit((t_cap, CLIP_DIM), triple_mask),
            "obj_to_scene": t(obj_to_scene),
            "triple_to_scene": t(triple_to_scene), "boxes": t(boxes),
            "change_flags": torch.zeros(n_cap),
            "enc_obj_mask": t(obj_mask.copy()), "num_scenes": scenes,
            "real_nodes": off_n}


def greedy_rows(g: Dict, capacity: int) -> int:
    """Rows of the greedy shape sub-batch: whole scenes while they fit."""
    sizes = np.bincount(g["obj_to_scene"].numpy()[g["obj_mask"].numpy() > 0],
                        minlength=g["num_scenes"])
    valid = 0
    for k in sizes:
        if valid + k > capacity:
            break
        valid += int(k)
    return valid


@torch.no_grad()
def analytic_sdfs(rows: int, valid: int, res: int, clip: float, seed: int,
                  index: int, device) -> torch.Tensor:
    """(rows, res, res, res, 1) f32 on `device`: the first `valid` rows a
    sphere, box or ellipsoid in turn with sizes drawn from the seed,
    clipped to +-clip; the other rows zeros."""
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 2,
                                                                index))
    c = torch.linspace(-1, 1, res, device=device)
    p = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)[None]
    radius = torch.empty(rows, device=device).uniform_(0.3, 0.7,
                                                       generator=gen)
    half = torch.empty(rows, 3, device=device).uniform_(0.25, 0.6,
                                                        generator=gen)
    out = torch.zeros(rows, res, res, res, 1, device=device)
    kind = torch.arange(rows, device=device) % 3
    for k in range(3):
        idx = torch.nonzero((kind == k)
                            & (torch.arange(rows, device=device) < valid)
                            ).flatten()
        if idx.numel() == 0:
            continue
        h = half[idx][:, None, None, None, :]
        if k == 0:
            d = p.norm(dim=-1) - radius[idx][:, None, None, None]
        elif k == 1:
            q = p.abs() - h
            d = (q.clamp_min(0).norm(dim=-1)
                 + q.amax(-1).clamp_max(0))
        else:
            d = ((p / h).norm(dim=-1) - 1.0) * h.amin(-1)
        out[idx, ..., 0] = d.clamp(-clip, clip)
    return out
