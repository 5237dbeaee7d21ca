"""Padded flat-concat collation: SceneExamples -> the port's SceneBatch.

Port of echoscene_tpu/data/collate.py (reference dataset.collate_fn,
threedfront_dataset.py:618-743): per-scene node / edge arrays are
concatenated with a running node-index offset and obj_to_scene /
triple_to_scene maps, padded to static (max_nodes, max_triples) capacities
with validity masks (scenes that overflow are dropped), nodes scene-major with
all padding at the global tail, so the shape branch's greedy whole-scene
packing (EchoScene.select_sdfs :290-308) is a prefix length computed here.
The batch is built in numpy, as in JAX, and returned as CPU tensors (index
arrays int64, masks and features float32); the caller moves it to a device.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.graphbatch import GraphBatch, SceneBatch, ShapeSelection
from .sgfront import SceneExample

_SDF_POOL: Optional[ThreadPoolExecutor] = None


def _sdf_read_pool() -> ThreadPoolExecutor:
    """Shared reader pool for per-object SDF h5 loads, made on first use.
    The reads release the GIL, so a few threads overlap the IO."""
    global _SDF_POOL
    if _SDF_POOL is None:
        _SDF_POOL = ThreadPoolExecutor(max_workers=8,
                                       thread_name_prefix="sdf-read")
    return _SDF_POOL


@dataclasses.dataclass
class CollateSpec:
    max_nodes: int = 256
    max_triples: int = 512
    max_scenes: int = 64          # static scene capacity
    diffusion_bs: int = 64        # shape-branch object capacity
    with_sdf: bool = False
    sdf_res: int = 64
    clip_dim: int = 512
    latent_res: int = 16
    latent_ch: int = 3
    shape_sampling: str = "greedy"   # greedy | random | balance (select_sdfs)


def _select_shape_rows(kept: Sequence[SceneExample], m: int, mode: str,
                       rng: np.random.Generator) -> List[int]:
    """Non-greedy object selection (select_sdfs :255-289): per scene pick
    ceil(m / num_scenes) objects with a model, 'random' uniformly, 'balance'
    covering fine-grained categories first (balance_objects :198-220)."""
    num_obj = int(np.ceil(m / max(len(kept), 1)))
    rows: List[int] = []
    off = 0
    for e in kept:
        paths = e.sdf_paths or [None] * e.num_nodes
        cand = [off + i for i in range(e.num_nodes) if paths[i] is not None]
        if cand:
            if mode == "random":
                perm = rng.permutation(len(cand))[:num_obj]
                rows.extend(cand[int(j)] for j in perm)
            elif mode == "balance":
                grained = np.asarray(e.objs_grained)[
                    [c - off for c in cand]]
                uniq = np.unique(grained)
                if len(uniq) >= num_obj:
                    sampled = rng.permutation(uniq)[:num_obj]
                else:
                    extra = rng.choice(grained, size=num_obj - len(uniq))
                    sampled = np.concatenate([uniq, extra])
                for g in sampled:
                    opts = [c for c, gg in zip(cand, grained) if gg == g]
                    rows.append(opts[int(rng.integers(len(opts)))])
            else:
                raise NotImplementedError(mode)
        off += e.num_nodes
    return rows[:m]


def _shapes(kept, spec, sdf_loader, latent_lookup, rng) -> ShapeSelection:
    m = spec.diffusion_bs
    all_paths: List[Optional[str]] = []
    for e in kept:
        all_paths.extend(e.sdf_paths or [None] * e.num_nodes)
    if spec.shape_sampling == "greedy":
        # greedy whole-scene prefix (EchoScene.py:290-308)
        num_valid = 0
        for e in kept:
            if num_valid + e.num_nodes > m:
                break
            num_valid += e.num_nodes
        indices = None
        mp_valid = True
        row_paths = (all_paths + [None] * m)[:m]
    else:
        rows = _select_shape_rows(kept, m, spec.shape_sampling,
                                  rng or np.random.default_rng(0))
        num_valid = len(rows)
        indices = torch.from_numpy(np.asarray((rows + [0] * m)[:m], np.int64))
        mp_valid = False   # no triples in the non-greedy branch (:300)
        row_paths = [all_paths[r] for r in rows]
        row_paths = (row_paths + [None] * m)[:m]
    count = torch.tensor(num_valid, dtype=torch.long)
    if latent_lookup is not None:
        r, z = spec.latent_res, spec.latent_ch
        lat = np.zeros((m, r, r, r, z), np.float32)
        for i in range(num_valid):
            lat[i] = latent_lookup(row_paths[i])
        return ShapeSelection(sdf=None, latent=torch.from_numpy(lat),
                              num_valid=count, indices=indices,
                              mp_valid=mp_valid)
    r = spec.sdf_res
    sdf = np.zeros((m, r, r, r, 1), np.float32)
    if sdf_loader is not None:
        for i, g in enumerate(_sdf_read_pool().map(sdf_loader,
                                                   row_paths[:num_valid])):
            sdf[i] = g
    return ShapeSelection(sdf=torch.from_numpy(sdf), num_valid=count,
                          indices=indices, mp_valid=mp_valid)


def collate_scenes(examples: Sequence[SceneExample], spec: CollateSpec,
                   sdf_loader=None, latent_lookup=None,
                   rng: Optional[np.random.Generator] = None
                   ) -> Optional[SceneBatch]:
    """Build a SceneBatch of CPU tensors; None when no scene fits.

    sdf_loader: callable(path_or_None) -> (R,R,R,1) grid, read for the
    shape rows only (threaded).  latent_lookup: callable(path_or_None) ->
    (r,r,r,z) precomputed VQ latent, shipped instead of SDF grids."""
    examples = [e for e in examples if e is not None]
    kept: List[SceneExample] = []
    n_total = t_total = 0
    for e in examples:
        if (n_total + e.num_nodes <= spec.max_nodes
                and t_total + len(e.triples) <= spec.max_triples
                and len(kept) < spec.max_scenes):
            kept.append(e)
            n_total += e.num_nodes
            t_total += len(e.triples)
    if not kept:
        return None

    N, T = spec.max_nodes, spec.max_triples
    S = spec.max_scenes  # static capacity; only the first len(kept) are real
    objs = np.zeros(N, np.int64)
    grained = np.zeros(N, np.int64)
    obj_mask = np.zeros(N, np.float32)
    enc_obj_mask = np.zeros(N, np.float32)
    obj_to_scene = np.full(N, S, np.int64)
    change_flags = np.zeros(N, np.float32)
    boxes = np.zeros((N, 7), np.float32)
    text_feats = np.zeros((N, spec.clip_dim), np.float32)

    triples = np.zeros((T, 3), np.int64)
    enc_triples = np.zeros((T, 3), np.int64)
    triple_mask = np.zeros(T, np.float32)
    enc_triple_mask = np.zeros(T, np.float32)
    triple_to_scene = np.full(T, S, np.int64)
    rel_feats = np.zeros((T, spec.clip_dim), np.float32)
    enc_rel_feats = np.zeros((T, spec.clip_dim), np.float32)

    off_n = off_t = 0
    for si, e in enumerate(kept):
        n, t = e.num_nodes, len(e.triples)
        sl = slice(off_n, off_n + n)
        objs[sl] = e.objs
        grained[sl] = e.objs_grained
        obj_mask[sl] = 1.0
        enc_obj_mask[sl] = e.enc_node_mask
        obj_to_scene[sl] = si
        change_flags[sl] = e.change_flags
        boxes[sl] = e.boxes
        text_feats[sl] = e.text_feats

        tl = slice(off_t, off_t + t)
        for dst, src in ((triples, e.triples), (enc_triples, e.enc_triples)):
            dst[tl] = src
            dst[tl, 0] += off_n
            dst[tl, 2] += off_n
        triple_mask[tl] = 1.0
        enc_triple_mask[tl] = e.enc_triple_mask
        triple_to_scene[tl] = si
        rel_feats[tl] = e.rel_feats
        enc_rel_feats[tl] = e.enc_rel_feats
        off_n += n
        off_t += t

    t = torch.from_numpy
    enc = GraphBatch(objs=t(objs), triples=t(enc_triples), obj_mask=t(obj_mask),
                     triple_mask=t(enc_triple_mask * triple_mask),
                     text_feats=t(text_feats), rel_feats=t(enc_rel_feats))
    dec = GraphBatch(objs=t(objs), triples=t(triples), obj_mask=t(obj_mask),
                     triple_mask=t(triple_mask), text_feats=t(text_feats),
                     rel_feats=t(rel_feats))
    shapes = (_shapes(kept, spec, sdf_loader, latent_lookup, rng)
              if spec.with_sdf else None)
    return SceneBatch(
        enc=enc, dec=dec, objs_grained=t(grained), obj_to_scene=t(obj_to_scene),
        triple_to_scene=t(triple_to_scene), boxes=t(boxes),
        change_flags=t(change_flags), enc_obj_mask=t(enc_obj_mask),
        num_scenes=S, shapes=shapes)


def single_scene_batch(example: SceneExample, spec: CollateSpec,
                       sdf_loader=None, latent_lookup=None
                       ) -> Optional[SceneBatch]:
    """Eval convenience: one scene."""
    return collate_scenes([example], spec, sdf_loader, latent_lookup)
