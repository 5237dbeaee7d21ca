"""Shape-consistency metric: chamfer distance between the generated shapes of
annotated identical-object pairs.

Port of echoscene_tpu/eval/consistency.py (reference
scripts/consistency_check.py:56-117): for each scene in
`consistencies_all_test.json` (scan_id -> groups of instance ids that are the
same 3D-FUTURE object), the chamfer distance between the 5k-point surface
samples of each generated pair, averaged per category and in total.  Lower is
more consistent (the shared-initial-noise echo sampling is what it checks).

JAX computes each pair on the host (`native.chamfer_batch`); here every pair
of a scene goes to the device in one `chamfer_distance` call (kernel K4 on
CUDA), which is the same function over a batch of pairs.
"""
from __future__ import annotations

import itertools
import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import native
from .pointcloud_metrics import chamfer_distance


def pair_chamfer(points_a: np.ndarray, points_b: np.ndarray,
                 device="cuda") -> float:
    """Chamfer between two (N, 3) clouds (consistency_check.py:87-89)."""
    return float(chamfer_distance(points_a[None], points_b[None],
                                  device=device)[0])


def consistency_from_sdfs(sdf_by_instance: Dict[int, np.ndarray],
                          groups: Sequence[Sequence[int]],
                          category_by_instance: Optional[Dict[int, str]] = None,
                          n_points: int = 5000, seed: int = 0,
                          clip_encoder=None, clip_results=None,
                          device="cuda"):
    """Score one scene: (category, chamfer) over every in-group pair, in
    JAX's order.

    sdf_by_instance: instance id -> (R,R,R[,1]) generated SDF grid.
    groups: lists of instance ids annotated as the same object.
    clip_encoder: the CLIP image-distance option needs eval/clip_image.py
    and eval/render.py, which are not ported yet."""
    if clip_encoder is not None or clip_results is not None:
        raise NotImplementedError(
            "the CLIP image distance of the consistency metric needs "
            "eval/clip_image.py and eval/render.py, not ported yet")
    clouds: Dict[int, np.ndarray] = {}

    def cloud(iid):
        if iid not in clouds:
            grid = np.asarray(sdf_by_instance[iid], np.float32)
            if grid.ndim == 4:
                grid = grid[..., 0]
            # canonical grid scale: consistency compares raw generated
            # geometry, unit normalisation would hide size differences
            clouds[iid] = native.sdf_to_point_cloud(grid, n_points, seed=seed,
                                                    normalize=False)
        return clouds[iid]

    pairs, cats = [], []
    for group in groups:
        members = [g for g in group if g in sdf_by_instance]
        for a, b in itertools.combinations(members, 2):
            pairs.append((cloud(a), cloud(b)))
            cats.append((category_by_instance or {}).get(a, "all"))
    if not pairs:
        return []
    cds = chamfer_distance(np.stack([p[0] for p in pairs]),
                           np.stack([p[1] for p in pairs]), device=device)
    return [(cat, float(cd)) for cat, cd in zip(cats, cds)]


def aggregate_consistency(results) -> Dict[str, float]:
    """Per-category + total averages (consistency_check.py:102-111)."""
    by_cat = defaultdict(list)
    for cat, cd in results:
        by_cat[cat].append(cd)
    out = {cat: float(np.mean(v)) for cat, v in by_cat.items()}
    allv = [cd for _, cd in results]
    out["total"] = float(np.mean(allv)) if allv else float("nan")
    return out


def load_consistency_annotations(path: str) -> Dict[str, List[List[int]]]:
    """consistencies_all_test.json format: scan_id -> groups of instance ids."""
    with open(path) as f:
        return json.load(f)
