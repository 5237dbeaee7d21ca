"""Object-level MMD / COV / 1-NN over CD and EMD, per category.

Port of scripts/compute_mmd_cov_1nn.py (reference
scripts/compute_mmd_cov_1nn.py:405-429):

    python -m echoscene_torch.eval.mmd_cli --generated_dir G --reference_dir R

Loads 5k-point clouds from the per-object meshes `<cat>/*.obj` under both
directories and computes the metric battery per category: chamfer on the
card (kernel K4) unless `--device cpu`, EMD exact on the host (Hungarian),
as the JAX CLI does.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .. import native
from .pointcloud_metrics import (compute_all_metrics, emd_exact,
                                 jsd_between_point_cloud_sets)


def load_obj_points(path: str, n_points: int = 5000, seed: int = 0):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:4]]
                faces.append(idx)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    if len(faces) == 0:
        return None
    return native.sample_mesh(verts, faces, n_points, seed)


def collect_category_clouds(root: str, n_points: int, limit: int = 0):
    out = {}
    for cat in sorted(os.listdir(root)):
        cdir = os.path.join(root, cat)
        if not os.path.isdir(cdir):
            continue
        files = sorted(f for f in os.listdir(cdir) if f.endswith(".obj"))
        if limit:
            files = files[:limit]
        clouds = [pc for pc in (load_obj_points(os.path.join(cdir, f),
                                                n_points) for f in files)
                  if pc is not None]
        if clouds:
            out[cat] = np.stack(clouds)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--generated_dir", required=True)
    p.add_argument("--reference_dir", required=True)
    p.add_argument("--num_points", type=int, default=5000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--with_jsd", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where chamfer runs (EMD is exact on the host)")
    args = p.parse_args(argv)

    gen = collect_category_clouds(args.generated_dir, args.num_points,
                                  args.limit)
    ref = collect_category_clouds(args.reference_dir, args.num_points,
                                  args.limit)
    results = {}
    for cat in sorted(set(gen) & set(ref)):
        n = min(len(gen[cat]), len(ref[cat]))
        r = compute_all_metrics(gen[cat][:n], ref[cat][:n],
                                batch_size=args.batch_size, emd_fn=emd_exact,
                                device=args.device)
        if args.with_jsd:
            r["jsd"] = jsd_between_point_cloud_sets(gen[cat][:n], ref[cat][:n])
        results[cat] = r
        print(cat, json.dumps(r, indent=2))
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
