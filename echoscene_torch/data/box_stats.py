"""Compute the centred-bounds box-stats file of a dataset.

Port of scripts/compute_box_stats.py, with its flags:

    python -m echoscene_torch.data.box_stats --dataset DATA \
        [--room_type bedroom] [--out PATH]

The reference ships `centered_bounds_<room>_trainval.txt` precomputed; this
derives it from the raw `obj_boxes_<room>_trainval.json` so that new
datasets and room types can be onboarded.  One row of 14 floats:
min_lhw(3) max_lhw(3) min_xyz(3) max_xyz(3) min_angle max_angle
(helpers/util.py:519-520), positions relative to each scene's centre.
Host code only: no device work.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def box_stats(data: dict):
    """obj_boxes json -> ((14,) float64 stats, the number of boxes)."""
    params = []
    for boxes in data.values():
        center = np.asarray(boxes["scene_center"], np.float64)
        for k, v in boxes.items():
            if k == "scene_center" or not isinstance(v, dict):
                continue
            if "param7" not in v:
                continue
            b = np.asarray(v["param7"], np.float64).copy()
            b[3:6] -= center
            params.append(b)
    params = np.stack(params)
    return np.concatenate([
        params[:, :3].min(0), params[:, :3].max(0),
        params[:, 3:6].min(0), params[:, 3:6].max(0),
        [params[:, 6].min()], [params[:, 6].max()],
    ]), len(params)


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--room_type", default="bedroom")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    path = os.path.join(args.dataset,
                        f"obj_boxes_{args.room_type}_trainval.json")
    with open(path) as f:
        stats, n = box_stats(json.load(f))
    out = args.out or os.path.join(
        args.dataset, f"centered_bounds_{args.room_type}_trainval.txt")
    np.savetxt(out, stats.reshape(1, -1))
    print(f"[box stats] {n} boxes -> {out}")
    print(stats)
    return stats


if __name__ == "__main__":
    main()
