"""Render the ground-truth test scenes: the FID 'real' image set.

Port of scripts/collect_gt_sdf_images.py (reference
scripts/collect_gt_sdf_images.py:117-158), with the same flags:

    python -m echoscene_torch.eval.gt_renders --dataset DATA \
        [--room_type bedroom] [--out ./gt_renders] [--limit N] \
        [--with_sdf --sdf_res 64]

Per test scene: the GT boxes descaled to world units, the GT SDFs when
`--with_sdf` (reading them needs h5py), then the top-down 256^2 render of
eval/render.py to `<out>/<scan_id>.png`.  Host code only: no device work.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..core.boxes import descale_box_params
from ..data.sgfront import SGFrontDataset
from .render import render_scene_topdown, save_png


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--room_type", default="bedroom")
    p.add_argument("--out", default="./gt_renders")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--with_sdf", action="store_true")
    p.add_argument("--sdf_res", type=int, default=64)
    args = p.parse_args(argv)

    ds = SGFrontDataset(args.dataset, split="test", room_type=args.room_type,
                        use_sdf=args.with_sdf, with_changes=False,
                        shuffle_objs=False, sdf_res=args.sdf_res)
    os.makedirs(args.out, exist_ok=True)
    written = 0
    for i in range(min(args.limit or len(ds), len(ds))):
        ex = ds[i]
        if ex is None:
            continue
        boxes6 = descale_box_params(ex.boxes[:, :6], ds.box_stats)
        boxes7 = np.concatenate([boxes6, ex.boxes[:, 6:7]], -1)
        sdfs = None
        if args.with_sdf and ex.sdf_paths is not None:
            sdfs = np.stack([ds.load_sdf(p)[..., 0] for p in ex.sdf_paths])
        img = render_scene_topdown(ex.objs, boxes7,
                                   ds.vocab["object_idx_to_name"], sdfs)
        save_png(img, os.path.join(args.out, f"{ex.scan_id}.png"))
        written += 1
    print(f"[gt renders] wrote into {args.out}")
    return written


if __name__ == "__main__":
    main()
