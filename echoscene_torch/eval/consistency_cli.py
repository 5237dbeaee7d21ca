"""Shape-consistency metric CLI.

Port of scripts/consistency_check.py (reference entry point
scripts/consistency_check.py), with its flags plus `--device`:

    python -m echoscene_torch.eval.consistency_cli \
        --annotations consistencies_all_test.json --generated_dir EVAL_DIR \
        [--clip off|pixel|transformers|auto] [--clip_model_path DIR]

For the annotated identical-object pairs, the chamfer distance between the
two generated shapes of each pair, on the card (kernel K4) unless
`--device cpu`; prints per-category and total averages as JSON.  Reads the
per-scene SDF dumps `<generated_dir>/<scan_id>.npz` ('sdfs' (N,R,R,R),
'instance_ids' (N,), 'categories' (N,)) that `echoscene_torch.eval.cli
--dump_sdfs` writes.  `--clip` adds a "clip" block: the per-category and
total L2 distances between the CLIP image features of each pair's rendered
shapes ('pixel' is a hermetic proxy, not comparable to real-CLIP numbers;
'transformers' needs local CLIP vision weights and the transformers
package; 'auto' takes the installed weights, else 'pixel').
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .clip_image import ClipImageEncoder
from .consistency import (aggregate_consistency, consistency_from_sdfs,
                          load_consistency_annotations)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--annotations", required=True,
                   help="consistencies_all_test.json")
    p.add_argument("--generated_dir", required=True,
                   help="dir of <scan_id>.npz generated sdf dumps")
    p.add_argument("--num_points", type=int, default=5000)
    p.add_argument("--clip", default="off",
                   choices=["off", "auto", "pixel", "transformers"],
                   help="also report CLIP image-feature pair distances "
                        "(consistency_check.py:63-75)")
    p.add_argument("--clip_model_path", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    clip_enc = None
    clip_results = []
    if args.clip != "off":
        clip_enc = ClipImageEncoder(args.clip, args.clip_model_path,
                                    device=args.device)

    anns = load_consistency_annotations(args.annotations)
    all_results = []
    for scan_id, groups in anns.items():
        path = os.path.join(args.generated_dir, f"{scan_id}.npz")
        if not os.path.exists(path):
            continue
        with np.load(path) as data:
            sdfs = data["sdfs"]
            iids = data["instance_ids"]
            cats = None
            if "categories" in data:
                cats = {int(i): str(c)
                        for i, c in zip(iids, data["categories"])}
        by_iid = {int(i): sdfs[k] for k, i in enumerate(iids)}
        all_results.extend(consistency_from_sdfs(
            by_iid, groups, cats, n_points=args.num_points,
            clip_encoder=clip_enc, clip_results=clip_results,
            device=args.device))

    agg = aggregate_consistency(all_results)
    if clip_enc is not None:
        agg["clip"] = aggregate_consistency(clip_results)
    print(json.dumps(agg, indent=2))
    return agg


if __name__ == "__main__":
    main()
