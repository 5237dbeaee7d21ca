"""Shape-consistency metric CLI.

Port of scripts/consistency_check.py (reference entry point
scripts/consistency_check.py), without its CLIP option:

    python -m echoscene_torch.eval.consistency_cli \
        --annotations consistencies_all_test.json --generated_dir EVAL_DIR

For the annotated identical-object pairs, the chamfer distance between the
two generated shapes of each pair, on the card (kernel K4) unless
`--device cpu`; prints per-category and total averages as JSON.  Reads the
per-scene SDF dumps `<generated_dir>/<scan_id>.npz` ('sdfs' (N,R,R,R),
'instance_ids' (N,), 'categories' (N,)) that `echoscene_torch.eval.cli
--dump_sdfs` writes.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .consistency import (aggregate_consistency, consistency_from_sdfs,
                          load_consistency_annotations)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--annotations", required=True,
                   help="consistencies_all_test.json")
    p.add_argument("--generated_dir", required=True,
                   help="dir of <scan_id>.npz generated sdf dumps")
    p.add_argument("--num_points", type=int, default=5000)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

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
            device=args.device))

    agg = aggregate_consistency(all_results)
    print(json.dumps(agg, indent=2))
    return agg


if __name__ == "__main__":
    main()
