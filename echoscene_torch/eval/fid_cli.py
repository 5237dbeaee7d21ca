"""FID / KID between real and generated top-down renders.

Port of scripts/compute_fid_scores_3dfront.py, with its flags plus
`--device` (default `cuda`; the feature network runs there):

    python -m echoscene_torch.eval.fid_cli \
        --path_to_real_renderings GT --path_to_synthesized_renderings GEN \
        [--room_type all] [--extractor auto] [--device cpu]

Two directories of 256^2 renders, room-type filename filters, FID and KID
printed as JSON ({"fid", "kid", "n_real", "n_fake"}).  `--extractor auto`
takes the installed Inception weights (`python -m echoscene_torch.weights
--inception ...`) and else the random-conv proxy, which is no FID of the
paper; or `inception:<path>` / `torchscript:<path>` / `random`.
"""
from __future__ import annotations

import argparse
import json

from .fid import compute_fid_kid


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--path_to_real_renderings", required=True)
    p.add_argument("--path_to_synthesized_renderings", required=True)
    p.add_argument("--room_type", default="all",
                   choices=["bedroom", "livingroom", "diningroom", "library",
                            "all"])
    p.add_argument("--extractor", default="auto",
                   help="'auto' = installed Inception weights (python -m "
                        "echoscene_torch.weights) if present, else the "
                        "random-conv proxy; or 'inception:<path>' / "
                        "'torchscript:<path>' / 'random'")
    p.add_argument("--device", default="cuda",
                   help="device of the feature network (cuda, cuda:N, cpu)")
    args = p.parse_args(argv)
    res = compute_fid_kid(args.path_to_real_renderings,
                          args.path_to_synthesized_renderings,
                          room_type=args.room_type, extractor=args.extractor,
                          device=args.device)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
