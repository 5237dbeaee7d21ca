"""Real-data readiness gate for SG-FRONT trees.

Port of scripts/check_sgfront.py, with its flags and exit codes: validates
every file contract the loader depends on (data/check.py) and optionally
warms reference-format CLIP pickles:

    python -m echoscene_torch.data.check_cli --dataset /path/to/SG-FRONT \
        [--room_type bedroom] [--sdf_res 64] [--check_clip] \
        [--write_clip_cache] [--clip_backend hash|transformers]

Exit code 0 iff no errors (warnings don't fail the gate).  It runs on the
host; the SDF checks need h5py.
"""
import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True, help="SG-FRONT root directory")
    p.add_argument("--room_type", default="bedroom")
    p.add_argument("--splits", nargs="+", default=["trainval", "test"])
    p.add_argument("--sdf_res", type=int, default=64)
    p.add_argument("--sdf_sample", type=int, default=16,
                   help="number of SDF h5 files to open-and-verify "
                        "(0 = all)")
    p.add_argument("--large", action="store_true",
                   help="fine-grained class vocabulary (reference --large)")
    p.add_argument("--bin_angle", action="store_true",
                   help="validate the legacy mean/std bounds layout instead "
                        "of the 14-float min/max one")
    p.add_argument("--check_clip", action="store_true",
                   help="also validate per-scan CLIP pickles")
    p.add_argument("--write_clip_cache", action="store_true",
                   help="write reference-format CLIP pickles for scans "
                        "that lack them")
    p.add_argument("--clip_backend", default="hash",
                   choices=["hash", "transformers"],
                   help="encoder for --write_clip_cache")
    p.add_argument("--overwrite_clip", action="store_true")
    args = p.parse_args(argv)

    from .check import check_dataset, write_clip_cache

    if args.write_clip_cache:
        from .clip_text import ClipTextEncoder
        n = write_clip_cache(args.dataset, args.room_type, args.splits,
                             large=args.large,
                             encoder=ClipTextEncoder(args.clip_backend),
                             overwrite=args.overwrite_clip)
        print(f"wrote {n} CLIP pickle(s)")

    rep = check_dataset(args.dataset, args.room_type, args.splits,
                        sdf_res=args.sdf_res, sdf_sample=args.sdf_sample,
                        large=args.large,
                        check_clip=args.check_clip or args.write_clip_cache,
                        bin_angle=args.bin_angle)
    print(rep.render())
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())
