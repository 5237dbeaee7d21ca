"""Readings that the correctness limits are set from (not part of a run):

    python3 -m portbench.calibrate --workload <name> --seeds <n> [<n> ...]
        [--<also>-seeds <n> ...] > readings.jsonl

For each seed, in one process, the cell's traffic kind (`portbench/<kind>.py`,
its `calibration_line`) reads the program's numbers and the control's (the
reference in the precision below the configuration's, in the program's
place, on the same inputs), each against the float32 reference.  A kind
names in `CALIBRATION_SEEDS` what it also reads on the seeds given with
`--<also>-seeds`: generation `--int8-seeds` (the program with its own int8
path switched on), training `--fault-seeds` (the program with half of each
batch left out of its losses, the mean taken over the rest).  One JSON line
a seed."""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import model_config, run, scenes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    cell = run.cell_of(run.load_spec(), ap.parse_known_args(argv)[0].workload)
    cfg = model_config.load(cell["config"])
    mix = scenes.load(cell["traffic"])
    kind = run.kind(mix["kind"])
    for also, what in kind.CALIBRATION_SEEDS.items():
        ap.add_argument(f"--{also}-seeds", type=int, nargs="*", default=[],
                        help=what)
    args = ap.parse_args(argv)
    spec = kind.weight_spec(cfg)
    for seed in args.seeds:
        also = {a for a in kind.CALIBRATION_SEEDS
                if seed in getattr(args, f"{a}_seeds")}
        print(json.dumps(kind.calibration_line(args.workload, cfg, mix, seed,
                                               spec, also)), flush=True)
    return 0


def half_batch_losses():
    """The program's masked means over the first half of each mask's rows
    alone (the fault of a training step that leaves half its batch out)."""
    import echoscene_torch.diffusion.ddpm as ddpm
    import echoscene_torch.diffusion.ldm as ldm
    original = ddpm.masked_mean

    def half(x, mask):
        if mask is None:
            return original(x, mask)
        keep = torch.cumsum(mask, 0) <= mask.sum() / 2
        return original(x, mask * keep)
    ddpm.masked_mean = ldm.masked_mean = half

    def restore():
        ddpm.masked_mean = ldm.masked_mean = original
    return restore


if __name__ == "__main__":
    sys.exit(main())
