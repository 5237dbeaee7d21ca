"""Readings that the correctness limits are set from (not part of a run):

    python3 -m portbench.calibrate --workload <name> --seeds <n> [<n> ...]
        [--int8-seeds <n> ...] [--fault-seeds <n> ...] > readings.jsonl

For each seed, in one process: the program's numbers (a generation cell:
one generation call as a run's window makes it; a training cell: the
checked steps of its set-up; each against the float32 reference) and the
control's (the reference in the precision below the configuration's, in
the program's place, on the same inputs; the chains' updates in bfloat16
for the float32 they are stated in).  For the seeds given with
--int8-seeds (generation), also the program with its own int8 path
switched on (`sample_dtype: int8`); with --fault-seeds (training), also the
program with half of each batch left out of its losses, the mean taken
over the rest.  One JSON line a seed."""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import torch

from . import check, model_config, scenes
from .generate import Generation
from .run import cell_of, load_spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--int8-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = cell_of(load_spec(), args.workload)
    cfg = model_config.load(cell["config"])
    mix = scenes.load(cell["traffic"])
    spec = check.weight_spec(cfg)
    if mix["kind"] == "train":
        for seed in args.seeds:
            print(json.dumps(training_line(args.workload, cfg, mix, seed,
                                           spec, seed in args.fault_seeds)),
                  flush=True)
        return 0
    for seed in args.seeds:
        print(json.dumps(generation_line(args.workload, cfg, mix, seed, spec,
                                         seed in args.int8_seeds)),
              flush=True)
    return 0


def generation_line(workload: str, cfg: Dict, mix: Dict, seed: int, spec,
                    int8: bool, dev: str = "cuda:0") -> Dict:
    from .generate import Recorder, sync
    t0 = time.perf_counter()
    run = Generation(cfg, mix, seed, dev, spec, False)
    run.window(0.0)
    graph, rows, real = run.graphs[0], run.rows, run.graphs[0]["real_nodes"]
    sound = (run.rec, check.produced(run.rec, run.host, real))
    own = None
    if int8:
        run.sg.cfg.sample_dtype = "int8"
        run.rec, run.host = Recorder(False, run.rec.keep), {}
        run.rec.armed = True
        run.one_call(0)
        own = (run.rec, check.produced(run.rec, run.host, real))
    run.release()
    del run
    t1 = time.perf_counter()
    ref = check.reference(cfg, seed, dev)
    want = check.reference_outputs(ref, cfg, graph, sound[0], rows, dev)
    sync(dev)
    t2 = time.perf_counter()
    ctl = check.reference(cfg, seed, dev, "control")
    line = {"workload": workload, "seed": seed,
            "program": check.numbers(sound[1], want),
            "control": check.numbers(check.reference_outputs(
                ctl, cfg, graph, sound[0], rows, dev, torch.bfloat16), want),
            "program_s": t1 - t0, "reference_s": t2 - t1}
    del ctl
    if own is not None:
        line["program_int8"] = check.numbers(own[1], check.reference_outputs(
            ref, cfg, graph, own[0], rows, dev))
    del ref
    if dev != "cpu":
        torch.cuda.empty_cache()
    return line


class Steps:
    """Checked steps' readings, as a training run keeps them."""

    def __init__(self, r: Dict):
        self.losses, self.first_grad, self.change = (
            r["losses"], r["first_grad"], r["change"])


def half_batch_losses():
    """The program's masked means over the first half of each mask's rows
    alone (the fault of a step that leaves half its batch out)."""
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


def worst_leaves(run, ref: Dict, n: int = 4) -> Dict:
    """Beside each training number: the largest gaps of the leaves it
    compares (name, gap, program's and reference's norms), the median
    leaf's gap, the relative gap of the vector of leaf norms, and every
    step's loss gap."""
    med = float(torch.tensor(list(ref["first_grad"].values())).median())
    leaves = [k for k, v in ref["first_grad"].items()
              if v >= check.ROUNDOFF_LEAF * med]
    out = {"loss_gaps": [abs(a - b) / abs(b) for a, b in
                         zip(run.losses, ref["losses"])]}
    for key in ("first_grad", "change"):
        p, q = getattr(run, key), ref[key]
        m = float(torch.tensor([q[k] for k in leaves]).median())
        gaps = sorted(((abs(p[k] - q[k]) / max(q[k], m), k)
                       for k in leaves), reverse=True)
        out[key] = [[k, g, p[k], q[k]] for g, k in gaps[:n]]
        out[key + "_median_leaf_gap"] = gaps[len(gaps) // 2][0]
        out[key + "_norms_gap"] = float(
            torch.tensor([p[k] - q[k] for k in leaves]).norm()
            / torch.tensor([q[k] for k in leaves]).norm())
    return out


def training_line(workload: str, cfg: Dict, mix: Dict, seed: int, spec,
                  fault: bool, dev: str = "cuda:0") -> Dict:
    from .train import Training
    t0 = time.perf_counter()
    run = Training(cfg, mix, seed, dev, spec, False)
    run.release()
    t1 = time.perf_counter()
    ref = check.reference_training(run)
    t2 = time.perf_counter()
    ctl = Steps(check.reference_training(run, "control"))
    line = {"workload": workload, "seed": seed,
            "program": check.training_numbers(run, ref),
            "control": check.training_numbers(ctl, ref),
            "control_detail": worst_leaves(ctl, ref),
            "program_s": t1 - t0, "reference_s": t2 - t1,
            "losses": run.losses, "reference_losses": ref["losses"],
            "worst_leaves": worst_leaves(run, ref)}
    if fault:
        restore = half_batch_losses()
        try:
            bad = Training(cfg, mix, seed, dev, spec, False)
            bad.release()
        finally:
            restore()
        line["program_half_batch"] = check.training_numbers(bad, ref)
        line["half_batch_detail"] = worst_leaves(bad, ref)
    if dev != "cpu":
        torch.cuda.empty_cache()
    return line


if __name__ == "__main__":
    sys.exit(main())
