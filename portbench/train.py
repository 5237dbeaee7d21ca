"""The driver of `train` traffic: a closed loop of `SGDiff.train_step(state,
batch, draws=...)` calls, as the program's trainer makes them, over a feed
of distinct batches made from the seed.

Set-up builds one training object (the module with the seed's weights and
its AdamW state) and drives it through the mix's `checked_steps` first
steps, on distinct batches, through the window's own call and feed: the
step's loss, the per-parameter norm of the first gradient as the optimizer
chain got it (the gradients handed to `apply_gradients`, before its clip)
and, after the last of them, each parameter's change are kept for the
check.  The same
object then trains through the window.  Spans (`portbench.forward_backward`
around `loss_and_grads`, `portbench.optimizer` around `apply_gradients`)
are opened in a traced run only.
"""
from __future__ import annotations

import time
from typing import Dict, List, Set

import torch

from . import check, model_config, scenes
from .generate import scene_batch, span, sync
from .trace import traced
from .weights import draw_

TRACED_STEPS = 3


class Training:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, spec,
                 trace: bool):
        from echoscene_torch.core.graphbatch import ShapeSelection
        from echoscene_torch.models.sgdiff import SGDiff
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.trace = trace
        n_cap, t_cap = scenes.capacities(mix)
        pcfg = model_config.program_config(cfg, mix["scenes"], n_cap, t_cap)
        pcfg.diffusion_bs = mix["shape_rows"]
        g = cfg["graph"]
        self.sg = SGDiff(pcfg, g["num_objs"], g["num_preds"], device=device)
        draw_(dict(self.sg.module.named_parameters()), spec, seed, device)
        self.state = self.sg.init_train_state()
        self.graphs, self.sdfs, self.valid, self.batches = [], [], [], []
        for i in range(mix["feed"]):
            gb = scenes.graph_batch(mix, g["num_objs"], g["num_preds"], seed,
                                    i)
            valid = scenes.greedy_rows(gb, mix["shape_rows"])
            sdf = scenes.analytic_sdfs(mix["shape_rows"], valid,
                                       mix["sdf_resolution"], mix["sdf_clip"],
                                       seed, i, self.device)
            batch = scene_batch(gb, self.device)
            batch.shapes = ShapeSelection(
                sdf=sdf, num_valid=torch.tensor(valid, device=self.device))
            self.graphs.append(gb)
            self.sdfs.append(sdf)
            self.valid.append(valid)
            self.batches.append(batch)
        self.step_s: List[float] = []
        self.steps_done = 0
        self.trace_data = None
        self.first_steps()

    # ------------------------------------------------------------------
    def draws(self, index: int) -> Dict[str, torch.Tensor]:
        """The noise of step `index`, drawn on the device from the seed."""
        gen = torch.Generator(device=self.device).manual_seed(
            scenes.torch_seed(self.seed, 6, index))
        n_cap, _ = scenes.capacities(self.mix)
        m = self.mix["shape_rows"]
        sd = self.cfg["shape_branch"]
        r = sd["unet"]["image_size"]
        steps = self.cfg["layout_branch"]["diffusion_kwargs"]["time_num"]
        dev = self.device
        return {
            "change": torch.randn(n_cap, self.cfg["graph"]["embedding_dim"],
                                  generator=gen, device=dev),
            "t_scene": torch.randint(0, steps, (self.mix["scenes"] + 1,),
                                     generator=gen, device=dev),
            "noise_box": torch.randn(n_cap, 8, generator=gen, device=dev),
            "t_shape": torch.randint(0, sd["model"]["timesteps"], (m,),
                                     generator=gen, device=dev),
            "noise_shape": torch.randn(
                m, r, r, r, sd["vqvae"]["embed_dim"], generator=gen,
                device=dev)}

    def step(self) -> Dict[str, torch.Tensor]:
        i = self.steps_done
        out = self.sg.train_step(self.state,
                                 self.batches[i % len(self.batches)],
                                 draws=self.draws(i))
        self.steps_done += 1
        return out

    def first_steps(self) -> None:
        """The checked steps (module docstring); they also warm every shape
        the window runs.  The first gradient is read where the step hands
        it to the optimizer chain (clip, then AdamW): the gradients
        `apply_gradients` gets, aligned with `trainable_parameters`."""
        from echoscene_torch.models.sgdiff import trainable_parameters
        names = [n for n, _ in trainable_parameters(self.sg.module)]
        p0 = {n: p.detach().to("cpu", copy=True)
              for n, p in trainable_parameters(self.sg.module)}
        apply = self.sg.apply_gradients
        self.first_grad = {}

        def reading(state, grads, *args, **kwargs):
            if not self.first_grad:
                norms = torch.stack([g.detach().float().norm()
                                     for g in grads]).cpu()
                self.first_grad = dict(zip(names, norms.tolist()))
            return apply(state, grads, *args, **kwargs)
        self.sg.apply_gradients = reading
        self.losses = []
        try:
            for _ in range(self.mix["checked_steps"]):
                self.losses.append(float(self.step()["loss"]))
        finally:
            del self.sg.apply_gradients
        named = trainable_parameters(self.sg.module)
        self.change = {n: float((p.detach() - p0[n].to(p.device)).norm())
                       for n, p in named}
        sync(self.device)

    # ------------------------------------------------------------------
    def window(self, seconds: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.trace:
            self.span_methods()
            _, self.trace_data = traced(self.traced_steps, self.device)
            return
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.step()
        sync(self.device)
        self.step_s = [time.perf_counter() - t0]
        self.window_steps = self.steps_done - self.mix["checked_steps"]
        self.peak_bytes = (torch.cuda.max_memory_allocated(self.device)
                           if self.device.type == "cuda" else 0)

    def traced_steps(self) -> None:
        for _ in range(TRACED_STEPS):
            self.step()

    def span_methods(self) -> None:
        sg = self.sg
        for name, part in (("loss_and_grads", "forward_backward"),
                           ("apply_gradients", "optimizer")):
            method = getattr(sg, name)

            def spanned(*args, _method=method, _part=part, **kwargs):
                with span(True, _part):
                    return _method(*args, **kwargs)
            setattr(sg, name, spanned)

    def attempted(self) -> int:
        return self.steps_done - self.mix["checked_steps"]

    def end_to_end(self, setup_s: float) -> Dict[str, float]:
        return {"train_scenes_per_s": self.mix["scenes"] * self.window_steps
                / self.step_s[0],
                "train_peak_mem_gib": self.peak_bytes / 2 ** 30,
                "setup_s": setup_s}

    def release(self) -> None:
        del self.sg, self.state, self.batches
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """The program's checked steps against the reference's (the program
        must be released first)."""
        return check.training_numbers(self)


class Steps:
    """Checked steps' readings, as a training run keeps them."""

    def __init__(self, r: Dict):
        self.losses, self.first_grad, self.change = (
            r["losses"], r["first_grad"], r["change"])


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


def calibration_line(workload: str, cfg: Dict, mix: Dict, seed: int, spec,
                     also: Set[str], dev: str = "cuda:0") -> Dict:
    """One seed's readings (`calibrate.py`): the checked steps of a run's
    set-up and the control (the reference in the precision below) against
    the reference; with "fault" in `also`, the program with half of each
    batch left out of its losses, the mean taken over the rest, too."""
    from .calibrate import half_batch_losses
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
    if "fault" in also:
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


Driver = Training
weight_spec = check.weight_spec
NUMBERS = check.TRAIN_NUMBERS
CALIBRATION_SEEDS = {"fault": "also the program with half of each batch "
                              "left out of its losses"}
