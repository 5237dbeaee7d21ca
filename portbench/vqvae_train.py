"""The driver of `vqvae_train` traffic: a closed loop of
`VQVAETrainer.train_step(state, batch)` calls, the step the program's
VQ-VAE training CLI makes, each on a fresh batch of the generator's seeded
64^3 SDF grids made on the device (on a stream of their own, `batch`).

Set-up builds the trainer and its state (the module and its Adam) on the
device, draws the weights from the seed (`draw_`) and drives the state
through the mix's `checked_steps` first steps, on distinct batches, through
the window's own call; they also warm every shape the window runs.  Each
step's loss, the norm of the first gradient as Adam got it (its first
moment after one step over 1 - b1) and each parameter's change after the
last checked step are kept for the check.  The same state then trains
through the window.  A traced run opens a `portbench.vqvae_step` span
around each step (its grids and its `train_step`).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Set, Tuple

import torch

from . import check, scenes
from .generate import span, sync
from .reference import vqvae as R
from .reference.model import Conv
from .trace import traced

TRACED_STEPS = 3
WEIGHT_STREAM = 7

Spec = List[Tuple[str, Tuple[int, ...], str, float]]


def program_config(cfg: Dict):
    """The program's `VQVAEConfig`, read from the file's `model.params` as
    the program's CLI reads the yaml."""
    from echoscene_torch.models.config import VQVAEConfig
    p = cfg["model"]["params"]
    out = VQVAEConfig(embed_dim=p["embed_dim"], n_embed=p["n_embed"])
    for k, v in p["ddconfig"].items():
        if hasattr(out, k):
            setattr(out, k, tuple(v) if isinstance(v, list) else v)
    return out


def weight_spec(cfg: Dict) -> Spec:
    """[(name, shape, kind, bound)] of the model's parameters in sorted
    order, with torch's default initialisation of each module, as the
    published modules get theirs: a convolution's weight and bias uniform
    in +-1 / sqrt(fan_in), a norm's scale 1 and shift 0, the codebook
    uniform in +-1 / n_embed (quantizer.py)."""
    with torch.device("meta"):
        model = R.VQVAE(R.model_dict(cfg))
    out = []
    for prefix, m in model.named_modules():
        if isinstance(m, Conv):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            out += [(f"{prefix}.{n}", tuple(getattr(m, n).shape), "uniform",
                     bound) for n in ("weight", "bias")]
        elif isinstance(m, torch.nn.GroupNorm):
            out += [(f"{prefix}.weight", (m.num_channels,), "one", 1.0),
                    (f"{prefix}.bias", (m.num_channels,), "zero", 0.0)]
        elif isinstance(m, torch.nn.Embedding):
            out.append((f"{prefix}.weight", tuple(m.weight.shape), "uniform",
                        1.0 / m.num_embeddings))
    return sorted(out)


@torch.no_grad()
def draw_(params: Dict[str, torch.Tensor], spec: Spec, seed: int,
          device) -> None:
    """Fill `params` (name -> tensor, the names and shapes of `spec`) from
    `seed` in place: one uniform stream over all the uniform parameters,
    from a generator on the device."""
    if set(params) != {n for n, _, _, _ in spec}:
        raise ValueError("parameters differ from the weight spec: "
                         f"{sorted(set(params) ^ {n for n, *_ in spec})[:5]}")
    gen = torch.Generator(device=device).manual_seed(
        scenes.torch_seed(seed, WEIGHT_STREAM))
    total = sum(math.prod(s) for _, s, k, _ in spec if k == "uniform")
    uni = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                     generator=gen)
    i = 0
    for name, shape, kind, bound in spec:
        p = params[name]
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)}, spec {shape}")
        if kind == "uniform":
            n = math.prod(shape)
            p.copy_(uni[i:i + n].view(shape) * bound)
            i += n
        else:
            p.fill_(bound)


class VQVAETraining:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, spec: Spec,
                 trace: bool):
        from echoscene_torch.train.vqvae_trainer import VQVAETrainer
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.trace = trace
        self.trainer = VQVAETrainer(
            program_config(cfg), lr=cfg["lr"],
            codebook_weight=cfg["codebook_weight"],
            compute_dtype=cfg["compute_dtype"], device=self.device)
        # the program's own state; its initial draws are replaced by ours
        self.state = self.trainer.init(torch.Generator(device=self.device))
        draw_(dict(self.state.module.named_parameters()), spec, seed,
              self.device)
        self.data_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self.steps_done = 0
        self.trace_data = None
        self.first_steps()

    # ------------------------------------------------------------------
    def batch(self, index: int) -> torch.Tensor:
        """The grids of step `index`, made on the device from the seed.  On
        a CUDA device they are made on a stream of their own, so that the
        generator's host synchronisations (`torch.nonzero`) wait for its
        own kernels and not for the steps queued before: the host stays
        ahead of the device, and its stalls do not idle it."""
        b = self.mix["batch"]

        def make():
            return scenes.analytic_sdfs(b, b, self.mix["sdf_resolution"],
                                        self.mix["sdf_clip"], self.seed,
                                        index, self.device)
        if self.device.type != "cuda":
            return make()
        with torch.cuda.stream(self.data_stream):
            x = make()
        main = torch.cuda.current_stream(self.device)
        main.wait_stream(self.data_stream)
        x.record_stream(main)
        return x

    def step(self) -> Dict[str, torch.Tensor]:
        with span(self.trace, "vqvae_step"):
            out = self.trainer.train_step(self.state,
                                          self.batch(self.steps_done))
        self.steps_done += 1
        return out

    def first_steps(self) -> None:
        """The checked steps (module docstring)."""
        named = list(self.state.module.named_parameters())
        p0 = [p.detach().clone() for _, p in named]
        self.losses = []
        for i in range(self.mix["checked_steps"]):
            self.losses.append(float(self.step()["loss_total"]))
            if i == 0:
                self.first_grad = self.adam_gradient(named)
        self.change = {n: float((p.detach() - q).norm())
                       for (n, p), q in zip(named, p0)}
        sync(self.device)

    def adam_gradient(self, named) -> Dict[str, float]:
        """Each parameter's first gradient norm, from Adam's first moment
        after one step (1 - b1 times the gradient); 0 where Adam holds no
        state, having got no gradient."""
        state = self.state.optimizer.state
        scale = 1.0 - R.BETAS[0]
        norms = torch.stack([
            state[p]["exp_avg"].norm() / scale if p in state
            else torch.zeros((), device=p.device) for _, p in named]).cpu()
        return dict(zip([n for n, _ in named], norms.tolist()))

    # ------------------------------------------------------------------
    def window(self, seconds: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.trace:
            _, self.trace_data = traced(self.traced_steps, self.device)
            return
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.step()
        sync(self.device)
        self.window_s = time.perf_counter() - t0
        self.peak_bytes = (torch.cuda.max_memory_allocated(self.device)
                           if self.device.type == "cuda" else 0)

    def traced_steps(self) -> None:
        for _ in range(TRACED_STEPS):
            self.step()

    def attempted(self) -> int:
        return self.steps_done - self.mix["checked_steps"]

    def end_to_end(self, setup_s: float) -> Dict[str, float]:
        return {"vqvae_train_grids_per_s": self.mix["batch"]
                * self.attempted() / self.window_s,
                "train_peak_mem_gib": self.peak_bytes / 2 ** 30,
                "setup_s": setup_s}

    def release(self) -> None:
        del self.trainer, self.state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """The program's checked steps against the reference's (the program
        must be released first)."""
        return check.training_numbers(self, reference_steps(self))


def reference_steps(run, tf32: bool = False) -> Dict:
    """The reference's checked steps on the run's seed and grids; with
    `tf32`, computed with TF32 products (the control)."""
    check.plain_f32()
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        model = R.VQVAE(R.model_dict(run.cfg)).to(run.device)
        draw_(dict(model.named_parameters()), weight_spec(run.cfg),
              run.seed, run.device)
        return R.train_steps(
            model, (run.batch(i) for i in range(run.mix["checked_steps"])),
            run.cfg["lr"], run.cfg["codebook_weight"])
    finally:
        check.plain_f32()


def half_batch_loss():
    """The program's loss over the first half of each batch alone (the
    fault of a step that leaves half its batch out, the mean taken over the
    rest); returns the function that restores it."""
    from echoscene_torch.train.vqvae_trainer import VQVAETrainer
    original = VQVAETrainer.loss_fn

    def half(self, module, batch):
        return original(self, module, batch[:batch.shape[0] // 2])
    VQVAETrainer.loss_fn = half

    def restore():
        VQVAETrainer.loss_fn = original
    return restore


def calibration_line(workload: str, cfg: Dict, mix: Dict, seed: int,
                     spec: Spec, also: Set[str], dev: str = "cuda:0"
                     ) -> Dict:
    """One seed's readings (`calibrate.py`): the checked steps of a run's
    set-up and the control (the reference with TF32 products) against the
    reference; with "bf16" in `also`, the program with its own bf16
    compute_dtype too, and with "fault", the program with half of each
    batch left out of its loss."""
    from .train import Steps, worst_leaves
    t0 = time.perf_counter()
    run = VQVAETraining(cfg, mix, seed, dev, spec, False)
    run.release()
    t1 = time.perf_counter()
    ref = reference_steps(run)
    t2 = time.perf_counter()
    ctl = Steps(reference_steps(run, tf32=True))
    line = {"workload": workload, "seed": seed,
            "program": check.training_numbers(run, ref),
            "control_tf32": check.training_numbers(ctl, ref),
            "program_s": t1 - t0, "reference_s": t2 - t1,
            "losses": run.losses, "reference_losses": ref["losses"],
            "worst_leaves": worst_leaves(run, ref),
            "control_tf32_detail": worst_leaves(ctl, ref)}
    if "bf16" in also:
        bf = VQVAETraining(dict(cfg, compute_dtype="bfloat16"), mix, seed,
                           dev, spec, False)
        bf.release()
        line["program_bf16"] = check.training_numbers(bf, ref)
        line["bf16_detail"] = worst_leaves(bf, ref)
    if "fault" in also:
        restore = half_batch_loss()
        try:
            bad = VQVAETraining(cfg, mix, seed, dev, spec, False)
            bad.release()
        finally:
            restore()
        line["program_half_batch"] = check.training_numbers(bad, ref)
        line["half_batch_detail"] = worst_leaves(bad, ref)
    if dev != "cpu":
        torch.cuda.empty_cache()
    return line


Driver = VQVAETraining
NUMBERS = check.TRAIN_NUMBERS
CALIBRATION_SEEDS = {
    "bf16": "also the program with its own bf16 compute_dtype",
    "fault": "also the program with half of each batch left out of its loss"}
