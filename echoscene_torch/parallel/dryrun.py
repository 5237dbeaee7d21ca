"""Dry run of the port's data and tensor parallelism, and the rank job it
runs.

Port of `__graft_entry__.py`'s dryrun_multichip:

    python -m echoscene_torch.parallel.dryrun --n N [--device cpu]
        [--devices cuda:0,cuda:0,...]

spawns N ranks (gloo on the CPU, NCCL on `cuda:0 .. cuda:N-1`; `--devices`
names each rank's device, and ranks that share a card join over gloo) and
runs the tiny configuration with seeded weights and synthetic batches.  As
JAX's, N >= 4 and even carves a model axis of 2 out of the ranks, a (N / 2,
2) mesh (`__graft_entry__.py:95-97`): one dp x tp step (the shape denoiser
sharded over each model group, `tp.py`), a dp x tp generation
(`dp.dp_tp_sample`), a checkpoint round trip into a model with other
weights (the restored parameters bit-equal to the saved ones, the step
count kept), one more step on both (the step count + 1, the resumed
parameters bit-equal to the uninterrupted ones) and a generation from the
resumed model.  Otherwise (no model axis): one dp step, one ZeRO-1 step, a
ZeRO-1 checkpoint round trip into a model with other weights and one more
step on both (bit-equal as above), then, in this process, one `DPSampler`
generation over N devices.  On CUDA the ranks run torch's deterministic
algorithms.  Each stage prints its wall time.

`train_job(rank, world, job_path, out_path)` is the function each rank
runs (spawned children import it from here): it reads a job written with
torch.save — the config, the starting weights, each rank's device, a
"model_par" (the model axis; 1 by default) and a list of runs, each a mode
(dp or zero1), a grad_accum, every data index's (batch, draws) per step,
optionally a step to save a checkpoint at and resume from and a "sample"
({"batches": one a data index, "seed"}: a dp x tp generation after the
first steps and after the resumed ones); with "deterministic", torch's
deterministic algorithms; with
"relu" = "record", the branches every ReLU of each run's model took, or
with "relu" = {run name: those of every rank}, those branches forced
(`ReluBranches`) — and rank 0 writes the parameters, batch-norm
statistics, moments and metrics of every run (with the ReLU masks of
every rank, and under forcing the flipped elements' count and margin;
and its own attention kernel launches over the run, forward and backward,
by wrapper and dtype), and the collectives gloo ran through host memory,
to `out_path`.
`update_job` drives `zero1_update_shard` alone on a flat vector, as JAX's
toy-tree harness does.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import math
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from ..models.sgdiff import SGDiff
from . import tp
from .dp import DPSampler, dp_tp_sample, dp_train_step
from .mesh import make_mesh, rank_and_world, resolve_devices, spawn
from .zero import init_zero1_state, zero1_train_step


def _model(job: dict, device, seed=None, mesh=None) -> SGDiff:
    """The job's model on `device`: its weights, or fresh seeded ones; with
    a mesh of a model axis, its shape denoiser sharded over it."""
    from ..benchmarks import seeded_weights_

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        sg = SGDiff(copy.deepcopy(job["cfg"]), job["num_objs"],
                    job["num_preds"], device=device)
    if seed is None:
        sg.module.load_state_dict(job["state_dict"], strict=True)
    else:
        seeded_weights_(sg.module, seed)
    if mesh is not None and mesh.model > 1:
        tp.shard_module_(sg.module, mesh)
    return sg


def _state(sg: SGDiff, mode: str):
    state = sg.init_train_state()
    if mode == "zero1":
        state = init_zero1_state(sg, state, grad_accum=sg.cfg.grad_accum)
    return state


class ReluBranches:
    """Records, or forces, the branch every ReLU of `module` takes: without
    `force`, each call's mask x > 0 is kept in call order (`masks`); with
    `force` (a list of such masks, in call order), each call takes the
    given branches (out = x * mask), and `flips` / `margin` count the
    elements whose own sign disagrees and their largest |x| as a share of
    the call's peak |x|.  Two systems whose arithmetic differs by rounding
    send an input within rounding of 0 down different branches, and that
    element's gradient is then passed by one and not the other; forcing
    one system's branches on the other compares the rest of the step."""

    def __init__(self, module: torch.nn.Module, force=None):
        self.masks: List[torch.Tensor] = []
        self.flips, self.margin = 0, 0.0
        self._force = None if force is None else list(force)
        self._hooks = [m.register_forward_hook(self._hook)
                       for m in module.modules()
                       if isinstance(m, torch.nn.ReLU)]

    def _hook(self, mod, inp, out):
        x = inp[0]
        if self._force is None:
            self.masks.append((x > 0).cpu())
            return None
        if not self._force:
            raise RuntimeError("more ReLU calls than forced masks")
        mask = self._force.pop(0).to(x.device)
        flip = (x > 0) != mask
        if bool(flip.any()):
            self.flips += int(flip.sum())
            peak = x.detach().abs().max().clamp_min(1e-30)
            self.margin = max(self.margin, float(
                (x.detach().abs() * flip).max() / peak))
        self.masks.append(mask.cpu())
        return x * mask.to(x.dtype)

    def remove(self) -> None:
        for h in self._hooks:
            h.remove()
        if self._force:
            raise RuntimeError(f"{len(self._force)} forced ReLU masks left "
                               "unused")


def _steps(sg, state, mode, shards, device, first: int = 0, mesh=None
           ) -> List[Dict[str, float]]:
    """Steps `first`, `first` + 1, ... of this rank's shards; a step without
    draws takes them from a generator seeded by the data index and the
    step (the ranks of a model group draw alike)."""
    step = (zero1_train_step if mode == "zero1"
            else functools.partial(dp_train_step, mesh=mesh))
    data_rank = rank_and_world()[0] if mesh is None else mesh.data_rank
    out = []
    for i, (batch, draws) in enumerate(shards, first):
        gen = torch.Generator(device).manual_seed(1000 * data_rank + i)
        draws = None if draws is None else {k: v.to(device)
                                            for k, v in draws.items()}
        t0 = time.perf_counter()
        m = step(sg, state, batch.to(device), gen, draws)
        m = {k: float(v) for k, v in m.items()}
        m["wall_s"] = time.perf_counter() - t0
        out.append(m)
    return out


def _snapshot(sg: SGDiff, state) -> dict:
    """Host copies of the parameters, buffers and AdamW moments by
    parameter name (a ZeRO-1 state's gathered to rank 0, and None on the
    other ranks: every rank calls this)."""
    from ..models.sgdiff import trainable_parameters
    from .zero import Zero1State, gather_state

    full = tp.gather_state_dict(sg.module)
    out = {"params": {n: full[n].cpu().clone()
                      for n, _ in sg.module.named_parameters()},
           "buffers": {n: full[n].cpu().clone()
                       for n, _ in sg.module.named_buffers()}}
    named = trainable_parameters(sg.module)
    if isinstance(state.optimizer, Zero1State):
        full = gather_state(state.optimizer)
        if full["mu"] is None:
            out["moments"] = None
            return out
        out["moments"], off = {}, 0
        for n, p in named:
            k = p.numel()
            out["moments"][n] = tuple(full[m][off:off + k].view(p.shape)
                                      for m in ("mu", "nu"))
            off += k
    else:
        opt = state.optimizer.state
        names = [n for n, p in named if p in opt]
        mu, nu = (tp.gather_tensors(names, [opt[p][k] for _, p in named
                                            if p in opt], sg.module)
                  for k in ("exp_avg", "exp_avg_sq"))
        out["moments"] = {n: (a.cpu(), b.cpu())
                          for n, a, b in zip(names, mu, nu)}
    return out


def train_job(rank: int, world: int, job_path: str, out_path: str) -> None:
    """Run a job's training runs on this rank (see the module docstring)."""
    from ..kernels import flash_attention as fa
    from ..train.checkpoint import restore_checkpoint, save_checkpoint

    from .mesh import HOST_HOPS

    job = torch.load(job_path, weights_only=False)
    device = torch.device(job["devices"][rank])
    if job.get("deterministic"):
        # before the first cuBLAS call of this process
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    model_par = int(job.get("model_par", 1))
    mesh = (make_mesh(world // model_par, model_par) if model_par > 1
            else None)
    data_rank = rank // model_par
    steps = functools.partial(_steps, device=device, mesh=mesh)
    relu = job.get("relu")
    results = {}
    for run in job["runs"]:
        job["cfg"].grad_accum = int(run.get("grad_accum", 1))
        mode, shards = run["mode"], run["shards"][data_rank]
        sample = run.get("sample")
        sg = _model(job, device, mesh=mesh)
        state = _state(sg, mode)
        branches = None
        if relu is not None:
            forced = relu.get(run["name"]) if isinstance(relu, dict) else None
            branches = ReluBranches(sg.module,
                                    None if forced is None else forced[rank])
        at = run.get("resume_at")
        fa.reset_launches()
        t0 = time.perf_counter()
        metrics = steps(sg, state, mode, shards[:at])
        res = {"first_s": time.perf_counter() - t0}
        if sample is not None:
            res["sample"] = _sample(sg, sample, mesh, data_rank)
        if at is not None:
            ckpt = os.path.join(run["ckpt_dir"], "model")
            t0 = time.perf_counter()
            save_checkpoint(ckpt, sg, state)
            res["save_s"] = time.perf_counter() - t0
            res["saved"] = _snapshot(sg, state)
            res["saved_step"] = state.step
            metrics += steps(sg, state, mode, shards[at:], first=at)
            if branches is not None:   # the main model's steps are done
                branches.remove()
                _gather_branches(branches, res)
                branches = None
            # a model with other weights, restored, takes the same steps
            other = _model(job, device, seed=job.get("other_seed", 1),
                           mesh=mesh)
            t0 = time.perf_counter()
            other_state = restore_checkpoint(ckpt, other,
                                             _state(other, mode))
            res["restore_s"] = time.perf_counter() - t0
            res["restored"] = _snapshot(other, other_state)
            res["restored_step"] = other_state.step
            res["resumed_metrics"] = steps(other, other_state, mode,
                                           shards[at:], first=at)
            res["resumed"] = _snapshot(other, other_state)
            res["resumed_step"] = other_state.step
            if sample is not None:
                res["resumed_sample"] = _sample(other, sample, mesh,
                                                data_rank)
        if branches is not None:
            branches.remove()
            _gather_branches(branches, res)
        # this rank's attention kernel launches over the run's steps, by
        # (wrapper, dtype): forward, and the bf16 backward kernel's
        res["attention_launches"] = {
            f"{n}/{d}": c for (n, d), c in fa.LAUNCHES_BY_DTYPE.items()}
        res["attention_backward_launches"] = {
            f"{n}/{d}": c for (n, d), c in fa.BACKWARD_LAUNCHES.items()}
        res.update(_snapshot(sg, state), metrics=metrics, step=state.step)
        results[run["name"]] = res
    results["host_hops"] = dict(HOST_HOPS)
    if rank_and_world()[0] == 0:
        torch.save(results, out_path)


def _sample(sg: SGDiff, sample: dict, mesh, data_rank: int) -> dict:
    """A dp x tp generation of the data index's batch (every rank calls
    it), from `sample`'s "seed" or its injected "noises" (one a data
    index), at its "shape_rows" and "with_manipulation"; host arrays
    stacked over the data indices."""
    t0 = time.perf_counter()
    noises = sample.get("noises")
    out = dp_tp_sample(sg, sample["batches"][data_rank], mesh,
                       seed=sample.get("seed", 0),
                       noise=None if noises is None else noises[data_rank],
                       shape_rows=sample.get("shape_rows"),
                       with_manipulation=sample.get("with_manipulation",
                                                    False))
    out["wall_s"] = time.perf_counter() - t0
    return out


def _gather_branches(branches: ReluBranches, res: dict) -> None:
    """Every rank's ReLU masks, flips and margin into rank 0's `res`
    ("relu_masks" by rank, "relu_flips" summed, "relu_margin" the
    largest)."""
    import torch.distributed as dist

    rank, world = rank_and_world()
    mine = (branches.masks, branches.flips, branches.margin)
    got = [None] * world if rank == 0 else None
    dist.gather_object(mine, got, dst=0)
    if rank == 0:
        res["relu_masks"] = [g[0] for g in got]
        res["relu_flips"] = sum(g[1] for g in got)
        res["relu_margin"] = max(g[2] for g in got)


@torch.no_grad()
def tp_forward_job(rank: int, world: int, job_path: str,
                   out_path: str) -> None:
    """One shape-denoiser forward of the flagship (`benchmarks.
    build_flagship`, seeded weights; the job's "cfg" in place of
    full_mp.yaml's if it has one) sharded over all `world` ranks as one
    model group, in each of three forms: its bf16 sampling twin ("bf16"),
    the f32 module ("f32") and the int8 twin of `sample_dtype: int8`
    ("int8", built by the ranks together): the job
    holds the step's inputs ("inputs": z, t, obj_embed, triples,
    obj_mask, triple_mask), each rank's device and "iters"; rank 0 writes
    each form's output, every rank's K1 / K2 and Q1 / Q2 launches of one
    forward by wrapper (the counts set to 0 just before it and read just
    after), the ms per forward of each rank (the mean of `iters` after one
    untimed call, the card synchronised), the heads each rank's
    attention runs and each rank's `row_split_check` of the int8 twin's
    first row-split convolution."""
    import torch.distributed as dist

    from ..benchmarks import build_flagship
    from ..kernels import flash_attention as fa
    from ..kernels import int8_conv as q8
    from ..nn.attention import CrossAttention

    job = torch.load(job_path, weights_only=False)
    device = torch.device(job["devices"][rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cfg = job.get("cfg")
    sg, _ = build_flagship(device=device,
                           cfg=None if cfg is None else copy.deepcopy(cfg))
    mesh = make_mesh(1, world)
    tp.shard_module_(sg.module, mesh)
    x = {k: v.to(device) for k, v in job["inputs"].items()}
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    mine = {"heads": sorted({m.heads for m in sg.module.shape_denoiser.modules()
                             if isinstance(m, CrossAttention)})}
    outs = {}
    for form, dtype in (("bf16", "bfloat16"), ("f32", "float32"),
                        ("int8", "int8")):
        sg.cfg.sample_dtype = dtype
        model = sg.inference_module()
        call = lambda: model.shape_eps(x["z"], x["t"], x["obj_embed"],
                                       x["triples"], x["obj_mask"],
                                       x["triple_mask"])
        if form == "int8":
            name, site = next(
                (n, m.out_layers[3]) for n, m in model.named_modules()
                if isinstance(m, tp.TPResBlock))
            seen = []
            hook = site.register_forward_pre_hook(
                lambda _, inp: seen.append(inp[0].detach().clone()))
        sync()
        fa.reset_launches()
        q8.reset_launches()
        out = call()
        sync()
        mine[f"{form}_launches"] = dict(fa.LAUNCHES, **q8.LAUNCHES)
        outs[form] = out.float().cpu()
        if form == "int8":
            hook.remove()
            mine["row_split_check"] = dict(
                row_split_check(site, seen[0], mesh.model_group, world),
                site=name + ".out_layers.3")
            del seen
        t0 = time.perf_counter()
        for _ in range(int(job.get("iters", 3))):
            call()
        sync()
        mine[f"{form}_ms"] = ((time.perf_counter() - t0) * 1e3
                              / int(job.get("iters", 3)))
        del model
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    if rank == 0:
        torch.save({"outputs": outs, "ranks": ranks}, out_path)


@torch.no_grad()
def row_split_check(conv, x: torch.Tensor, group, world: int) -> dict:
    """A row-split `Int8Conv3d` (`conv`, this rank's shard of the input
    channels) on `x`, this rank's channel shard of the input it was given in
    a forward, against the unsharded `Int8Conv3d` on the whole input (the
    shards of the weight and of `x` gathered over `group`, in rank order):
    whether the outputs are bit-equal, how many elements differ, and
    whether the row-split outputs of all ranks of the group are
    bit-equal.  Every rank of the group must call it together."""
    from ..nn.quant import Int8Conv3d
    from .mesh import all_gather

    def gather(t):     # (world,) + t.shape: every rank's t in rank order
        out = t.new_empty((world * t.shape[0],) + tuple(t.shape[1:]))
        return all_gather(out, t.contiguous(), group).reshape(
            (world,) + tuple(t.shape))

    whole = lambda t: torch.cat(gather(t).unbind(0), 1)   # shards on dim 1

    w = whole(conv.weight.detach())
    full = torch.nn.Conv3d(w.shape[1], w.shape[0], w.shape[2:],
                           stride=conv.stride,
                           padding=[p for p, _ in conv.pads],
                           bias=conv.bias is not None, device=w.device)
    full.weight.copy_(w)
    if conv.bias is not None:
        full.bias.copy_(conv.bias)
    x_whole = whole(x)
    want = Int8Conv3d(full)(x_whole)
    got = conv(x)
    outs = gather(got)
    return {"x_shape": list(x.shape), "whole_x_shape": list(x_whole.shape),
            "k": w.shape[0],
            "bit_equal_to_unsharded": bool(torch.equal(got, want)),
            "differing": int((got != want).sum()),
            "ranks_bit_equal": all(bool(torch.equal(o, outs[0]))
                                   for o in outs)}


def update_job(rank: int, world: int, job_path: str, out_path: str) -> None:
    """`zero1_update_shard` on a flat vector: each step every rank holds
    the same full gradient, which is reduce-scattered and divided by the
    world size; the updated slices are all-gathered.  The job holds "params"
    and "grads" (a list, one a step) as flat f32 tensors, the boolean
    "train_mask" / "clip_mask" over them and "lr" = (lr_init, lr_step,
    lr_evo); rank 0 writes the flat parameters after every step."""
    from types import SimpleNamespace

    from ..models.sgdiff import lr_schedule
    from .mesh import all_gather, reduce_scatter
    from .zero import zero1_update_shard

    job = torch.load(job_path, weights_only=False)
    lr_init, lr_step, lr_evo = job["lr"]
    lr_fn = lr_schedule(SimpleNamespace(lr_init=lr_init, lr_step=lr_step,
                                        lr_evo=lr_evo))
    n = job["params"].numel()
    chunk = -(-n // world)
    pad = lambda t: torch.cat([t, t.new_zeros(chunk * world - n)])
    mine = slice(rank * chunk, (rank + 1) * chunk)
    flat_p = pad(job["params"].float())
    tmask, cmask = pad(job["train_mask"])[mine], pad(job["clip_mask"])[mine]
    mu, nu, count = torch.zeros(chunk), torch.zeros(chunk), 0
    history = []
    for g in job["grads"]:
        g_shard = reduce_scatter(torch.empty(chunk), pad(g.float())) / world
        new_p, mu, nu, count = zero1_update_shard(
            g_shard, flat_p[mine], mu, nu, count, tmask, cmask, lr_fn)
        flat_p = all_gather(torch.empty(chunk * world), new_p)
        history.append(flat_p[:n].clone())
    if rank == 0:
        torch.save(history, out_path)


def run_job(job: dict, backend: str, fn=train_job) -> object:
    """Write `job`, run `fn` (train_job or update_job) on
    len(job["devices"]) spawned ranks joined over `backend`, and return
    rank 0's results."""
    with tempfile.TemporaryDirectory(prefix="echoscene_job_") as tmp:
        job_path = os.path.join(tmp, "job.pt")
        out_path = os.path.join(tmp, "out.pt")
        torch.save(job, job_path)
        spawn(fn, len(job["devices"]), args=(job_path, out_path),
              backend=backend)
        return torch.load(out_path, weights_only=False)


def cpu_draws(cfg, batch, seed: int) -> Dict[str, torch.Tensor]:
    """The five draws of `SGDiff.loss_fn` from a CPU generator, so that
    runs on different devices take the same ones."""
    sd, n, m = cfg.shape_branch.denoiser, batch.num_nodes, cfg.diffusion_bs
    g = torch.Generator().manual_seed(seed)
    return {"change": torch.randn((n, cfg.embedding_dim), generator=g),
            "t_scene": torch.randint(0, cfg.layout_diffusion.time_num,
                                     (batch.num_scenes + 1,), generator=g),
            "noise_box": torch.randn((n, 8), generator=g),
            "t_shape": torch.randint(0, sd.timesteps, (m,), generator=g),
            "noise_shape": torch.randn(
                (m,) + (sd.image_size,) * 3
                + (cfg.shape_branch.vqvae.embed_dim,), generator=g)}


def tiny_job(devices, steps: int = 1, seed: int = 0, cfg=None,
             draws: bool = False, latents: bool = False,
             model_par: int = 1) -> dict:
    """The tiny configuration (or `cfg`) with seeded weights, and a
    synthetic batch per data index (the ranks over `model_par`; each rank
    without a model axis) and step (seeded by both); with `draws`, each
    step's draws made on the CPU (`cpu_draws`), else the rank's generator
    draws them on its device; with `latents`, the batches carry the frozen
    encoder's latents of their SDFs, encoded here on the CPU (the latent
    cache's path), so that runs on different devices see the same
    inputs."""
    from ..benchmarks import NUM_OBJS, NUM_PREDS, seeded_weights_, \
        synthetic_batch
    from ..models.config import tiny_config

    cfg = cfg or tiny_config()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sg = SGDiff(cfg, NUM_OBJS, NUM_PREDS, device="cpu")
    seeded_weights_(sg.module, seed)
    shards = []
    for r in range(len(devices) // model_par):
        shards.append([])
        for i in range(steps):
            b = synthetic_batch(3, cfg.max_nodes, cfg.max_triples,
                                seed=100 * r + i,
                                diffusion_bs=cfg.diffusion_bs,
                                sdf_res=cfg.shape_branch.vqvae.resolution)
            if latents:
                with torch.no_grad():
                    lat = sg.module.encode_sdf(b.shapes.sdf)
                b.shapes = dataclasses.replace(b.shapes, sdf=None,
                                               latent=lat)
            shards[r].append((b, cpu_draws(cfg, b, 100 * r + i)
                              if draws else None))
    return {"cfg": cfg, "num_objs": NUM_OBJS, "num_preds": NUM_PREDS,
            "state_dict": sg.module.state_dict(),
            "devices": [str(d) for d in devices], "runs": [],
            "shards": shards, "model_par": model_par}


def _tp_dryrun(n: int, devices, backend: str) -> None:
    """JAX's dryrun_multichip on a (n / 2, 2) mesh: dp x tp step, dp x tp
    generation, checkpoint round trip, resumed step, generation, with
    JAX's assertions (and the resumed parameters bit-equal to the
    uninterrupted run's)."""
    from ..benchmarks import synthetic_batch

    model_par = 2
    data_par = n // model_par
    job = tiny_job(devices, steps=2, model_par=model_par)
    cfg = job["cfg"]
    sample = {"seed": 0, "batches": [
        synthetic_batch(3, cfg.max_nodes, cfg.max_triples, seed=7 + i)
        for i in range(data_par)]}
    job["deterministic"] = any(torch.device(d).type == "cuda"
                               for d in devices)
    with tempfile.TemporaryDirectory(prefix="echoscene_dryrun_") as tmp:
        job["runs"] = [{"name": "tp", "mode": "dp",
                        "shards": job.pop("shards"), "resume_at": 1,
                        "ckpt_dir": tmp, "sample": sample}]
        t0 = time.perf_counter()
        r = run_job(job, backend)["tp"]
        spawn_s = time.perf_counter() - t0
    print(f"[dryrun] {n} ranks ({backend}, {[str(d) for d in devices]}), "
          f"mesh (data {data_par}, model {model_par}): spawn + the run "
          f"{spawn_s:.2f} s")
    loss = r["metrics"][0]["loss"]
    print(f"[dryrun] dp x tp train step: loss {loss:.6g}, "
          f"{r['metrics'][0]['wall_s']:.3f} s")
    if not math.isfinite(loss):
        raise RuntimeError(f"the dp x tp step's loss is {loss}")
    for key in ("sample", "resumed_sample"):
        out = r[key]
        finite = all(bool(np.isfinite(v).all()) for k, v in out.items()
                     if k != "wall_s")
        want = (data_par, cfg.max_nodes)
        print(f"[dryrun] dp x tp {key.replace('_', ' ')}: "
              f"{out['wall_s']:.3f} s, shapes {tuple(out['shapes'].shape)},"
              f" finite {finite}")
        if not (finite and tuple(out["shapes"].shape[:2]) == want):
            raise RuntimeError(f"the dp x tp {key} is not finite or its "
                               f"shapes do not start with {want}")
    restored = all(torch.equal(v, r["restored"]["params"][k])
                   for k, v in r["saved"]["params"].items())
    print(f"[dryrun] checkpoint: save {r['save_s']:.3f} s, restore into "
          f"other weights {r['restore_s']:.3f} s; parameters bit-equal "
          f"{restored}, step {r['restored_step']} (saved at "
          f"{r['saved_step']})")
    if not (restored and r["restored_step"] == r["saved_step"]):
        raise RuntimeError("the restored checkpoint differs from the saved "
                           "state")
    loss2 = r["resumed_metrics"][0]["loss"]
    same = all(torch.equal(v, r["resumed"]["params"][k])
               for k, v in r["params"].items())
    print(f"[dryrun] resumed step: loss {loss2:.6g} (uninterrupted "
          f"{r['metrics'][1]['loss']:.6g}), step {r['resumed_step']}, "
          f"parameters bit-equal to the uninterrupted run {same}")
    if not (math.isfinite(loss2) and same
            and r["resumed_step"] == r["saved_step"] + 1):
        raise RuntimeError("the resumed step is not finite, did not count, "
                           "or differs from the uninterrupted one")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=2, help="ranks (devices)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--devices", default=None,
                   help="each rank's device, comma-separated (a device may "
                        "repeat; ranks sharing a card join over gloo); "
                        "overrides --device")
    args = p.parse_args(argv)
    t_all = time.perf_counter()
    if args.devices:
        devices = resolve_devices(args.n, args.devices.split(","))
        shared = len(set(devices)) < len(devices)
        backend = ("nccl" if all(d.type == "cuda" for d in devices)
                   and not shared else "gloo")
    elif args.device == "cuda":
        devices, backend = resolve_devices(args.n), "nccl"
    else:
        devices, backend = [torch.device("cpu")] * args.n, "gloo"
    # JAX's rule for the model axis (__graft_entry__.py:95-97)
    if args.n % 2 == 0 and args.n >= 4:
        _tp_dryrun(args.n, devices, backend)
        print(f"[dryrun] all stages {time.perf_counter() - t_all:.2f} s")
        return 0
    job = tiny_job(devices, steps=2)
    shards = job.pop("shards")
    # cuDNN's weight gradients are not bit-reproducible by default
    job["deterministic"] = any(d.type == "cuda" for d in devices)
    with tempfile.TemporaryDirectory(prefix="echoscene_dryrun_") as tmp:
        job["runs"] = [
            {"name": "dp", "mode": "dp", "shards": [s[:1] for s in shards]},
            {"name": "zero1", "mode": "zero1", "shards": shards,
             "resume_at": 1, "ckpt_dir": tmp}]
        t0 = time.perf_counter()
        res = run_job(job, backend)
        spawn_s = time.perf_counter() - t0
    dp, z = res["dp"], res["zero1"]
    print(f"[dryrun] {args.n} ranks ({backend}, {[str(d) for d in devices]})"
          f": spawn + both runs {spawn_s:.2f} s")
    print(f"[dryrun] dp step: loss {dp['metrics'][0]['loss']:.6g}, "
          f"{dp['metrics'][0]['wall_s']:.3f} s")
    print(f"[dryrun] zero1 step: loss {z['metrics'][0]['loss']:.6g}, "
          f"{z['metrics'][0]['wall_s']:.3f} s")
    print(f"[dryrun] zero1 checkpoint: save {z['save_s']:.3f} s, restore "
          f"into other weights {z['restore_s']:.3f} s")
    same = all(torch.equal(z["params"][n], z["resumed"]["params"][n])
               for n in z["params"])
    print(f"[dryrun] one more step: loss {z['metrics'][1]['loss']:.6g} "
          f"uninterrupted, {z['resumed_metrics'][0]['loss']:.6g} resumed; "
          f"parameters bit-equal {same}")
    losses = [m["loss"] for r in (dp, z) for m in r["metrics"]]
    if not (same and all(math.isfinite(x) for x in losses)):
        raise RuntimeError("the dry run's steps are not finite or the "
                           "resumed run differs from the uninterrupted one")

    # generation: one DPSampler call, a batch a device
    from ..benchmarks import synthetic_batch
    t0 = time.perf_counter()
    sg = _model(job, devices[0])
    sampler = DPSampler(sg, devices)
    cfg = sg.cfg
    batches = [synthetic_batch(3, cfg.max_nodes, cfg.max_triples, seed=7 + i)
               for i in range(args.n)]
    gen = torch.Generator().manual_seed(0)
    out = sampler(batches, sampler.generators(gen), gen_shape=True)
    finite = all(bool(torch.isfinite(torch.from_numpy(v)).all())
                 for v in out.values())
    print(f"[dryrun] DPSampler generation over {args.n} devices: "
          f"{time.perf_counter() - t0:.2f} s, shapes "
          f"{tuple(out['shapes'].shape)}, finite {finite}")
    if not finite:
        raise RuntimeError("the dry run's generation is not finite")
    print(f"[dryrun] all stages {time.perf_counter() - t_all:.2f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
