"""Training loop: background batch producer, train step, logging,
checkpoints, SIGINT save.

Port of echoscene_tpu/train/trainer.py (reference scripts/
train_3dfront.py:142-311), on one device: the same observable behaviour
(the scalar names Loss_BBox / Loss_Translation / Loss_Size / Loss_Angle /
Loss_IoU / Loss_Shape / learning_rate, the console and `loss_log.txt` line
every `log_every` steps, epoch checkpoints at <exp>/checkpoint/model<epoch>,
SIGINT -> finish the step, save, stop, and args.json for the eval CLI).
Batches are collated on the host by a background thread and moved to the
device per step; with a latent lookup (train/latents.py) they carry
precomputed VQ latents instead of SDF grids, so the frozen encoder leaves
the step.  The TensorBoard writer is optional; with one, every
`preview_every` steps a few sampled shapes are rendered into it
(`preview_shapes`).  Periodic epoch saves run in the background
(train/checkpoint.py); the final save waits for its file.

Data parallelism (JAX's trainer.py:105-125, 175-297): with dp_devices N the
trainer runs on each of N ranks of a `torch.distributed` group (one process
per device; train/cli.py starts them) and takes `parallel.dp.dp_train_step`,
or with zero1 `parallel.zero.zero1_train_step` (zero1 needs N > 1, JAX's
rule).  Every rank iterates the same seeded global batch stream, and rank d
takes the batches whose index mod N is d: JAX's groups of N consecutive
batches, one a device, with a partial group carried across epochs and the
trailing partial group dropped, loudly, at the end of training.  Each rank
draws its noise from a generator seeded from the seed and its rank; the
step timer counts batch_scenes x N scenes a step; the log, the writer,
previews and the checkpoint files are rank 0's.
"""
from __future__ import annotations

import json
import os
import queue
import signal
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..data.collate import CollateSpec, collate_scenes
from ..models.sgdiff import SGDiff, TrainState, lr_schedule
from ..parallel.mesh import any_rank, rank_and_world
from .checkpoint import restore_checkpoint, save_checkpoint
from .profiling import StepTimer


class InterruptHandler:
    """SIGINT -> finish the current step, save, exit
    (helpers/interrupt_handler.py:4-35)."""

    def __init__(self):
        self.interrupted = False
        self._orig = None

    def __enter__(self):
        self._orig = signal.getsignal(signal.SIGINT)

        def handler(sig, frame):
            self.interrupted = True
        signal.signal(signal.SIGINT, handler)
        return self

    def __exit__(self, *a):
        signal.signal(signal.SIGINT, self._orig)
        return False


def batch_iterator(dataset, spec: CollateSpec, batch_scenes: int,
                   rng: np.random.Generator, latent_lookup=None) -> Iterator:
    """One epoch of collated batches (CPU tensors) in an order drawn from
    `rng`; the rng also drives non-greedy shape sampling.  latent_lookup:
    callable(sdf path or None) -> latent, shipped instead of SDF grids."""
    order = rng.permutation(len(dataset))
    buf = []
    for i in order:
        ex = dataset[int(i)]
        if ex is None:
            continue
        buf.append(ex)
        if len(buf) == batch_scenes:
            b = collate_scenes(buf, spec, sdf_loader=dataset.load_sdf,
                               latent_lookup=latent_lookup, rng=rng)
            if b is not None:
                yield b
            buf = []
    if buf:
        b = collate_scenes(buf, spec, sdf_loader=dataset.load_sdf,
                           latent_lookup=latent_lookup, rng=rng)
        if b is not None:
            yield b


class Prefetcher:
    """Background-thread batch producer (the torch DataLoader worker
    analog); an exception in the producer is raised in the consumer."""

    def __init__(self, make_iter, depth: int = 2):
        self.make_iter = make_iter
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _run(self):
        try:
            for b in self.make_iter():
                self.q.put(b)
        except Exception as e:
            self._error = e
        finally:
            self.q.put(None)

    def __iter__(self):
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        while True:
            b = self.q.get()
            if b is None:
                self.thread.join()
                if self._error is not None:
                    raise self._error
                return
            yield b


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s noise generator (rank 0 keeps `seed`, so a
    one-rank run draws as the single-device trainer)."""
    return int(seed) + 1_000_003 * int(rank)


class Trainer:
    def __init__(self, sgdiff: SGDiff, dataset, spec: CollateSpec,
                 exp_dir: str, batch_scenes: int = 64, log_every: int = 50,
                 ckpt_every_epochs: int = 100, seed: int = 0, writer=None,
                 latent_lookup=None, dp_devices: int = 1,
                 zero1: bool = False):
        if zero1 and dp_devices <= 1:
            raise ValueError(
                "--zero1 requires dp_devices > 1 (optimizer-state sharding "
                "over the 'data' axis has nothing to shard on one device); "
                "drop --zero1 or raise --dp_devices")
        self.rank, world = rank_and_world()
        if int(dp_devices) != world:
            raise ValueError(f"dp_devices={dp_devices} but this process is "
                             f"one of {world} ranks (train.cli starts one "
                             "process per device)")
        self.dp_devices = int(dp_devices)
        self.zero1 = zero1
        self.sgdiff = sgdiff
        self.dataset = dataset
        self.spec = spec
        self.exp_dir = exp_dir
        self.batch_scenes = batch_scenes
        self.log_every = log_every
        self.ckpt_every_epochs = ckpt_every_epochs
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(
            device=sgdiff.device).manual_seed(rank_seed(seed, self.rank))
        self.writer = writer if self.rank == 0 else None
        self.latent_lookup = latent_lookup
        self.dropped_batches = 0
        self.loss_log = os.path.join(exp_dir, "loss_log.txt")
        if self.rank == 0:
            os.makedirs(os.path.join(exp_dir, "checkpoint"), exist_ok=True)
            open(self.loss_log, "a").close()

    def _step(self, state: TrainState, batch):
        if self.dp_devices == 1:
            return self.sgdiff.train_step(state, batch, self.generator)
        if self.zero1:
            from ..parallel.zero import zero1_train_step
            return zero1_train_step(self.sgdiff, state, batch,
                                    self.generator)
        from ..parallel.dp import dp_train_step
        return dp_train_step(self.sgdiff, state, batch, self.generator)

    def prepare(self, state: TrainState) -> TrainState:
        """`state` with its optimizer swapped for a ZeRO-1 state when the
        zero1 path is selected (before a restore too, so that a ZeRO-1
        checkpoint restores into its own layout)."""
        from ..parallel.zero import Zero1State, init_zero1_state
        if self.zero1 and not isinstance(state.optimizer, Zero1State):
            state = init_zero1_state(
                self.sgdiff, state,
                grad_accum=max(1, int(self.sgdiff.cfg.grad_accum or 1)))
        return state

    def _log_scalars(self, metrics, counter: int, lr: float):
        w = self.writer
        if w is None:
            return
        # reference scalar names (train_3dfront.py:266-281)
        w.add_scalar("learning_rate", lr, counter)
        w.add_scalar("Loss_BBox", float(metrics["layout_loss"]), counter)
        w.add_scalar("Loss_Translation", float(metrics["loss.trans"]), counter)
        w.add_scalar("Loss_Size", float(metrics["loss.size"]), counter)
        w.add_scalar("Loss_Angle", float(metrics["loss.angle"]), counter)
        w.add_scalar("Loss_IoU", float(metrics["loss.liou"]), counter)
        w.add_scalar("Loss_Shape", float(metrics["shape_loss"]), counter)

    def current_lr(self, counter: int) -> float:
        """The lr the schedule gives at `counter` train steps: it advances
        once per optimizer step, every grad_accum steps."""
        cfg = self.sgdiff.cfg
        return lr_schedule(cfg)(counter // max(1, int(cfg.grad_accum or 1)))

    @torch.no_grad()
    def preview_shapes(self, batch, counter: int, num_obj: int = 2):
        """Sample shapes for `batch` and log renders of the first `num_obj`
        to the writer (the reference's gen_shape_after_foward_2 + Visualizer
        image logging, train_3dfront.py:286-292).  Training is untouched:
        the draws come from a generator of their own seeded by `counter`,
        autograd is off and every submodule's train / eval mode is
        restored.  Unlike JAX's, nothing is caught: a failing kernel launch
        must stop the run, not hide in a log line."""
        if self.writer is None or not self.sgdiff.is_echoscene:
            return
        from ..eval.render import render_sdf_grid

        modes = [(m, m.training) for m in self.sgdiff.module.modules()]
        gen = torch.Generator(device=self.sgdiff.device).manual_seed(counter)
        try:
            out = self.sgdiff.sample_fn(batch, gen, gen_shape=True)
        finally:
            for m, training in modes:
                m.training = training
        sdfs = out["shapes"][:num_obj, ..., 0].float().cpu().numpy()
        for i, g in enumerate(sdfs):
            img = render_sdf_grid(g)
            self.writer.add_image(f"gen_shape_{i}", img.transpose(2, 0, 1),
                                  counter)

    def train(self, state: TrainState, epochs: int,
              max_steps: Optional[int] = None, preview_every: int = 0,
              final_save: bool = True) -> TrainState:
        state = self.prepare(state)
        counter = state.step
        t_start = time.time()
        steps_done = 0
        n = self.dp_devices
        timer = StepTimer(self.batch_scenes * n, devices=n)
        dev = self.sgdiff.device
        lead = self.rank == 0
        # the global batch index runs on across epochs: a group of n
        # batches may span two epochs (JAX carries its partial group over)
        index = 0
        mine = None
        with InterruptHandler() as h:
            stop = False
            for epoch in range(state.epoch, epochs):
                for batch in Prefetcher(lambda: batch_iterator(
                        self.dataset, self.spec, self.batch_scenes,
                        self.rng, self.latent_lookup)):
                    if index % n == self.rank:
                        mine = batch
                    index += 1
                    if index % n:
                        continue            # the group is not complete
                    batch, mine = mine.to(dev), None
                    metrics = self._step(state, batch)
                    timer.tick()
                    counter += 1
                    steps_done += 1
                    if lead and counter % self.log_every == 0:
                        lr = self.current_lr(counter)
                        msg = ("loss at {}: box {:.4f}, shape {:.4f}. "
                               "Lr:{:.6f}".format(
                                   counter, float(metrics["layout_loss"]),
                                   float(metrics["shape_loss"]), lr))
                        print(msg)
                        with open(self.loss_log, "a") as f:
                            f.write(msg + "\n")
                        self._log_scalars(metrics, counter, lr)
                        if self.writer is not None:
                            self.writer.add_scalar("scenes_per_sec_per_chip",
                                                   timer.scenes_per_sec,
                                                   counter)
                    if lead and preview_every and counter % preview_every == 0:
                        self.preview_shapes(batch, counter)
                    interrupted = (any_rank(h.interrupted, dev) if n > 1
                                   else h.interrupted)
                    stop = interrupted or bool(
                        max_steps and steps_done >= max_steps)
                    if stop:
                        break
                state.epoch += 1
                if stop:
                    break
                if epoch % self.ckpt_every_epochs == 0:
                    # in the background: training resumes while the file
                    # is written; the final save (and any restore) waits
                    self.save(state, epoch, wait=False)
            if index % n:
                # only the final partial group is dropped, and loudly
                self.dropped_batches += index % n
                if lead:
                    print(f"[trainer] dropping {index % n} trailing "
                          f"batch(es) smaller than one dp group "
                          f"(dp_devices={n}) at end of training")
            dt_steps = time.time() - t_start
            if final_save:
                t_save = time.time()
                self.save(state, state.epoch)
                if lead:
                    print(f"[trainer] final save took "
                          f"{time.time() - t_save:.1f}s (it waits for its "
                          "file; epoch saves run in the background)")
        if steps_done and lead:
            print(f"[trainer] {steps_done} steps in {dt_steps:.1f}s "
                  f"({steps_done / dt_steps:.3f} steps/s)")
        return state

    def save(self, state: TrainState, epoch: int, wait: bool = True):
        save_checkpoint(os.path.join(self.exp_dir, "checkpoint",
                                     f"model{epoch}"), self.sgdiff, state,
                        wait=wait)
        if self.rank == 0:
            print(f"saved model_{epoch}")

    def load(self, state: TrainState, epoch: int) -> TrainState:
        return restore_checkpoint(os.path.join(
            self.exp_dir, "checkpoint", f"model{epoch}"), self.sgdiff,
            self.prepare(state))


def dump_args(exp_dir: str, args: dict):
    """args.json contract (train_3dfront.py:205-206; eval reads it back)."""
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "args.json"), "w") as f:
        json.dump(args, f, indent=2)
