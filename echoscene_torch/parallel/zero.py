"""ZeRO-1: the AdamW moments sharded over the data-parallel ranks.

Port of echoscene_tpu/parallel/zero.py.  The replicated dp step
(parallel/dp.py) keeps both AdamW moments of every trainable parameter on
every rank: 2 x 4 bytes a parameter.  Here each rank owns a 1/N slice of
one flat f32 vector over the trainable parameters (in `trainable_parameters`
order, padded to a multiple of N):
  * the flat gradient is reduce-scattered (SUM) and divided by N, so each
    rank receives the mean gradient of its slice;
  * each rank updates its slice (`zero1_update_shard`): the shape
    denoiser's clip at norm 5 (the norm's sum of squares all-reduced), NaN
    -> 0, the trainable mask, Adam with bias correction from count + 1, the
    decayed weights, the lr of the count before the increment, in JAX's
    order (zero.py:126-155), plain tensor ops as XLA runs them in JAX;
  * the updated slices are all-gathered and written back into every rank's
    parameters.
reduce-scatter plus all-gather move the bytes of the dp step's all-reduce;
the moments take 2 x 4 / N bytes a parameter on each rank.

Gradient accumulation keeps MultiSteps' semantics on the sharded
accumulator, as JAX does: each micro-batch's reduce-scattered gradient is
added to `acc` (one element a rank when grad_accum == 1), and every
grad_accum calls the update runs on acc / grad_accum (the sum divided,
where the port's replicated path keeps a running mean;
`tests/test_torch_port_zero1.py` holds the two together).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.sgdiff import SGDiff, TrainState, lr_schedule, \
    trainable_parameters
from . import tp
from .dp import average_batch_stats_, average_metrics
from .mesh import (all_gather, all_reduce_, gather_to_host, rank_and_world,
                   reduce_scatter)

# optax.adamw's defaults, as models.sgdiff.make_optimizer uses them
_B1, _B2, _EPS, _WD = 0.9, 0.999, 1e-8, 1e-4
_CLIP_NORM = 5.0


@dataclasses.dataclass
class Zero1State:
    """This rank's slice of the flat AdamW state (JAX's Zero1State):
    `count` optimizer steps, `mu` / `nu` (chunk,) f32 where chunk = n_pad /
    world, `acc` the sharded sum of the micro-batch gradients ((chunk,)
    under grad_accum > 1, else one idle element), `mini_step` micro-batches
    since the last update.  `n` is the unpadded flat length; the masks
    cover this rank's slice (trainable: inside the n real entries; clip:
    the shape denoiser's parameters)."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    acc: torch.Tensor
    mini_step: int
    world: int
    n: int
    train_mask: torch.Tensor
    clip_mask: torch.Tensor

    @property
    def chunk(self) -> int:
        return self.mu.numel()


def flat_length(module: torch.nn.Module, world: int) -> Tuple[int, int]:
    """(n, n_pad): the trainable parameters' element count and that count
    padded to a multiple of `world`."""
    n = sum(p.numel() for _, p in trainable_parameters(module))
    return n, -(-n // world) * world


def shard_masks(module: torch.nn.Module, start: int, stop: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(trainable, clip) boolean masks of the flat slice [start, stop)."""
    n = 0
    clip = torch.zeros(stop - start, dtype=torch.bool, device=device)
    for name, p in trainable_parameters(module):
        lo, hi = max(n, start), min(n + p.numel(), stop)
        if lo < hi and name.startswith("shape_denoiser."):
            clip[lo - start:hi - start] = True
        n += p.numel()
    train = torch.arange(start, stop, device=device) < n
    return train, clip


def _refuse_tp(sg: SGDiff) -> None:
    plan = tp.plan_of(sg.module)
    if plan is not None and plan.n > 1:
        raise ValueError("ZeRO-1 does not compose with tensor parallelism "
                         f"(a model group of {plan.n} ranks); use the dp "
                         "step (parallel.dp.dp_train_step with the mesh)")


def init_zero1_state(sg: SGDiff, state: TrainState,
                     grad_accum: int = 1) -> TrainState:
    """`state` with its optimizer replaced by a fresh Zero1State (zeros)
    over this rank's slice of the default process group.  Refuses a module
    sharded over a model group of more than one rank, as JAX's ZeRO-1
    refuses a 'model' axis (echoscene_tpu/parallel/zero.py:166-169): the
    channel-sharded parameters would interleave with the flat partition."""
    _refuse_tp(sg)
    rank, world = rank_and_world()
    n, n_pad = flat_length(sg.module, world)
    chunk = n_pad // world
    dev = sg.device
    train, clip = shard_masks(sg.module, rank * chunk, (rank + 1) * chunk,
                              dev)
    zeros = lambda k: torch.zeros(k, dtype=torch.float32, device=dev)
    state.optimizer = Zero1State(
        count=0, mu=zeros(chunk), nu=zeros(chunk),
        acc=zeros(chunk if int(grad_accum) > 1 else 1), mini_step=0,
        world=world, n=n, train_mask=train, clip_mask=clip)
    return state


def zero1_update_shard(g_shard: torch.Tensor, p_shard: torch.Tensor,
                       mu: torch.Tensor, nu: torch.Tensor, count: int,
                       train_mask: torch.Tensor, clip_mask: torch.Tensor,
                       lr_fn: Callable[[int], float]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  int]:
    """One flat-space AdamW update of this rank's slice (JAX's
    zero1_update_shard); every rank must call it (the clip's norm is
    all-reduced).  g_shard is the mean gradient of the slice; mu and nu
    are updated in place.  Returns (new p_shard, mu, nu, count + 1)."""
    sq = torch.where(clip_mask, g_shard, 0.0).square().sum().reshape(1)
    norm = all_reduce_(sq).sqrt()
    scale = torch.clamp(_CLIP_NORM / torch.clamp(norm, min=1e-6), max=1.0)
    # the clip, then NaN -> 0 (a NaN in the subtree makes its norm NaN and
    # zeroes the whole subtree, as in the replicated path)
    g = torch.where(clip_mask, g_shard * scale, g_shard)
    g = torch.nan_to_num_(g, nan=0.0)
    frozen = ~train_mask
    g.masked_fill_(frozen, 0.0)
    t = int(count) + 1                    # optax's count_inc
    mu.mul_(_B1).add_(g, alpha=1.0 - _B1)
    nu.mul_(_B2).addcmul_(g, g, value=1.0 - _B2)
    del g
    # the bias corrections in f32, as JAX computes them
    bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(t))
    bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(t))
    upd = mu / bc1
    upd.div_((nu / bc2).sqrt_().add_(_EPS))
    upd.add_(p_shard, alpha=_WD)          # add_decayed_weights
    upd.mul_(-lr_fn(int(count)))          # the schedule reads the count
    upd.masked_fill_(frozen, 0.0)         # before the increment
    return upd.add_(p_shard), mu, nu, t


def _flat_slice(tensors: Sequence[torch.Tensor], start: int, stop: int,
                out: torch.Tensor) -> torch.Tensor:
    """out = [start, stop) of the tensors' flat concatenation, zeros past
    its end."""
    out.zero_()
    n = 0
    for t in tensors:
        lo, hi = max(n, start), min(n + t.numel(), stop)
        if lo < hi:
            out[lo - start:hi - start].copy_(t.detach().reshape(-1)[
                lo - n:hi - n])
        n += t.numel()
    return out


@torch.no_grad()
def _write_back(params: Sequence[torch.Tensor], flat: torch.Tensor) -> None:
    n = 0
    for p in params:
        p.copy_(flat[n:n + p.numel()].view(p.shape))
        n += p.numel()


def zero1_train_step(sg: SGDiff, state: TrainState, batch,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
    """One ZeRO-1 step on this rank's `batch` (JAX's
    build_zero1_train_step); every rank of the default group must call it.
    Returns the rank-averaged metrics with the loss and the global norm of
    the mean gradient before the clip."""
    _refuse_tp(sg)
    z = state.optimizer
    if not isinstance(z, Zero1State):
        raise ValueError("state.optimizer is not a Zero1State; call "
                         "init_zero1_state(sg, state) first")
    rank, world = rank_and_world()
    if world != z.world:
        raise ValueError(f"the Zero1State is sharded over {z.world} ranks, "
                         f"the process group has {world}")
    accum = max(1, int(sg.cfg.grad_accum or 1))
    chunk = z.chunk
    if accum > 1 and z.acc.numel() < chunk:
        raise ValueError("grad_accum > 1 but the Zero1State has only an "
                         "idle accumulator; call init_zero1_state(sg, "
                         "state, grad_accum=accum)")
    loss, metrics, grads = sg.loss_and_grads(batch, generator, draws)
    flat_g = torch.zeros(chunk * world, dtype=torch.float32,
                         device=sg.device)
    _flat_slice(grads, 0, z.n, flat_g[:z.n])
    del grads
    g_shard = flat_g.new_empty(chunk)
    reduce_scatter(g_shard, flat_g).div_(world)
    del flat_g
    average_batch_stats_(sg.module)
    metrics["loss"] = loss
    metrics = average_metrics(metrics)
    metrics["grad_norm"] = all_reduce_(
        g_shard.square().sum().reshape(1)).sqrt().reshape(())

    final = True
    if accum > 1:
        z.acc.add_(g_shard)
        final = z.mini_step + 1 >= accum
        g_shard = z.acc / accum if final else None
    if final:
        params = [p for _, p in trainable_parameters(sg.module)]
        p_shard = _flat_slice(params, rank * chunk, (rank + 1) * chunk,
                              torch.empty_like(z.mu))
        new_p, z.mu, z.nu, z.count = zero1_update_shard(
            g_shard, p_shard, z.mu, z.nu, z.count, z.train_mask,
            z.clip_mask, lr_schedule(sg.cfg))
        del g_shard, p_shard
        flat = new_p.new_empty(chunk * world)
        all_gather(flat, new_p)
        _write_back(params, flat)
        if accum > 1:
            z.acc.zero_()
            z.mini_step = 0
    else:
        z.mini_step += 1
    state.step += 1
    return metrics


def gather_state(z: Zero1State) -> Dict[str, object]:
    """Every rank's slice gathered in rank 0's host memory, in the padded
    layout (the checkpoint's form; every rank must call it; the moments are
    None on the other ranks, which hold no full-length copy)."""
    return {"world": z.world, "n": z.n, "count": z.count,
            "mini_step": z.mini_step, "mu": gather_to_host(z.mu),
            "nu": gather_to_host(z.nu), "acc": gather_to_host(z.acc)}


def scatter_state(z: Zero1State, saved: Dict[str, object]) -> None:
    """Load this rank's slices of a gathered state into `z`; raises unless
    it was saved over as many ranks."""
    if int(saved["world"]) != z.world or int(saved["n"]) != z.n:
        raise ValueError(
            f"this ZeRO-1 checkpoint was saved over {saved['world']} ranks "
            f"({saved['n']} trainable elements); it restores only under "
            f"--dp_devices {saved['world']} --zero1 with the same model, not "
            f"over {z.world} ranks ({z.n} elements)")
    rank, _ = rank_and_world()
    for name in ("mu", "nu", "acc"):
        mine = getattr(z, name)
        k = mine.numel()
        if saved[name].numel() != k * z.world:
            raise ValueError(f"the checkpoint's {name} has "
                             f"{saved[name].numel()} elements, want "
                             f"{k * z.world} (grad_accum differs?)")
        mine.copy_(saved[name][rank * k:(rank + 1) * k])
    z.count = int(saved["count"])
    z.mini_step = int(saved["mini_step"])
