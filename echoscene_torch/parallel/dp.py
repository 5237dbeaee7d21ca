"""Data-parallel training step and data-parallel generation.

Port of echoscene_tpu/parallel/dp.py (`build_dp_train_step`,
`build_dp_sample`, `build_dp_tp_sample`; the parameter sharding of tensor
parallelism is parallel/tp.py):
  * `dp_train_step` runs on every rank of a `torch.distributed` group, one
    process per device, each rank on its own flat graph batch (scenes are
    whole-shard local, so the echo GCN never crosses ranks).  As JAX's step
    under shard_map: the local loss and backward; the gradients flattened
    into one f32 bucket, all-reduced (SUM) and divided by the world size
    (`pmean`); the batch-norm running statistics and the metrics likewise
    averaged; then the replicated optimizer (`SGDiff.apply_gradients`:
    clip, NaN zeroing, AdamW, MultiSteps under grad_accum) on every rank.
  * `DPSampler` generates scenes on several devices at once.  Sampling
    needs no collective: JAX runs one program over a ('data',) mesh; here
    one process keeps one inference replica per distinct device and runs
    the shards concurrently, one thread per shard on a CUDA stream of its
    own, each with its own `torch.Generator`; outputs are stacked on a
    leading device axis, as `build_dp_sample` returns them.  A call may
    hold fewer shards than devices (the first ones run them): JAX's
    shard_map takes one batch a device and its callers pad with repeats,
    which here would be work whose outputs nobody reads.
  * Under tensor parallelism (a (data, model) `mesh.Mesh`, the shape
    denoiser sharded by `tp.shard_module_`), `dp_train_step` averages over
    the data group only and clips on the logical norm, and `dp_tp_sample`
    runs one collective `sample_fn` per rank, the model ranks of a data
    index on the same noise.
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.sgdiff import SGDiff, TrainState, trainable_parameters
from ..nn.mlp import MaskedBatchNorm
from . import tp
from .mesh import Mesh, all_reduce_, stack_shards


def batch_norm_buffers(module: torch.nn.Module) -> List[torch.Tensor]:
    """The running statistics the training forward updates (JAX's
    `batch_stats` collection)."""
    return [b for m in module.modules() if isinstance(m, MaskedBatchNorm)
            for b in (m.running_mean, m.running_var)]


def mean_across_ranks(tensors: Sequence[torch.Tensor],
                      group=None) -> List[torch.Tensor]:
    """The mean over the ranks of `group` (the default group when None) of
    each tensor (JAX's pmean), through one f32 bucket: flattened,
    all-reduced with SUM, divided by the group's size.  Returns views of
    the bucket shaped as the inputs."""
    world = dist.get_world_size(group)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    all_reduce_(flat, group=group).div_(world)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


@torch.no_grad()
def average_batch_stats_(module: torch.nn.Module, group=None) -> None:
    """Every rank's batch-norm running statistics set to their mean over
    the ranks of `group` (JAX pmeans `new_bs`; DDP's broadcast_buffers
    would copy rank 0's instead)."""
    bufs = batch_norm_buffers(module)
    if bufs:
        for b, m in zip(bufs, mean_across_ranks(bufs, group)):
            b.copy_(m)


def average_metrics(metrics: Dict[str, torch.Tensor], group=None
                    ) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of `group` of each scalar metric."""
    names = sorted(metrics)
    means = mean_across_ranks([metrics[k].detach().reshape(()).float()
                               for k in names], group)
    return {k: v for k, v in zip(names, means)}


def dp_train_step(sg: SGDiff, state: TrainState, batch,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict[str, torch.Tensor]] = None,
                  mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One data-parallel step on this rank's `batch` (JAX's
    build_dp_train_step); every rank of the default group must call it.
    With a `mesh` whose model axis shards `sg.module` (`tp.shard_module_`)
    it is the dp x tp step: the ranks of one model group take the same
    batch and draws, the gradients (each rank's shard of a sharded
    parameter), the batch-norm statistics and the metrics are averaged over
    the data group only, and the clip and the reported norm take the
    logical global norm (`tp.global_norm`).  Returns the averaged metrics
    with the loss and the global norm of the averaged gradient before the
    clip."""
    group = None if mesh is None else mesh.data_group
    loss, metrics, grads = sg.loss_and_grads(batch, generator, draws)
    grads = mean_across_ranks(grads, group)
    average_batch_stats_(sg.module, group)
    metrics["loss"] = loss
    metrics = average_metrics(metrics, group)
    names = [n for n, _ in trainable_parameters(sg.module)]
    metrics["grad_norm"] = tp.global_norm(names, grads, sg.module)
    sg.apply_gradients(state, grads, norm=functools.partial(
        tp.global_norm, module=sg.module))
    return metrics


class DPSampler:
    """`sample_fn` over several devices at once (JAX's build_dp_sample).

    devices: one per shard (a device may repeat: two shards on one card
    run concurrently on two streams).  The replicas are made once, from the
    module's weights at construction: the bf16 inference twin (or the f32
    module) on each distinct device."""

    def __init__(self, sg: SGDiff, devices: Sequence):
        self.sg = sg
        self.devices = [torch.device(d) for d in devices]
        self.models: Dict[torch.device, torch.nn.Module] = {}
        for dev in self.devices:
            if dev not in self.models:
                self.models[dev] = sg.inference_module(dev)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]

    def generators(self, generator: Optional[torch.Generator],
                   n: Optional[int] = None) -> List[torch.Generator]:
        """One generator for each of the first `n` shards (every device's
        by default) on its device, each seeded by a draw from `generator`
        (torch's default one when None) in shard order, where JAX splits
        its key once per device."""
        gens = []
        for dev in self.devices[:len(self.devices) if n is None else n]:
            where = "cpu" if generator is None else generator.device
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=where).item())
            gens.append(torch.Generator(device=dev).manual_seed(seed))
        return gens

    def __call__(self, batches: Sequence, generators: Sequence,
                 gen_shape: bool = True, with_manipulation: bool = False,
                 shape_rows: Optional[int] = None,
                 noises: Optional[Sequence[dict]] = None):
        """batches / generators (/ noises): one per shard, in device order,
        at most one a device.  Returns the outputs as host arrays stacked on
        a leading shard axis (`mesh.stack_shards`)."""
        n = len(batches)
        if not (0 < n <= len(self.devices) and len(generators) == n):
            raise ValueError(f"{n} batches and {len(generators)} generators "
                             f"for {len(self.devices)} devices")
        outs: List[Optional[dict]] = [None] * n
        errors: List[BaseException] = []
        # OpenMP's thread count is per thread: each shard takes the
        # caller's, so a CPU shard sums in the caller's order
        cpu_threads = torch.get_num_threads()

        def run(i: int) -> None:
            dev, stream = self.devices[i], self.streams[i]
            torch.set_num_threads(cpu_threads)
            try:
                with torch.no_grad():
                    if stream is None:
                        outs[i] = self._sample(i, batches, generators,
                                               gen_shape, with_manipulation,
                                               shape_rows, noises)
                        return
                    with torch.cuda.device(dev), torch.cuda.stream(stream):
                        # the replica's weights were written on the
                        # device's default stream
                        stream.wait_stream(torch.cuda.default_stream(dev))
                        outs[i] = self._sample(i, batches, generators,
                                               gen_shape, with_manipulation,
                                               shape_rows, noises)
            except BaseException as e:  # raised again in the caller
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,),
                                    name=f"dp-sample-{i}")
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return stack_shards(outs)

    def _sample(self, i, batches, generators, gen_shape, with_manipulation,
                shape_rows, noises) -> dict:
        dev = self.devices[i]
        noise = None
        if noises is not None:
            noise = {k: v.to(dev) for k, v in noises[i].items()}
        out = self.sg.sample_fn(batches[i].to(dev), generators[i],
                                gen_shape=gen_shape,
                                with_manipulation=with_manipulation,
                                shape_rows=shape_rows, noise=noise,
                                model=self.models[dev], device=dev)
        # copied to host on this shard's stream, which waits for it
        return {k: v.cpu() for k, v in out.items()}


@torch.no_grad()
def dp_tp_sample(sg: SGDiff, batch, mesh: Mesh, seed: int = 0,
                 noise: Optional[Dict[str, torch.Tensor]] = None,
                 gen_shape: bool = True, with_manipulation: bool = False,
                 shape_rows: Optional[int] = None):
    """dp x tp generation (JAX's build_dp_tp_sample, echoscene_tpu/parallel/
    dp.py:167-185): every rank of the mesh calls it with the batch of its
    data index; the ranks of one model group draw identical noise (a
    generator seeded from `seed` and the data index only, or the injected
    `noise`) and run `sample_fn` on the sharded module's sampling twin,
    whose shape denoiser sums over the model group.  Returns every data
    index's outputs stacked on a leading axis (host arrays, bf16 as f32),
    on every rank."""
    dev = sg.device
    gen = torch.Generator(dev).manual_seed(int(np.random.SeedSequence(
        [int(seed), mesh.data_rank]).generate_state(1, np.uint64)[0] >> 2))
    out = sg.sample_fn(batch.to(dev), gen, gen_shape=gen_shape,
                       with_manipulation=with_manipulation,
                       shape_rows=shape_rows,
                       noise=None if noise is None else {
                           k: v.to(dev) for k, v in noise.items()})
    host = {k: v.cpu() for k, v in out.items()}
    shards = [host]
    if mesh.data > 1:
        shards = [None] * mesh.data
        dist.all_gather_object(shards, host, group=mesh.data_group)
    return stack_shards(shards)
