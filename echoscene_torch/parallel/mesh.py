"""Devices, process groups and the collectives of the port's data
parallelism.

Port of echoscene_tpu/parallel/mesh.py.  JAX runs one process over a
('data',) mesh; PyTorch's idiom is one process per device for training,
joined by `torch.distributed`, and one process with one model replica per
device for generation (parallel/dp.py `DPSampler`):
  * `resolve_devices(n, devices)` takes the place of `make_mesh`: an
    explicit device list (a device may repeat), or `cuda:0 .. cuda:n-1`,
    raising when fewer cards are visible than asked for;
  * `stack_shards` stacks per-device outputs on a leading device axis
    (numpy, as JAX's host-side helper);
  * `init_process_group` / `destroy_process_group` and `spawn`, which runs
    a function of the package on N spawned ranks joined through a
    `file://` rendezvous in a fresh temporary directory (no TCP port to
    fight over);
  * `make_mesh(data, model)`: the 2-D (data, model) layout of the ranks
    for tensor parallelism (parallel/tp.py), rank r at data r // model and
    model r % model, the row-major order of JAX's `make_mesh((data_par,
    model_par))` (`__graft_entry__.py:95-99`), with a process group per row
    (the model group) and per column (the data group);
  * the collectives the steps use (`all_reduce_`, `reduce_scatter`,
    `all_gather`, `any_rank`; over the default group or a `group`) and the
    checkpoint's `gather_to_host`.  The
    caller names the backend: NCCL for CUDA tensors, gloo for CPU ones.
    gloo given CUDA tensors (two ranks sharing one card, where NCCL
    refuses) moves them through host memory; each such hop is counted in
    `HOST_HOPS`, and no other backend does it.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# collectives that gloo ran through host memory for CUDA tensors, by name
HOST_HOPS: Dict[str, int] = {}


def resolve_devices(n: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of a data-parallel run: `devices` as given (a device may
    repeat; `n`, if given, must equal their count), else `cuda:0 ..
    cuda:n-1`, which raises when fewer cards are visible."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if not out or (n is not None and int(n) != len(out)):
            raise ValueError(f"dp_devices={n} but devices={list(devices)}")
        return out
    n = int(n or 1)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n:
        raise ValueError(f"dp_devices={n} but only {visible} CUDA devices "
                         "visible")
    return [torch.device("cuda", i) for i in range(n)]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def stack_shards(shards: Sequence) -> object:
    """Stack per-device outputs (dicts of tensors or arrays, nested) on a
    new leading axis, as host numpy arrays (bf16 as f32)."""
    if isinstance(shards[0], dict):
        return {k: stack_shards([s[k] for s in shards]) for k in shards[0]}
    return np.stack([_host(s) for s in shards], axis=0)


# --- process groups ---------------------------------------------------------
def init_process_group(rank: int, world: int, backend: str,
                       init_file: str) -> None:
    """Join `world` ranks through the rendezvous file `init_file` (which
    must not exist before the first rank starts)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    dist.init_process_group(backend, init_method="file://" + os.path.abspath(
        init_file), rank=rank, world_size=world)


def destroy_process_group() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank_and_world(group=None) -> Tuple[int, int]:
    """(rank, world size) of the current process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, model) layout of the default group:
    `data` x `model` ranks, this one at (data_rank, model_rank); the
    `model_group` joins the `model` ranks of its data index (tensor
    parallelism's collectives), the `data_group` the `data` ranks of its
    model index (the gradient mean).  Groups are None for one rank."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: object = None
    model_group: object = None

    def __deepcopy__(self, memo):   # process groups are shared, not copied
        return self


def make_mesh(data: int, model: int) -> Mesh:
    """The (data, model) layout of the default group's ranks (row-major, as
    JAX's make_mesh): every rank must call it (creating a process group is
    collective), with data x model equal to the world size."""
    rank, world = rank_and_world()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, the group has {world}")
    mesh = Mesh(data, model, rank // model, rank % model)
    if world == 1:
        return mesh
    for d in range(data):
        g = dist.new_group(list(range(d * model, (d + 1) * model)))
        if d == mesh.data_rank:
            mesh.model_group = g
    for m in range(model):
        g = dist.new_group(list(range(m, world, model)))
        if m == mesh.model_rank:
            mesh.data_group = g
    return mesh


def _rank_entry(rank: int, fn: Callable, world: int, backend: str,
                init_file: str, threads: int, args: tuple) -> None:
    torch.set_num_threads(threads)
    init_process_group(rank, world, backend, init_file)
    try:
        fn(rank, world, *args)
    finally:
        destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (),
          backend: str = "gloo") -> None:
    """Run fn(rank, world, *args) on `world` spawned processes joined in a
    process group of `backend`; returns when every rank has returned and
    raises if one raised.  `fn` must be a module-level function of an
    importable module (a spawned child imports it), and each rank gets an
    equal share of this process's CPU threads."""
    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory(prefix="echoscene_pg_") as tmp:
        torch.multiprocessing.spawn(
            _rank_entry, args=(fn, world, backend,
                               os.path.join(tmp, "rendezvous"), threads,
                               tuple(args)),
            nprocs=world, join=True)


# --- collectives ------------------------------------------------------------
def _through_host(name: str, tensors: Sequence[torch.Tensor]) -> bool:
    """Whether gloo must run this collective on host copies of CUDA
    tensors (counted in HOST_HOPS)."""
    hop = (dist.get_backend() == "gloo"
           and any(t.device.type == "cuda" for t in tensors))
    if hop:
        HOST_HOPS[name] = HOST_HOPS.get(name, 0) + 1
    return hop


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM,
                group=None) -> torch.Tensor:
    """In-place all-reduce of `t` over `group` (the default group when
    None)."""
    if _through_host("all_reduce", [t]):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _single(name: str):
    """torch.distributed's `<name>_single` where this torch has it (2.13
    deprecates the `_tensor` / `_into_tensor` names), else the older
    name."""
    old = {"reduce_scatter": "reduce_scatter_tensor",
           "all_gather": "all_gather_into_tensor"}[name]
    return getattr(dist, f"{name}_single", None) or getattr(dist, old)


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    """out (n / world,) = this rank's slice of the SUM of every rank's inp
    (n,) (JAX's psum_scatter, tiled)."""
    if _through_host("reduce_scatter", [out, inp]):
        host = out.new_empty(out.shape, device="cpu")
        _single("reduce_scatter")(host, inp.cpu())
        out.copy_(host)
    else:
        _single("reduce_scatter")(out, inp)
    return out


def all_gather(out: torch.Tensor, inp: torch.Tensor,
               group=None) -> torch.Tensor:
    """out (world * n,) = every rank's inp (n,) of `group` (the default
    group when None), in rank order (JAX's all_gather, tiled)."""
    if _through_host("all_gather", [out, inp]):
        host = out.new_empty(out.shape, device="cpu")
        _single("all_gather")(host, inp.cpu(), group=group)
        out.copy_(host)
    else:
        _single("all_gather")(out, inp, group=group)
    return out


def gather_to_host(t: torch.Tensor) -> Optional[torch.Tensor]:
    """Every rank's `t` (n,), in rank order, as one (world * n,) tensor in
    rank 0's host memory; None on the other ranks.  Rank 0 receives one
    rank's slice at a time into a buffer of one slice on its device, so no
    rank holds a full-length copy on its device."""
    rank, world = rank_and_world()
    if rank != 0:
        if _through_host("gather", [t]):
            dist.send(t.cpu(), 0)
        else:
            dist.send(t.contiguous(), 0)
        return None
    n = t.numel()
    out = torch.empty(world * n, dtype=t.dtype)
    out[:n].copy_(t.reshape(-1))
    buf = torch.empty(n, dtype=t.dtype) if _through_host("gather", [t]) \
        else torch.empty_like(t)
    for r in range(1, world):
        dist.recv(buf, r)
        out[r * n:(r + 1) * n].copy_(buf)
    return out


def any_rank(flag: bool, device) -> bool:
    """True on every rank when `flag` is true on any (a SIGINT seen by one
    rank stops all of them at the same step)."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(all_reduce_(t, dist.ReduceOp.MAX).item() > 0)


def barrier() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
