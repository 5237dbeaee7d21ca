"""Checkpoint save / restore with torch.save, in the background or not.

Port of echoscene_tpu/train/checkpoint.py in the reference's layout
(SGDiff.save / load_networks, model/SGDiff.py:49-129): one file per epoch at
<exp>/checkpoint/model<epoch>, holding the module's parameters and buffers
under the reference checkpoint's keys (`from_jax.module_to_checkpoint`: the
GCN and layout keys at the top level, the 'shape_df' and 'vqvae' sub-dicts)
plus "opt" (the AdamW state and the gradient accumulators), "epoch" and
"counter" (the train-step count).  The lr schedule is a pure function of
the step, so it needs no state.

Saves run as JAX's Orbax saves do: `save_checkpoint(..., wait=False)`
returns once every tensor is copied to host memory, and a writer thread
writes the file (to a temporary name, renamed when complete), so training
goes on while it writes.  At most one save is in flight: the next save and
every restore first wait for it (`wait_for_checkpoints`), and an exception
in the writer is raised again there.  The writer is not a daemon thread, so
the process exits only once the file is written.  VQ-VAE checkpoints
(`save_vqvae_checkpoint`, written by train/vqvae_cli.py) hold
{"vqvae": the VQVAE's state_dict, "opt": Adam's state, "step"}; the joint
model's frozen VQ-VAE loads from either kind (`load_vqvae_params`).

Under data parallelism (parallel/) every rank calls save and restore: only
rank 0 writes (its background save included), and the other ranks wait at a
barrier until rank 0 holds its snapshot (or, with wait, its file); a
restore waits for rank 0's write, then every rank reads the file.  A ZeRO-1
state (parallel/zero.py) is saved as its moments gathered in rank 0's host
memory (no rank holds them at full length on its device), in their padded
layout, with the rank count that sharded them ("opt":
{"zero1": ...}); it restores only over as many ranks and raises a clear
error otherwise, as JAX's template restore fails.  `restore_for_inference`
reads the parameters of any of these checkpoints.  A module sharded by
tensor parallelism (parallel/tp.py) is saved gathered to its full tensors,
its AdamW moments and accumulators too, so the file has the single-device
layout; rank 0, at (data 0, model 0), writes it, and a restore takes each
rank's slices of it.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Optional

import torch

from ..convert.from_jax import checkpoint_to_module, module_to_checkpoint
from ..models.sgdiff import SGDiff, TrainState, trainable_parameters
from ..parallel import tp
from ..parallel.mesh import barrier, rank_and_world

_writer: Optional[threading.Thread] = None
_error: Optional[Exception] = None


def _host_copy(obj: Any) -> Any:
    """`obj` with every tensor copied to host memory (a copy even of a CPU
    tensor), so that later in-place updates of the live tensors cannot
    reach what is written."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _write(payload: dict, path: str) -> None:
    global _error
    tmp = path + ".tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    except Exception as e:  # raised again by wait_for_checkpoints
        _error = e


def wait_for_checkpoints() -> None:
    """Wait for the save in flight, if any; raise its writer's exception."""
    global _writer, _error
    if _writer is not None:
        _writer.join()
        _writer = None
    if _error is not None:
        err, _error = _error, None
        raise err


def _save_payload(path: str, payload: dict, wait: bool = True) -> None:
    """Write `payload` (its tensors copied to host memory first) to `path`
    from a writer thread; with wait, return once the file is written."""
    global _writer
    wait_for_checkpoints()
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _writer = threading.Thread(target=_write, args=(_host_copy(payload), path),
                               name="checkpoint-writer")
    _writer.start()
    if wait:
        wait_for_checkpoints()


def save_checkpoint(path: str, sg: SGDiff, state: TrainState,
                    wait: bool = True) -> None:
    """wait=False returns once the snapshot is in host memory and lets the
    write proceed in the background; the final / interrupt save waits.
    Every rank of a data-parallel run calls it; rank 0 writes."""
    from ..parallel.zero import Zero1State, gather_state

    if isinstance(state.optimizer, Zero1State):
        opt = {"zero1": gather_state(state.optimizer)}
    else:
        opt = {"adamw": _adamw_state(sg.module,
                                     state.optimizer.state_dict(),
                                     tp.gather_tensors),
               "accum": None if state.accum is None else tp.gather_tensors(
                   _names(sg.module), state.accum, sg.module)}
    full = tp.gather_state_dict(sg.module)
    if rank_and_world()[0] == 0:
        payload = module_to_checkpoint(full)
        payload.update({"opt": opt, "epoch": state.epoch,
                        "counter": state.step})
        _save_payload(path, payload, wait)
    barrier()


def _names(module: torch.nn.Module):
    return [n for n, _ in trainable_parameters(module)]


def _adamw_state(module: torch.nn.Module, sd: dict, convert) -> dict:
    """An AdamW state_dict with each moment passed through
    convert(names, tensors, module) (its index is the parameter's place in
    `trainable_parameters`, the optimizer's order): gathered to full
    tensors for a save, sliced to this rank's for a restore."""
    sd = dict(sd, state=dict(sd["state"]))
    names = _names(module)
    for key in ("exp_avg", "exp_avg_sq"):
        idx = [i for i in sd["state"] if key in sd["state"][i]]
        new = convert([names[i] for i in idx],
                      [sd["state"][i][key] for i in idx], module)
        for i, t in zip(idx, new):
            sd["state"][i] = dict(sd["state"][i], **{key: t})
    return sd


def _local(names, tensors, module):
    plan = tp.plan_of(module)
    if plan is None:
        return list(tensors)
    return [tp.shard_tensor(t, plan.dims[n], plan.rank, plan.n)
            if n in plan.dims else t for n, t in zip(names, tensors)]


def save_vqvae_checkpoint(path: str, state) -> None:
    """A VQ-VAE training state (train/vqvae_trainer.py `VQTrainState`)."""
    _save_payload(path, {"vqvae": state.module.state_dict(),
                         "opt": state.optimizer.state_dict(),
                         "step": state.step})


def _load(path: str) -> dict:
    """The checkpoint's tensors on the CPU, once any save in flight is
    written (on every rank: rank 0 waits for its writer, the others for
    rank 0): `load_state_dict` copies them to the module's device, and the
    optimizer's to its parameters' devices (Adam keeps its step counts on
    the CPU)."""
    wait_for_checkpoints()
    barrier()
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, sg: SGDiff, state: TrainState
                       ) -> TrainState:
    """Load the module's parameters and buffers, and return `state` with
    the optimizer, accumulators, step and epoch of the checkpoint.  A
    ZeRO-1 state restores from a ZeRO-1 checkpoint of as many ranks only."""
    from ..parallel.zero import Zero1State, scatter_state

    payload = _load(path)
    opt = payload["opt"]
    zero1 = isinstance(state.optimizer, Zero1State)
    if zero1 != ("zero1" in opt):
        raise ValueError(
            f"{path} holds {'a ZeRO-1' if 'zero1' in opt else 'an AdamW'} "
            f"optimizer state; this run uses "
            f"{'ZeRO-1' if zero1 else 'AdamW'} (--zero1 must match the run "
            "that saved it)")
    sg.module.load_state_dict(tp.local_state_dict(
        sg.module, checkpoint_to_module(payload)), strict=True)
    if zero1:
        scatter_state(state.optimizer, opt["zero1"])
    else:
        state.optimizer.load_state_dict(
            _adamw_state(sg.module, opt["adamw"], _local))
        accum = opt["accum"]
        state.accum = (None if accum is None else [
            a.to(sg.device) for a in _local(_names(sg.module), accum,
                                            sg.module)])
    state.step = int(payload["counter"])
    state.epoch = int(payload["epoch"])
    return state


def restore_for_inference(path: str, module: torch.nn.Module) -> int:
    """Load parameters and buffers only (eval and serving read no optimizer
    state); returns the checkpoint's epoch."""
    payload = _load(path)
    module.load_state_dict(tp.local_state_dict(
        module, checkpoint_to_module(payload)), strict=True)
    return int(payload["epoch"])


def load_vqvae_params(path: str, module: torch.nn.Module) -> None:
    """Graft the VQ-VAE of a checkpoint whose 'vqvae' entry is a VQVAE
    state_dict (a VQ-VAE checkpoint of train/vqvae_cli.py, or a port or
    reference model<epoch> file) into `module.vqvae` (the reference loads
    its pretrained VQ-VAE frozen at construction, model/model_utils.py:
    7-32), or into `module` itself when it is the VQVAE."""
    target = getattr(module, "vqvae", module)
    target.load_state_dict(_load(path)["vqvae"], strict=True)


def latest_epoch(exp_dir: str) -> int:
    wait_for_checkpoints()
    ckdir = os.path.join(exp_dir, "checkpoint")
    best = -1
    if os.path.isdir(ckdir):
        for name in os.listdir(ckdir):
            if name.startswith("model") and name[len("model"):].isdigit():
                best = max(best, int(name[len("model"):]))
    return best
