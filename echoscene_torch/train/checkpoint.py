"""Checkpoint save / restore with torch.save.

Port of echoscene_tpu/train/checkpoint.py in the reference's layout
(SGDiff.save / load_networks, model/SGDiff.py:49-129): one file per epoch at
<exp>/checkpoint/model<epoch>, holding the module's parameters and buffers
under the reference checkpoint's keys (`from_jax.module_to_checkpoint`: the
GCN and layout keys at the top level, the 'shape_df' and 'vqvae' sub-dicts)
plus "opt" (the AdamW state and the gradient accumulators), "epoch" and
"counter" (the train-step count).  The lr schedule is a pure function of
the step, so it needs no state.  Saves are synchronous: `save_checkpoint`
returns once the file is written (JAX's Orbax saves may run in the
background).
"""
from __future__ import annotations

import os

import torch

from ..convert.from_jax import checkpoint_to_module, module_to_checkpoint
from ..models.sgdiff import SGDiff, TrainState


def save_checkpoint(path: str, sg: SGDiff, state: TrainState) -> None:
    payload = module_to_checkpoint(sg.module.state_dict())
    payload.update({"opt": {"adamw": state.optimizer.state_dict(),
                            "accum": state.accum},
                    "epoch": state.epoch, "counter": state.step})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)


def _load(path: str) -> dict:
    """The checkpoint's tensors on the CPU: `load_state_dict` copies them to
    the module's device, and the optimizer's to its parameters' devices
    (AdamW keeps its step counts on the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, sg: SGDiff, state: TrainState
                       ) -> TrainState:
    """Load the module's parameters and buffers, and return `state` with
    the optimizer, accumulators, step and epoch of the checkpoint."""
    payload = _load(path)
    sg.module.load_state_dict(checkpoint_to_module(payload), strict=True)
    state.optimizer.load_state_dict(payload["opt"]["adamw"])
    accum = payload["opt"]["accum"]
    state.accum = (None if accum is None
                   else [a.to(sg.device) for a in accum])
    state.step = int(payload["counter"])
    state.epoch = int(payload["epoch"])
    return state


def restore_for_inference(path: str, module: torch.nn.Module) -> int:
    """Load parameters and buffers only (eval and serving read no optimizer
    state); returns the checkpoint's epoch."""
    payload = _load(path)
    module.load_state_dict(checkpoint_to_module(payload), strict=True)
    return int(payload["epoch"])


def load_vqvae_params(path: str, module: torch.nn.Module) -> None:
    """Graft the frozen VQ-VAE of a checkpoint whose 'vqvae' entry is a
    VQVAE state_dict (a port or reference model<epoch> file) into
    `module.vqvae` (the reference loads its pretrained VQ-VAE frozen at
    construction, model/model_utils.py:7-32)."""
    payload = _load(path)
    module.vqvae.load_state_dict(payload["vqvae"], strict=True)


def latest_epoch(exp_dir: str) -> int:
    ckdir = os.path.join(exp_dir, "checkpoint")
    best = -1
    if os.path.isdir(ckdir):
        for name in os.listdir(ckdir):
            if name.startswith("model") and name[len("model"):].isdigit():
                best = max(best, int(name[len("model"):]))
    return best
