#!/usr/bin/env python3
"""Export a JAX (Orbax) training checkpoint into a PyTorch port checkpoint.

    python export_jax_checkpoint.py --exp JAX_EXP --out PORT_EXP
        [--epoch N] [--dataset ROOT]

Reads JAX_EXP/args.json (written by `python -m echoscene_tpu.train.cli`),
rebuilds the experiment's configuration and the shape of its TrainState
as the JAX trainer builds them (the dataset gives the vocabulary and a
first batch; `jax.eval_shape` of `SGDiff.init`, so nothing is computed),
restores JAX_EXP/checkpoint/model<N> (the latest epoch by default) against
that template with echoscene_tpu's `restore_checkpoint`, and writes
PORT_EXP/checkpoint/model<N> with echoscene_torch's `save_checkpoint`:
  * the parameters and batch statistics through
    `from_jax.convert_echoscene_checkpoint` (the reference checkpoint's keys);
  * the AdamW moments and count through `from_jax.adam_state_from_jax`, the
    running mean of a gradient accumulation in progress (optax.MultiSteps'
    acc_grads) likewise;
  * the train-step count and the epoch.
A checkpoint of a `--zero1` run holds JAX's flat sharded Zero1State; for it
the parameters, batch statistics, step and epoch are restored as JAX's
`restore_for_inference` reads them, the port checkpoint holds a fresh
AdamW, and the tool says that the moments were left out.  args.json is
copied to PORT_EXP, so the port's eval CLI (`--exp PORT_EXP`) and train CLI
(`--exp PORT_EXP --loadmodel True --loadepoch N`) take the exported run.

This is the one file that imports both packages: it needs jax and orbax,
the port package imports neither.  It runs on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def jax_config(margs: dict, dataset_root=None):
    """(JAX config, training dataset) of an experiment, as
    echoscene_tpu/train/cli.py builds them from the same arguments."""
    from echoscene_tpu.data.clip_text import ClipTextEncoder
    from echoscene_tpu.data.sgfront import SGFrontDataset
    from echoscene_tpu.models.config import load_config

    dataset = SGFrontDataset(
        root=dataset_root or margs["dataset"], split="train_scans",
        room_type=margs["room_type"], shuffle_objs=margs["shuffle_objs"],
        use_sdf=margs["with_SDF"], use_scene_rels=margs["use_scene_rels"],
        with_changes=margs["with_changes"], large=margs["large"],
        clip=ClipTextEncoder(margs["clip_backend"]), seed=margs["seed"],
        sdf_res=margs["sdf_res"], bin_angle=margs["bin_angle"])
    cfg = load_config(margs["diff_yaml"], network_type=margs["network_type"],
                      with_clip=margs["with_CLIP"])
    cfg.residual = margs["residual"]
    cfg.gconv_pooling = margs["pooling"]
    cfg.separated = margs["separated"]
    cfg.replace_latent = margs["replace_latent"]
    cfg.use_angles = margs["with_angles"]
    if margs.get("diffusion_bs"):
        cfg.diffusion_bs = margs["diffusion_bs"]
    cfg.grad_accum = max(1, int(margs.get("grad_accum") or 1))
    if margs.get("compute_dtype"):
        cfg.compute_dtype = margs["compute_dtype"]
    cfg.layout_diffusion.train_stats_file = dataset.box_stats_path
    cfg.layout_denoiser.using_clip = margs["with_CLIP"]
    max_nodes = margs.get("max_nodes") or int(margs["batchSize"] * 16)
    cfg.max_nodes = max_nodes
    cfg.max_triples = margs.get("max_triples") or max_nodes * 3
    cfg.batch_scenes = margs["batchSize"]
    return cfg, dataset


def port_config(jcfg):
    """The same configuration as the port's dataclasses."""
    from echoscene_torch.models import config as pc

    def conv(obj, cls):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            kw[f.name] = (conv(v, getattr(pc, type(v).__name__))
                          if dataclasses.is_dataclass(v) else v)
        return cls(**kw)

    return conv(jcfg, pc.EchoSceneConfig)


def jax_template(cfg, dataset, seed: int = 0):
    """(JAX SGDiff, the trainer's first batch, the abstract TrainState its
    init gives)."""
    import jax

    from echoscene_tpu.data.collate import CollateSpec
    from echoscene_tpu.models.sgdiff import SGDiff
    from echoscene_tpu.train.trainer import batch_iterator

    sg = SGDiff(cfg, num_objs=len(dataset.classes),
                num_preds=len(dataset.pred_names),
                iou_stats=dataset.box_stats)
    spec = CollateSpec(
        max_nodes=cfg.max_nodes, max_triples=cfg.max_triples,
        max_scenes=cfg.batch_scenes, diffusion_bs=cfg.diffusion_bs,
        with_sdf=dataset.use_sdf and cfg.network_type == "echoscene",
        sdf_res=dataset.sdf_res, shape_sampling=cfg.shape_branch.sampling)
    first = next(batch_iterator(dataset, spec, cfg.batch_scenes,
                                np.random.default_rng(0)))
    return sg, first, jax.eval_shape(sg.init, jax.random.PRNGKey(seed),
                                     first)


def _find(tree, cls):
    import jax

    found = [x for x in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, cls)) if isinstance(x, cls)]
    if len(found) != 1:
        raise ValueError(f"expected one {cls.__name__} in the optimizer "
                         f"state, found {len(found)}")
    return found[0]


def export(exp: str, out: str, epoch=None, dataset_root=None) -> str:
    """Export JAX_EXP's checkpoint of `epoch` (the latest when None) into
    OUT; returns the written path."""
    import jax
    import optax
    import torch

    from echoscene_tpu.train import checkpoint as jck
    from echoscene_torch.convert import from_jax
    from echoscene_torch.models.sgdiff import SGDiff, trainable_parameters
    from echoscene_torch.train.checkpoint import save_checkpoint

    with open(os.path.join(exp, "args.json")) as f:
        margs = json.load(f)
    epoch = jck.latest_epoch(exp) if epoch is None else int(epoch)
    src = os.path.join(exp, "checkpoint", f"model{epoch}")
    if epoch < 0 or not os.path.isdir(src):
        raise FileNotFoundError(f"no JAX checkpoint {src}")
    cfg, dataset = jax_config(margs, dataset_root)
    _, _, template = jax_template(cfg, dataset,
                                  seed=int(margs.get("seed", 0)))
    zero1 = bool(margs.get("zero1"))
    restore = jck.restore_for_inference if zero1 else jck.restore_checkpoint
    state = restore(src, template)
    host = lambda t: jax.tree.map(np.asarray, t)
    params, stats = host(state.params), host(state.batch_stats)

    sg = SGDiff(port_config(cfg), len(dataset.classes),
                len(dataset.pred_names), device="cpu",
                iou_stats=dataset.box_stats)
    sg.module.load_state_dict(from_jax.to_state_dict(
        from_jax.checkpoint_to_module(from_jax.convert_echoscene_checkpoint(
            params, stats, cfg))), strict=True)
    pstate = sg.init_train_state()
    pstate.step, pstate.epoch = int(state.step), int(state.epoch)
    named = trainable_parameters(sg.module)
    names = [n for n, _ in named]
    if zero1:
        print(f"[export] {src} is a ZeRO-1 checkpoint: parameters, batch "
              "statistics, step and epoch exported; the AdamW moments were "
              "left out (the port checkpoint holds a fresh AdamW)")
    else:
        trainable = lambda t: {k: v for k, v in t.items() if k != "vqvae"}
        opt = host(state.opt_state)
        adam = _find(opt, optax.ScaleByAdamState)
        from_jax.load_adam_state(pstate.optimizer, named,
                                 from_jax.adam_state_from_jax(
                                     trainable(adam.mu), trainable(adam.nu),
                                     int(adam.count), stats, cfg, names))
        if cfg.grad_accum > 1:
            multi = _find(opt, optax.MultiStepsState)
            if int(multi.mini_step) > 0:
                acc = from_jax.checkpoint_to_module(
                    from_jax.convert_echoscene_checkpoint(
                        multi.acc_grads, stats, cfg))
                pstate.accum = [torch.from_numpy(np.array(acc[n]))
                                for n in names]
        print(f"[export] AdamW moments at count {int(adam.count)} exported")
    os.makedirs(out, exist_ok=True)
    if os.path.abspath(out) != os.path.abspath(exp):
        shutil.copy(os.path.join(exp, "args.json"),
                    os.path.join(out, "args.json"))
    dst = os.path.join(out, "checkpoint", f"model{epoch}")
    save_checkpoint(dst, sg, pstate)
    print(f"[export] {src} -> {dst} (step {pstate.step}, epoch "
          f"{pstate.epoch})")
    return dst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--exp", required=True,
                   help="the JAX experiment directory (args.json, "
                        "checkpoint/model<N>)")
    p.add_argument("--out", required=True,
                   help="the port experiment directory to write (another "
                        "directory than --exp: the JAX checkpoint is a "
                        "directory at the port file's path)")
    p.add_argument("--epoch", type=int, default=None,
                   help="the epoch to export (default: the latest)")
    p.add_argument("--dataset", default=None,
                   help="the dataset root (default: args.json's)")
    args = p.parse_args(argv)
    if os.path.abspath(args.out) == os.path.abspath(args.exp):
        p.error("--out must differ from --exp")
    export(args.exp, args.out, args.epoch, args.dataset)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
