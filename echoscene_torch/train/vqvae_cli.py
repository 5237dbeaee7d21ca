"""VQ-VAE training CLI.

Port of scripts/train_vqvae.py, with its flags and defaults, plus
`--device` (default `cuda`):

    python -m echoscene_torch.train.vqvae_cli --dataset DATA --exp VQ \
        [--steps 20000] [--eval_every 1000] [--device cpu] ...

Trains on batches of SDF grids drawn (with replacement, from `--seed`) from
the dataset's unique object SDFs, logs every 100 steps, evaluates the
reconstruction IoU of the first 64 SDFs every `--eval_every` steps and
writes <exp>/epoch-best when it improves, then <exp>/final: VQ-VAE
checkpoints (train/checkpoint.py `save_vqvae_checkpoint`) that
`python -m echoscene_torch.train.cli --vq_ckpt` and
`python -m echoscene_torch.train.precompute_latents --ckpt` read.  Grids
are read at the VQ-VAE's resolution (the yaml's, 64 in the shipped one).
Trains in f32 as JAX does; `--compute_dtype bfloat16` trains on bf16 casts
of the f32 masters (CUDA only: the CPU's bf16 convolution gradients are not
trusted, as in the training CLI).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import yaml

from ..models.config import VQVAEConfig

DEFAULT_VQ_CFG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "configs", "vqvae_snet.yaml")
EVAL_GRIDS = 64


def load_vq_config(path: str) -> VQVAEConfig:
    """A VQ-VAE yaml (configs/vqvae_snet.yaml layout) -> VQVAEConfig, as
    scripts/train_vqvae.py reads it."""
    with open(path) as f:
        vq_yaml = yaml.safe_load(f)["model"]["params"]
    cfg = VQVAEConfig(embed_dim=vq_yaml["embed_dim"],
                      n_embed=vq_yaml["n_embed"])
    for k, v in vq_yaml.get("ddconfig", {}).items():
        if hasattr(cfg, k):
            setattr(cfg, k, tuple(v) if isinstance(v, list) else v)
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--room_type", default="bedroom")
    p.add_argument("--exp", default="./vqvae_exp")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--eval_every", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vq_cfg", default=DEFAULT_VQ_CFG)
    p.add_argument("--compute_dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="training compute precision (default f32, JAX's)")
    p.add_argument("--device", default="cuda",
                   help="device the VQ-VAE trains on (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    if (args.compute_dtype == "bfloat16"
            and torch.device(args.device).type != "cuda"):
        raise NotImplementedError(
            "bfloat16 VQ-VAE training on the CPU: CPU torch's bf16 "
            "convolution gradients are not trusted; train in f32")

    from ..data.sgfront import SGFrontDataset
    from .checkpoint import save_vqvae_checkpoint
    from .latents import dataset_sdf_paths
    from .vqvae_trainer import VQVAETrainer

    cfg = load_vq_config(args.vq_cfg)
    ds = SGFrontDataset(args.dataset, room_type=args.room_type, use_sdf=True,
                        with_changes=False, shuffle_objs=False,
                        seed=args.seed, sdf_res=cfg.resolution)
    # unique object SDF paths (each 3D-FUTURE object once)
    paths = dataset_sdf_paths(ds)
    print(f"[vqvae] {len(paths)} unique SDFs")
    rng = np.random.default_rng(args.seed)

    def load(idx):
        return torch.from_numpy(np.stack([ds.load_sdf(paths[i])
                                          for i in idx]))

    trainer = VQVAETrainer(cfg, lr=args.lr, compute_dtype=args.compute_dtype,
                           device=args.device)
    state = trainer.init(torch.Generator(
        device=trainer.device).manual_seed(args.seed))
    n_eval = min(EVAL_GRIDS, len(paths))
    eval_idx = [range(k, min(k + args.batch, n_eval))
                for k in range(0, n_eval, args.batch)]
    os.makedirs(args.exp, exist_ok=True)
    t0 = time.time()
    for step in range(args.steps):
        logs = trainer.train_step(state, load(
            rng.choice(len(paths), size=args.batch)))
        if (step + 1) % 100 == 0:
            print(f"step {step + 1}: total {float(logs['loss_total']):.5f} "
                  f"rec {float(logs['loss_rec']):.5f} "
                  f"codebook {float(logs['loss_codebook']):.5f} "
                  f"({(step + 1) / (time.time() - t0):.2f} it/s)")
        if (step + 1) % args.eval_every == 0:
            iou, iou_std = trainer.eval_iou(state,
                                            (load(i) for i in eval_idx))
            print(f"[vqvae eval] IoU {iou:.4f} ± {iou_std:.4f}")
            if iou > trainer.best_iou:
                trainer.best_iou = iou
                save_vqvae_checkpoint(os.path.join(args.exp, "epoch-best"),
                                      state)
                print("[vqvae] saved epoch-best")
    save_vqvae_checkpoint(os.path.join(args.exp, "final"), state)
    print("[vqvae] done")
    return state


if __name__ == "__main__":
    main()
