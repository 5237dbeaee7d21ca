"""Latent-cache CLI: encode every unique SDF of a dataset once.

Port of scripts/precompute_latents.py, with its flags and `--device`
(default `cuda`):

    python -m echoscene_torch.train.precompute_latents --dataset DATA \
        --ckpt VQ/epoch-best [--out DATA/latent_cache.npz] [--device cpu]

`--ckpt` takes a VQ-VAE checkpoint of `python -m
echoscene_torch.train.vqvae_cli`; without it the VQ-VAE keeps a seed-0
init, as JAX's script does.  One flag more than JAX's: `--vq_cfg`, the
VQ-VAE yaml (default: the shipped widths, JAX's `VQVAEConfig()`), whose
resolution is the grids'.  The cache (train/latents.py) feeds
`python -m echoscene_torch.train.cli --latent_cache`.
"""
from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--room_type", default="bedroom")
    p.add_argument("--out", default=None)
    p.add_argument("--ckpt", default=None,
                   help="VQ-VAE checkpoint of echoscene_torch.train.vqvae_cli")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--vq_cfg", default=None,
                   help="VQ-VAE yaml (default: the shipped widths)")
    p.add_argument("--device", default="cuda",
                   help="device the encoder runs on (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)

    from ..data.sgfront import SGFrontDataset
    from ..models.config import VQVAEConfig
    from .checkpoint import load_vqvae_params
    from .latents import (dataset_sdf_paths, precompute_latents,
                          write_latent_cache)
    from .vqvae_cli import load_vq_config
    from .vqvae_trainer import VQVAETrainer

    cfg = load_vq_config(args.vq_cfg) if args.vq_cfg else VQVAEConfig()
    ds = SGFrontDataset(args.dataset, room_type=args.room_type, use_sdf=True,
                        with_changes=False, shuffle_objs=False,
                        sdf_res=cfg.resolution)
    paths = dataset_sdf_paths(ds)
    print(f"[latents] {len(paths)} unique SDFs")
    trainer = VQVAETrainer(cfg, device=args.device)
    state = trainer.init(torch.Generator(device=args.device).manual_seed(0))
    if args.ckpt:
        load_vqvae_params(args.ckpt, state.module)
    out = precompute_latents(state.module, paths, ds.load_sdf,
                             batch=args.batch, device=args.device)
    dest = args.out or os.path.join(args.dataset, "latent_cache.npz")
    write_latent_cache(dest, out)
    print(f"[latents] wrote {len(out)} latents -> {dest}")
    return dest


if __name__ == "__main__":
    main()
