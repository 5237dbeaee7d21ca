"""Training CLI, the train_3dfront.py analogue.

Port of echoscene_tpu/train/cli.py: the same flags and defaults (the
reference's, scripts/train_3dfront.py:21-66, plus the capacity flags), and
`--device` (default `cuda`):

    python -m echoscene_torch.train.cli --dataset DATA --exp EXP \
        --with_SDF True [--device cpu] [--max_steps N] ...

Writes args.json into the experiment directory (the eval CLI rebuilds the
model from it), trains, and saves <exp>/checkpoint/model<epoch>.

`--latent_cache` takes the latents of `python -m
echoscene_torch.train.precompute_latents` (or of JAX's
scripts/precompute_latents.py: the file is the same), so the frozen VQ
encoder leaves the step; `--vq_ckpt` takes a VQ-VAE checkpoint of `python
-m echoscene_torch.train.vqvae_cli` or a model<epoch> file.  With a
TensorBoard writer, `--preview_every N` renders sampled shapes every N
steps.

`--dp_devices N` (N > 1) trains data-parallel: this command starts N
processes (torch.multiprocessing, spawn), rank r on `cuda:r` (or on the CPU
under `--device cpu`), joined by torch.distributed over NCCL on CUDA and
gloo on the CPU, and raises when fewer cards are visible than asked for.
`--zero1` shards the AdamW moments over the ranks (parallel/zero.py); it
needs `--dp_devices > 1` and composes with `--grad_accum`.  Rank 0 writes
the log, args.json and the checkpoints.

Refused at start: bf16 on the CPU (CPU torch's bf16 conv1d weight gradient
at stride 2 on a one-token input is wrong).  f32 training runs on the CPU
and on CUDA, where the attention kernels take f32 too.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch


def bool_flag(s):
    if s in ("1", "True", True):
        return True
    if s in ("0", "False", False):
        return False
    raise ValueError(f"invalid bool flag {s!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--batchSize", type=int, default=8)
    p.add_argument("--nepoch", type=int, default=200)
    p.add_argument("--outf", type=str, default="checkpoint")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--logf", default="logs")
    p.add_argument("--exp", default="./experiments/layout_test")
    p.add_argument("--room_type", default="bedroom")
    p.add_argument("--residual", type=bool_flag, default=False)
    p.add_argument("--pooling", type=str, default="avg")
    p.add_argument("--large", type=bool_flag, default=False)
    p.add_argument("--use_scene_rels", type=bool_flag, default=True)
    p.add_argument("--separated", type=bool_flag, default=True)
    p.add_argument("--with_SDF", type=bool_flag, default=False)
    p.add_argument("--with_CLIP", type=bool_flag, default=True)
    p.add_argument("--shuffle_objs", type=bool_flag, default=True)
    p.add_argument("--with_angles", type=bool_flag, default=True)
    p.add_argument("--bin_angle", type=bool_flag, default=False,
                   help="legacy 24-bin angle + mean/std box standardisation "
                        "(train_3dfront.py:51)")
    p.add_argument("--num_box_params", type=int, default=6, choices=[6, 7])
    p.add_argument("--with_changes", type=bool_flag, default=True)
    p.add_argument("--loadmodel", type=bool_flag, default=False)
    p.add_argument("--loadepoch", type=int, default=90)
    p.add_argument("--replace_latent", type=bool_flag, default=True)
    p.add_argument("--network_type", default="echoscene",
                   choices=["echoscene", "echolayout"])
    p.add_argument("--diff_yaml", default="configs/full_mp.yaml")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--vis_num", type=int, default=2)
    p.add_argument("--max_nodes", type=int, default=0,
                   help="flat node capacity (0 = auto from batchSize)")
    p.add_argument("--max_triples", type=int, default=0)
    p.add_argument("--clip_backend", default="auto",
                   choices=["auto", "hash", "cache", "transformers"],
                   help="the RESOLVED backend is recorded in args.json so "
                        "eval matches training features")
    p.add_argument("--compute_dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="training compute precision (default: the config's, "
                        "bfloat16, on CUDA only); float32 on the CPU or CUDA")
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop after N train steps (0 = unlimited)")
    p.add_argument("--latent_cache", default=None,
                   help="precomputed VQ latents (.npz of "
                        "echoscene_torch.train.precompute_latents): the "
                        "batches carry them instead of SDF grids")
    p.add_argument("--preview_every", type=int, default=10000)
    p.add_argument("--dp_devices", type=int, default=1,
                   help="data-parallel devices: one process each, rank r on "
                        "cuda:r (or the CPU under --device cpu)")
    p.add_argument("--zero1", action="store_true",
                   help="shard the AdamW moments over the ranks (ZeRO-1: "
                        "reduce-scatter grads, all-gather params; the bytes "
                        "of the replicated step's all-reduce, 2*P/N instead "
                        "of 2*P optimizer floats a device).  Requires "
                        "--dp_devices > 1; composes with --grad_accum.")
    p.add_argument("--sdf_res", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vq_ckpt", default=None,
                   help="checkpoint file whose 'vqvae' entry is the frozen "
                        "VQ-VAE; overrides the config's shape_branch.vq_ckpt")
    p.add_argument("--diffusion_bs", type=int, default=0,
                   help="override the shape-branch object capacity (the "
                        "yaml's hyper.batch_size)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batches per optimizer step (mean of grads)")
    p.add_argument("--device", default="cuda",
                   help="device the model trains on (cuda, cuda:N or cpu)")
    return p


def _refuse_unported(args, cfg) -> None:
    on_cuda = torch.device(args.device).type == "cuda"
    if not on_cuda and cfg.compute_dtype == "bfloat16":
        raise NotImplementedError(
            "bfloat16 training on the CPU: CPU torch's bf16 conv1d weight "
            "gradient at stride 2 on a one-token input (the layout UNet's "
            "Downsample) is wrong; pass --compute_dtype float32")


def open_writer(log_dir: str):
    """A TensorBoard SummaryWriter, or None where tensorboard is missing."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        print(f"[train] tensorboard writer unavailable: {e}")
        return None
    return SummaryWriter(log_dir)


def main(argv=None, writer=None):
    """Train as the flags say; returns the final TrainState (None after a
    --dp_devices run, whose ranks run in their own processes).  writer: an
    object with TensorBoard's add_scalar / add_image to log to, in place of
    the SummaryWriter opened under <exp>/<logf> (closed by the caller; a
    single-process run only)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.zero1 and args.dp_devices <= 1:
        raise ValueError(
            "--zero1 requires dp_devices > 1 (optimizer-state sharding over "
            "the 'data' axis has nothing to shard on one device); drop "
            "--zero1 or raise --dp_devices")
    if args.dp_devices <= 1:
        return _train(args, writer)
    from ..parallel.mesh import resolve_devices, spawn

    if writer is not None:
        raise ValueError("a writer object does not cross into the spawned "
                         "ranks; rank 0 of a --dp_devices run opens its own")
    on_cuda = torch.device(args.device).type == "cuda"
    if on_cuda:
        resolve_devices(args.dp_devices)   # raises on too few cards
    spawn(_rank_main, args.dp_devices, args=(argv,),
          backend="nccl" if on_cuda else "gloo")
    return None


def _rank_main(rank: int, world: int, argv) -> None:
    """One rank of a --dp_devices run: cuda:rank, or the CPU."""
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.cuda.set_device(rank)
        args.device = f"cuda:{rank}"
    _train(args, None)


def _train(args, writer):
    from ..parallel.mesh import rank_and_world
    from ..data.clip_text import ClipTextEncoder
    from ..data.collate import CollateSpec
    from ..data.sgfront import SGFrontDataset
    from ..models.config import load_config
    from ..models.sgdiff import SGDiff
    from .checkpoint import load_vqvae_params
    from .latents import make_latent_lookup
    from .trainer import Trainer, dump_args

    cfg = load_config(args.diff_yaml, network_type=args.network_type,
                      with_clip=args.with_CLIP)
    if args.compute_dtype:
        cfg.compute_dtype = args.compute_dtype
    _refuse_unported(args, cfg)
    clip = ClipTextEncoder(args.clip_backend)
    args.clip_backend = clip.backend
    dataset = SGFrontDataset(
        root=args.dataset, split="train_scans", room_type=args.room_type,
        shuffle_objs=args.shuffle_objs, use_sdf=args.with_SDF,
        use_scene_rels=args.use_scene_rels, with_changes=args.with_changes,
        large=args.large, clip=clip, seed=args.seed, sdf_res=args.sdf_res,
        bin_angle=args.bin_angle)
    cfg.residual = args.residual
    cfg.gconv_pooling = args.pooling
    cfg.separated = args.separated
    cfg.replace_latent = args.replace_latent
    cfg.use_angles = args.with_angles
    if args.diffusion_bs:
        cfg.diffusion_bs = args.diffusion_bs
    cfg.grad_accum = max(1, args.grad_accum)
    cfg.layout_diffusion.train_stats_file = dataset.box_stats_path
    cfg.layout_denoiser.using_clip = args.with_CLIP
    max_nodes = args.max_nodes or int(args.batchSize * 16)
    max_triples = args.max_triples or max_nodes * 3
    cfg.max_nodes, cfg.max_triples = max_nodes, max_triples
    cfg.batch_scenes = args.batchSize
    if (cfg.shape_branch.sampling != "greedy"
            and cfg.network_type == "echoscene"
            and cfg.shape_branch.denoiser.message_passing):
        raise ValueError("shape_branch.sampling random/balance requires "
                         "message_passing false (reference EchoScene.py:"
                         "103-104)")

    lead = rank_and_world()[0] == 0
    os.makedirs(args.exp, exist_ok=True)
    own_writer = writer is None and lead
    if own_writer:
        writer = open_writer(os.path.join(args.exp, args.logf))
    latent_lookup = (make_latent_lookup(args.latent_cache)
                     if args.latent_cache else None)

    with contextlib.ExitStack() as stack:
        if own_writer and writer is not None:
            stack.callback(writer.close)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(args.seed)
            sgdiff = SGDiff(cfg, num_objs=len(dataset.classes),
                            num_preds=len(dataset.pred_names),
                            device=args.device, iou_stats=dataset.box_stats)
        # the separately trained VQ-VAE, frozen (reference model_utils.py:
        # 7-32); the optimizer never updates it
        vq_ckpt = args.vq_ckpt or cfg.shape_branch.vq_ckpt
        if (vq_ckpt and args.network_type == "echoscene"
                and not args.loadmodel):
            if os.path.isfile(vq_ckpt):
                load_vqvae_params(vq_ckpt, sgdiff.module)
                print(f"[train] loaded frozen VQ-VAE from {vq_ckpt}")
            else:
                print(f"[train] WARNING: vq_ckpt {vq_ckpt!r} not found; "
                      "the frozen VQ-VAE keeps its random init")
        if lead:
            dump_args(args.exp, vars(args))
        spec = CollateSpec(
            max_nodes=max_nodes, max_triples=max_triples,
            max_scenes=args.batchSize, diffusion_bs=cfg.diffusion_bs,
            with_sdf=args.with_SDF and args.network_type == "echoscene",
            sdf_res=dataset.sdf_res,
            shape_sampling=cfg.shape_branch.sampling,
            latent_res=cfg.shape_branch.denoiser.image_size,
            latent_ch=cfg.shape_branch.vqvae.embed_dim)
        trainer = Trainer(sgdiff, dataset, spec, args.exp,
                          batch_scenes=args.batchSize, seed=args.seed,
                          writer=writer, latent_lookup=latent_lookup,
                          dp_devices=args.dp_devices, zero1=args.zero1)
        state = sgdiff.init_train_state()
        if args.loadmodel:
            state = trainer.load(state, args.loadepoch)
        return trainer.train(state, args.nepoch,
                             max_steps=args.max_steps or None,
                             preview_every=args.preview_every)


if __name__ == "__main__":
    main()
