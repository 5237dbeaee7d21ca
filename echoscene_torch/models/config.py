"""Configuration tree for the EchoScene family.

Mirrors the reference's two-tier config (argparse CLI + OmegaConf YAML tree,
scripts/train_3dfront.py:21-66 + config/full_mp.yaml) with plain dataclasses
and a PyYAML loader that understands the SAME yaml files (hyper /
layout_branch / shape_branch / misc sections, with shape_branch.df_cfg /
vq_cfg pointing at nested yaml files).

A copy of echoscene_tpu/models/config.py (it imports only yaml, but the port
cannot import any echoscene_tpu module without pulling in jax).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import yaml


@dataclass
class LayoutDenoiserConfig:
    in_channels: int = 8
    out_channels: int = 8
    model_channels: int = 512
    channel_mult: Tuple[int, ...] = (1, 1, 1, 1)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2)
    num_heads: int = 8
    transformer_depth: int = 1
    conditioning_key: str = "crossattn"
    concat_dim: int = 1280
    crossattn_dim: int = 1280
    use_checkpoint: bool = True
    enable_t_emb: bool = True
    using_clip: bool = True
    # echo GCN depth inside the denoiser (reference box_graph_cov: 5 layers,
    # denoise_net.py:716-740); configurable so CPU dry runs can shrink it
    gconv_num_layers: int = 5


@dataclass
class LayoutDiffusionConfig:
    schedule_type: str = "linear"
    beta_start: float = 1e-4
    beta_end: float = 0.02
    time_num: int = 1000
    model_mean_type: str = "eps"
    model_var_type: str = "fixedsmall"
    loss_separate: bool = True
    loss_iou: bool = False
    iou_type: str = "obb"
    train_stats_file: Optional[str] = None
    # OPTIONAL fast sampling (protocol parity is the full ancestral chain):
    # 'ddpm' = full chain; 'ddim'/'dpmpp' integrate the probability-flow ODE
    # over `sample_steps` sub-steps.
    sampler: str = "ddpm"
    sample_steps: int = 50


@dataclass
class ShapeDenoiserConfig:
    image_size: int = 16
    in_channels: int = 3
    out_channels: int = 3
    model_channels: int = 224
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2)
    channel_mult: Tuple[int, ...] = (1, 2, 3)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 1280
    use_checkpoint: bool = True
    # echo GCN depth (reference shape_code_graph_cov: 5 layers,
    # openai_model_3d.py:744-782); configurable for CPU dry runs
    gconv_num_layers: int = 5
    message_passing: bool = True
    enable_t_emb: bool = True
    conditioning_key: str = "crossattn"
    # sampling-only Winograd F(2,3)^3 3x3x3 convs (kernels/winograd.py);
    # set on the inference twin via EchoSceneConfig.sample_conv
    winograd: bool = False
    # sampling-only exact factored upsample+conv (blocks.py) -- set on the
    # inference twin by SGDiff; its backward is slower than repeat+conv's
    factored_upsample: bool = False
    # LDM schedule (model.params in sdfusion yaml)
    linear_start: float = 0.00085
    linear_end: float = 0.012
    timesteps: int = 1000


@dataclass
class VQVAEConfig:
    embed_dim: int = 3
    n_embed: int = 8192
    z_channels: int = 3
    resolution: int = 64
    in_channels: int = 1
    out_ch: int = 1
    ch: int = 64
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 1
    attn_resolutions: Tuple[int, ...] = ()
    dropout: float = 0.0
    # sampling-only exact factored upsample+conv in the decoder
    factored_upsample: bool = False


@dataclass
class ShapeBranchConfig:
    sampling: str = "greedy"       # greedy | random | balance
    sampler: str = "ddim"          # ddim (protocol parity) | dpmpp (optional)
    ddim_steps: int = 100
    ddim_eta: float = 0.0
    uc_scale: float = 3.0
    vq_ckpt: Optional[str] = None
    denoiser: ShapeDenoiserConfig = field(default_factory=ShapeDenoiserConfig)
    vqvae: VQVAEConfig = field(default_factory=VQVAEConfig)


@dataclass
class EchoSceneConfig:
    """Everything needed to build the joint model."""
    network_type: str = "echoscene"        # echoscene | echolayout
    # graph encoder (SGDiff.py:21-26 defaults)
    embedding_dim: int = 64
    gconv_pooling: str = "avg"
    gconv_num_layers: int = 5
    mlp_normalization: str = "batch"
    separated: bool = True
    replace_latent: bool = True            # replace_all_latent
    residual: bool = False
    use_angles: bool = True
    with_clip: bool = True
    num_objs: int = 0                      # coarse classes (vocab-derived)
    num_preds: int = 0
    diffusion_bs: int = 64                 # shape-branch object capacity
    # batching capacities (TPU static shapes)
    max_nodes: int = 512
    max_triples: int = 1024
    batch_scenes: int = 64
    # branches
    layout_denoiser: LayoutDenoiserConfig = field(default_factory=LayoutDenoiserConfig)
    layout_diffusion: LayoutDiffusionConfig = field(default_factory=LayoutDiffusionConfig)
    shape_branch: ShapeBranchConfig = field(default_factory=ShapeBranchConfig)
    # training (hyper section)
    lr_init: float = 1e-4
    lr_step: Tuple[int, ...] = (35000, 70000, 140000)
    lr_evo: Tuple[float, ...] = (5e-5, 1e-5, 5e-6)
    grad_accum: int = 1                    # microbatches per optimizer step
                                           # (reach the reference's batch 64
                                           # within one chip's HBM: e.g.
                                           # batchSize 16 x grad_accum 4)
    # precision
    compute_dtype: str = "bfloat16"        # training compute: 'bfloat16' |
                                           # 'float32'.  bf16 mixed precision
                                           # (f32 master params/AdamW state,
                                           # bf16 module compute) is the
                                           # DEFAULT: +15.5% train throughput,
                                           # convergence within f32 noise on
                                           # the r4 A/B (BASELINE.md).  This
                                           # single default is what bench.py
                                           # regression-guards; --compute_dtype
                                           # float32 is the escape hatch.
    sample_dtype: str = "bfloat16"         # sampling compute (denoiser+decoder):
                                           # 'float32' | 'bfloat16' | 'int8'
                                           # (int8 = experimental W8A8 shape-UNet
                                           # convs, ~1.3x conv speedup on v5e);
                                           # chain/posterior math stays f32
    sample_conv: str = "direct"            # 3x3x3 conv algorithm in the shape
                                           # UNet sampling path: 'direct' (XLA
                                           # conv emitter) | 'winograd'
                                           # (F(2,3)^3, kernels/winograd.py —
                                           # 3.375x fewer MACs, same math)


def _tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else x


def load_config(diff_yaml: str, network_type: str = "echoscene",
                with_clip: bool = True) -> EchoSceneConfig:
    """Load a reference-format yaml tree (config/full_mp.yaml and nested files)."""
    with open(diff_yaml) as f:
        root = yaml.safe_load(f)
    cfg = EchoSceneConfig(network_type=network_type, with_clip=with_clip)

    hyper = root.get("hyper", {})
    if hyper.get("batch_size"):
        cfg.diffusion_bs = int(hyper["batch_size"])
        cfg.batch_scenes = int(hyper["batch_size"])
    cfg.lr_init = float(hyper.get("lr_init", cfg.lr_init))
    if "lr_step" in hyper:
        cfg.lr_step = tuple(int(v) for v in hyper["lr_step"])
    if "lr_evo" in hyper:
        cfg.lr_evo = tuple(float(v) for v in hyper["lr_evo"])

    lb = root.get("layout_branch", {})
    dk = dict(lb.get("denoiser_kwargs", {}))
    dk.pop("dims", None)
    dk.pop("use_spatial_transformer", None)
    ld = LayoutDenoiserConfig()
    for k, v in dk.items():
        if hasattr(ld, k):
            setattr(ld, k, _tuple(v))
    cfg.layout_denoiser = ld
    dif = dict(lb.get("diffusion_kwargs", {}))
    lc = LayoutDiffusionConfig()
    for k, v in dif.items():
        if hasattr(lc, k):
            setattr(lc, k, v)
    cfg.layout_diffusion = lc

    sb = root.get("shape_branch", {})
    sbc = ShapeBranchConfig(
        sampling=sb.get("sampling", "greedy"),
        sampler=sb.get("sampler", "ddim"),
        ddim_steps=int(sb.get("ddim_steps", 100)),
        ddim_eta=float(sb.get("ddim_eta", 0.0)),
        uc_scale=float(sb.get("uc_scale", 3.0)),
        vq_ckpt=sb.get("vq_ckpt"))
    base = os.path.dirname(os.path.abspath(diff_yaml))

    def _resolve(p):
        if p is None:
            return None
        cand = p if os.path.isabs(p) else os.path.normpath(os.path.join(base, p))
        if not os.path.exists(cand) and os.path.exists(os.path.join(base, os.path.basename(p))):
            cand = os.path.join(base, os.path.basename(p))
        return cand

    df_cfg = _resolve(sb.get("df_cfg"))
    if df_cfg and os.path.exists(df_cfg):
        with open(df_cfg) as f:
            df = yaml.safe_load(f)
        un = dict(df.get("unet", {}).get("params", {}))
        sd = ShapeDenoiserConfig()
        rename = {"messsage_passing": "message_passing"}
        for k, v in un.items():
            k = rename.get(k, k)
            if hasattr(sd, k):
                setattr(sd, k, _tuple(v))
        mp = df.get("model", {}).get("params", {})
        sd.linear_start = float(mp.get("linear_start", sd.linear_start))
        sd.linear_end = float(mp.get("linear_end", sd.linear_end))
        sd.timesteps = int(mp.get("timesteps", sd.timesteps))
        sd.conditioning_key = mp.get("conditioning_key", sd.conditioning_key)
        sbc.denoiser = sd
    vq_cfg = _resolve(sb.get("vq_cfg"))
    if vq_cfg and os.path.exists(vq_cfg):
        with open(vq_cfg) as f:
            vq = yaml.safe_load(f)
        mp = vq.get("model", {}).get("params", {})
        dd = dict(mp.get("ddconfig", {}))
        vc = VQVAEConfig(
            embed_dim=int(mp.get("embed_dim", 3)),
            n_embed=int(mp.get("n_embed", 8192)))
        for k, v in dd.items():
            if hasattr(vc, k):
                setattr(vc, k, _tuple(v))
        sbc.vqvae = vc
    cfg.shape_branch = sbc
    return cfg


def tiny_config(network_type: str = "echoscene") -> EchoSceneConfig:
    """Structurally complete model at test/smoke widths (canonical helper
    shared by the test suite and hermetic drives)."""
    return EchoSceneConfig(
        network_type=network_type,
        embedding_dim=8,
        gconv_num_layers=2,
        diffusion_bs=12,
        # tests pin f32: parity/equivalence tolerances are f32-calibrated
        # (production default is bfloat16 mixed precision)
        compute_dtype="float32",
        max_nodes=24, max_triples=64, batch_scenes=3,
        layout_denoiser=LayoutDenoiserConfig(
            model_channels=16, channel_mult=(1, 1), num_res_blocks=1,
            attention_resolutions=(2,), num_heads=4, concat_dim=32,
            crossattn_dim=32, use_checkpoint=False),
        layout_diffusion=LayoutDiffusionConfig(time_num=12),
        shape_branch=ShapeBranchConfig(
            ddim_steps=4,
            denoiser=ShapeDenoiserConfig(
                image_size=4, model_channels=8, num_res_blocks=1,
                attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2,
                context_dim=32, timesteps=12, use_checkpoint=False),
            vqvae=VQVAEConfig(n_embed=16, ch=4, ch_mult=(1, 2, 4),
                              resolution=16)),
    )


def save_config(cfg: EchoSceneConfig, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f)
