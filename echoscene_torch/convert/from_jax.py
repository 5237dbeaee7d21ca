"""Weight bridge: JAX `{"params", "batch_stats"}` trees -> the port's weights.

The inverse of echoscene_tpu/convert/torch_import.py, written without
importing it: each `convert_*` here mirrors the function of the same name
there and returns the reference torch state_dict layout (numpy arrays under
the reference's key names), which the port's modules use as their own.

Conventions (the inverse of torch_import's):
  * flax Dense kernel (in, out) -> torch Linear weight (out, in),
  * flax Conv kernel (*k, in, out) -> torch ConvNd weight (out, in, *k),
  * MaskedBatchNorm {scale, bias} + batch_stats {mean, var} ->
    BatchNorm1d {weight, bias, running_mean, running_var,
    num_batches_tracked},
  * GroupNorm / LayerNorm {scale, bias} -> {weight, bias},
  * Embed embedding -> Embedding weight.

Inputs are nested dicts of numpy arrays (`jax.device_get` of the variables).
`to_state_dict` turns an output into torch tensors for `load_state_dict`.
`module_to_checkpoint` is the inverse of `checkpoint_to_module`, and
`adam_state_from_jax` carries optax's Adam moments (param-shaped trees)
through the same key mapping into `torch.optim.AdamW` state.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

StateDict = Dict[str, np.ndarray]


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def linear(p: Mapping, prefix: str) -> StateDict:
    out = {f"{prefix}.weight": _f32(p["kernel"]).T.copy()}
    if "bias" in p:
        out[f"{prefix}.bias"] = _f32(p["bias"])
    return out


def conv(p: Mapping, prefix: str) -> StateDict:
    w = _f32(p["kernel"])                   # (*k, in, out)
    k = w.ndim - 2
    out = {f"{prefix}.weight": np.ascontiguousarray(
        np.transpose(w, (k + 1, k) + tuple(range(k))))}
    if "bias" in p:
        out[f"{prefix}.bias"] = _f32(p["bias"])
    return out


def pointwise_conv(p: Mapping, prefix: str, dims: int) -> StateDict:
    """A Dense applied to channel-last tokens -> the reference's 1x1 conv."""
    w = _f32(p["kernel"]).T                 # (out, in)
    return {f"{prefix}.weight": np.ascontiguousarray(
        w.reshape(w.shape + (1,) * dims)), f"{prefix}.bias": _f32(p["bias"])}


def embedding(p: Mapping, prefix: str) -> StateDict:
    return {f"{prefix}.weight": _f32(p["embedding"])}


def groupnorm(p: Mapping, prefix: str) -> StateDict:
    return {f"{prefix}.weight": _f32(p["scale"]),
            f"{prefix}.bias": _f32(p["bias"])}


layernorm = groupnorm


def batchnorm(p: Mapping, s: Mapping, prefix: str) -> StateDict:
    return {f"{prefix}.weight": _f32(p["scale"]),
            f"{prefix}.bias": _f32(p["bias"]),
            f"{prefix}.running_mean": _f32(s["mean"]),
            f"{prefix}.running_var": _f32(s["var"]),
            f"{prefix}.num_batches_tracked": np.asarray(0, np.int64)}


# --- MLP / GCN ---------------------------------------------------------------
def convert_mlp(p: Mapping, s: Optional[Mapping], prefix: str, n_layers: int,
                batch_norm: bool, final_nonlinearity: bool = True) -> StateDict:
    sd: StateDict = {}
    idx = 0
    for i in range(n_layers):
        sd.update(linear(p[f"Dense_{i}"], f"{prefix}.{idx}"))
        idx += 1
        if i < n_layers - 1 or final_nonlinearity:
            if batch_norm:
                sd.update(batchnorm(p[f"MaskedBatchNorm_{i}"],
                                    s[f"MaskedBatchNorm_{i}"], f"{prefix}.{idx}"))
                idx += 1
            idx += 1  # activation
    return sd


def convert_gconv(p: Mapping, s: Optional[Mapping], prefix: str,
                  batch_norm: bool, residual: bool) -> StateDict:
    s = s or {}
    sd = convert_mlp(p["net1"], s.get("net1"), f"{prefix}.net1", 2, batch_norm)
    sd.update(convert_mlp(p["net2"], s.get("net2"), f"{prefix}.net2", 2,
                          batch_norm))
    if residual:
        sd.update(linear(p["proj_obj"], f"{prefix}.linear_projection"))
        sd.update(linear(p["proj_pred"], f"{prefix}.linear_projection_pred"))
    if "WeightNetGCN_0" in p:
        w = p["WeightNetGCN_0"]
        wp = f"{prefix}.weight_net"
        for name in ("down_sample_obj", "down_sample_obj_o", "down_sample_pred"):
            sd.update(linear(w[name], f"{wp}.{name}"))
        for head in ("net_s", "net_o"):
            sd.update(linear(w[f"{head}_fc1"], f"{wp}.{head}.0"))
            sd.update(linear(w[f"{head}_fc2"], f"{wp}.{head}.2"))
    return sd


def convert_gconv_net(p: Mapping, s: Optional[Mapping], prefix: str,
                      num_layers: int, batch_norm: bool,
                      residual: bool) -> StateDict:
    s = s or {}
    sd: StateDict = {}
    for i in range(num_layers):
        sd.update(convert_gconv(p[f"gconv_{i}"], s.get(f"gconv_{i}"),
                                _join(prefix, f"gconvs.{i}"), batch_norm,
                                residual))
    return sd


# --- attention stack -------------------------------------------------------
def convert_transformer_block(p: Mapping, prefix: str) -> StateDict:
    sd: StateDict = {}
    for norm in ("norm1", "norm2", "norm3"):
        sd.update(layernorm(p[norm], f"{prefix}.{norm}"))
    for attn in ("attn1", "attn2"):
        for proj in ("to_q", "to_k", "to_v"):
            sd.update(linear(p[attn][proj], f"{prefix}.{attn}.{proj}"))
        sd.update(linear(p[attn]["to_out"], f"{prefix}.{attn}.to_out.0"))
    sd.update(linear(p["ff"]["GEGLU_0"]["Dense_0"], f"{prefix}.ff.net.0.proj"))
    sd.update(linear(p["ff"]["Dense_0"], f"{prefix}.ff.net.2"))
    return sd


def convert_spatial_transformer(p: Mapping, prefix: str, depth: int = 1,
                                dims: int = 3) -> StateDict:
    sd = {f"{prefix}.norm.weight": _f32(p["norm_scale"]),
          f"{prefix}.norm.bias": _f32(p["norm_bias"])}
    sd.update(pointwise_conv(p["proj_in"], f"{prefix}.proj_in", dims))
    for i in range(depth):
        sd.update(convert_transformer_block(
            p[f"block_{i}"], f"{prefix}.transformer_blocks.{i}"))
    sd.update(pointwise_conv(p["proj_out"], f"{prefix}.proj_out", dims))
    return sd


# --- UNet torso ----------------------------------------------------------
def convert_resblock(p: Mapping, prefix: str) -> StateDict:
    sd = groupnorm(p["GroupNorm32_0"], f"{prefix}.in_layers.0")
    sd.update(conv(p["Conv_0"], f"{prefix}.in_layers.2"))
    sd.update(linear(p["Dense_0"], f"{prefix}.emb_layers.1"))
    sd.update(groupnorm(p["GroupNorm32_1"], f"{prefix}.out_layers.0"))
    sd.update(conv(p["Conv_1"], f"{prefix}.out_layers.3"))
    if "Conv_2" in p:
        sd.update(conv(p["Conv_2"], f"{prefix}.skip_connection"))
    return sd


def convert_unet_torso(p: Mapping, prefix_in: str, prefix_mid: str,
                       prefix_out: str, prefix_head: str,
                       channel_mult: Sequence[int], num_res_blocks: int,
                       attention_resolutions: Sequence[int],
                       transformer_depth: int = 1, dims: int = 3) -> StateDict:
    """Walk the reference UNet builder order, mapping our names to torch
    module indices (torch_import.convert_unet_torso in reverse)."""
    sd = conv(p["conv_in"], f"{prefix_in}.0.0")
    t_idx, ds = 1, 1
    for level, _ in enumerate(channel_mult):
        for i in range(num_res_blocks):
            sd.update(convert_resblock(p[f"in_{level}_{i}_res"],
                                       f"{prefix_in}.{t_idx}.0"))
            if ds in attention_resolutions:
                sd.update(convert_spatial_transformer(
                    p[f"in_{level}_{i}_attn"], f"{prefix_in}.{t_idx}.1",
                    transformer_depth, dims))
            t_idx += 1
        if level != len(channel_mult) - 1:
            sd.update(conv(p[f"down_{level}"]["Conv_0"],
                           f"{prefix_in}.{t_idx}.0.op"))
            t_idx += 1
            ds *= 2
    sd.update(convert_resblock(p["mid_res1"], f"{prefix_mid}.0"))
    sd.update(convert_spatial_transformer(p["mid_attn"], f"{prefix_mid}.1",
                                          transformer_depth, dims))
    sd.update(convert_resblock(p["mid_res2"], f"{prefix_mid}.2"))
    t_idx = 0
    for level, _ in reversed(list(enumerate(channel_mult))):
        for i in range(num_res_blocks + 1):
            sd.update(convert_resblock(p[f"out_{level}_{i}_res"],
                                       f"{prefix_out}.{t_idx}.0"))
            li = 1
            if ds in attention_resolutions:
                sd.update(convert_spatial_transformer(
                    p[f"out_{level}_{i}_attn"], f"{prefix_out}.{t_idx}.{li}",
                    transformer_depth, dims))
                li += 1
            if level and i == num_res_blocks:
                sd.update(conv(p[f"up_{level}"]["Conv_0"],
                               f"{prefix_out}.{t_idx}.{li}.conv"))
                ds //= 2
            t_idx += 1
    sd.update(groupnorm(p["out_norm"], f"{prefix_head}.0"))
    sd.update(conv(p["conv_out"], f"{prefix_head}.2"))
    return sd


def _prefixed(sd: StateDict, prefix: str) -> StateDict:
    pfx = (prefix + ".") if prefix else ""
    return {pfx + k: v for k, v in sd.items()}


def convert_layout_denoiser(p: Mapping, s: Optional[Mapping], prefix: str = "",
                            *, channel_mult=(1, 1, 1, 1), num_res_blocks=2,
                            attention_resolutions=(4, 2), gconv_num_layers=5,
                            enable_t_emb=True, transformer_depth=1
                            ) -> StateDict:
    s = s or {}
    sd = convert_unet_torso(p["torso"], "input_blocks", "middle_block",
                            "output_blocks", "out", channel_mult,
                            num_res_blocks, attention_resolutions,
                            transformer_depth, dims=1)
    sd.update(linear(p["time_mlp1"], "time_embed.0"))
    sd.update(linear(p["time_mlp2"], "time_embed.2"))
    sd.update(embedding(p["pred_embeddings"], "pred_embeddings"))
    sd.update(linear(p["box_embeddings"], "box_embeddings"))
    if enable_t_emb:
        sd.update(linear(p["box_time_emb"], "box_time_emb"))
    sd.update(convert_gconv_net(p["box_graph_conv"], s.get("box_graph_conv"),
                                "box_graph_cov", gconv_num_layers,
                                batch_norm=True, residual=True))
    return _prefixed(sd, prefix)


def convert_shape_denoiser(p: Mapping, s: Optional[Mapping], prefix: str = "",
                           *, channel_mult=(1, 2, 3), num_res_blocks=2,
                           attention_resolutions=(4, 2), gconv_num_layers=5,
                           enable_t_emb=True, message_passing=True,
                           transformer_depth=1) -> StateDict:
    s = s or {}
    sd = convert_unet_torso(p["torso"], "input_blocks", "middle_block",
                            "output_blocks", "out", channel_mult,
                            num_res_blocks, attention_resolutions,
                            transformer_depth, dims=3)
    sd.update(linear(p["time_mlp1"], "time_embed.0"))
    sd.update(linear(p["time_mlp2"], "time_embed.2"))
    if message_passing:
        sd.update(embedding(p["pred_embeddings"], "pred_embeddings"))
        sd.update(conv(p["shape_conv1"], "shape_embeddings.0"))
        sd.update(conv(p["shape_conv2"], "shape_embeddings.2"))
        sd.update(linear(p["shape_dense"], "shape_embeddings.5"))
        if enable_t_emb:
            sd.update(linear(p["shape_time_emb"], "shape_time_emb"))
        sd.update(convert_gconv_net(
            p["shape_graph_conv"], s.get("shape_graph_conv"),
            "shape_code_graph_cov", gconv_num_layers, batch_norm=True,
            residual=True))
    return _prefixed(sd, prefix)


# --- VQ-VAE --------------------------------------------------------------
def _convert_vq_resblock(p: Mapping, prefix: str) -> StateDict:
    sd = groupnorm(p["_VQGroupNorm_0"], f"{prefix}.norm1")
    sd.update(conv(p["Conv_0"], f"{prefix}.conv1"))
    sd.update(groupnorm(p["_VQGroupNorm_1"], f"{prefix}.norm2"))
    sd.update(conv(p["Conv_1"], f"{prefix}.conv2"))
    if "Conv_2" in p:
        sd.update(conv(p["Conv_2"], f"{prefix}.nin_shortcut"))
    return sd


def _convert_vq_attn(p: Mapping, prefix: str) -> StateDict:
    sd = groupnorm(p["_VQGroupNorm_0"], f"{prefix}.norm")
    for name in ("q", "k", "v", "proj_out"):
        sd.update(conv(p[name], f"{prefix}.{name}"))
    return sd


def convert_vqvae(p: Mapping, prefix: str = "", *, ch_mult=(1, 2, 4),
                  num_res_blocks=1) -> StateDict:
    """Also maps per-level attention blocks (`attn_resolutions`, empty in
    every shipped config), which torch_import does not."""
    enc, dec = p["encoder"], p["decoder"]
    sd = conv(enc["conv_in"], "encoder.conv_in")
    for l in range(len(ch_mult)):
        for i in range(num_res_blocks):
            sd.update(_convert_vq_resblock(enc[f"down_{l}_block_{i}"],
                                           f"encoder.down.{l}.block.{i}"))
            if f"down_{l}_attn_{i}" in enc:
                sd.update(_convert_vq_attn(enc[f"down_{l}_attn_{i}"],
                                           f"encoder.down.{l}.attn.{i}"))
        if l != len(ch_mult) - 1:
            sd.update(conv(enc[f"down_{l}_downsample"]["Conv_0"],
                           f"encoder.down.{l}.downsample.conv"))
    for side, tree in (("encoder", enc), ("decoder", dec)):
        sd.update(_convert_vq_resblock(tree["mid_block_1"],
                                       f"{side}.mid.block_1"))
        sd.update(_convert_vq_attn(tree["mid_attn_1"], f"{side}.mid.attn_1"))
        sd.update(_convert_vq_resblock(tree["mid_block_2"],
                                       f"{side}.mid.block_2"))
        sd.update(groupnorm(tree["_VQGroupNorm_0"], f"{side}.norm_out"))
        sd.update(conv(tree["conv_out"], f"{side}.conv_out"))
    sd.update(conv(dec["conv_in"], "decoder.conv_in"))
    for l in reversed(range(len(ch_mult))):
        for i in range(num_res_blocks):
            sd.update(_convert_vq_resblock(dec[f"up_{l}_block_{i}"],
                                           f"decoder.up.{l}.block.{i}"))
            if f"up_{l}_attn_{i}" in dec:
                sd.update(_convert_vq_attn(dec[f"up_{l}_attn_{i}"],
                                           f"decoder.up.{l}.attn.{i}"))
        if l != 0:
            sd.update(conv(dec[f"up_{l}_upsample"]["Conv_0"],
                           f"decoder.up.{l}.upsample.conv"))
    sd["quantize.embedding.weight"] = _f32(p["quantize"]["embedding"])
    sd.update(conv(p["quant_conv"], "quant_conv"))
    sd.update(conv(p["post_quant_conv"], "post_quant_conv"))
    return _prefixed(sd, prefix)


# --- full checkpoint --------------------------------------------------------
LAYOUT_PREFIX = "LayoutDiff.df.model"
SHAPE_PREFIX = "diffusion_net"


def convert_echoscene_checkpoint(params: Mapping, stats: Optional[Mapping],
                                 cfg) -> Dict[str, object]:
    """EchoSceneModule variables -> a reference `model<epoch>.pth` dict:
    top-level GCN / layout keys plus the nested 'shape_df' and 'vqvae'
    state dicts (EchoScene.state_dict :534-543)."""
    stats = stats or {}
    bn = cfg.mlp_normalization == "batch"
    sd: Dict[str, object] = {}
    sd.update(embedding(params["obj_embeddings_ec"], "obj_embeddings_ec"))
    sd.update(embedding(params["pred_embeddings_ec"], "pred_embeddings_ec"))
    for name, nl in (("gconv_net_ec", cfg.gconv_num_layers),
                     ("gconv_net_manipulation", min(cfg.gconv_num_layers, 5))):
        sd.update(convert_gconv_net(params[name], stats.get(name), name, nl,
                                    batch_norm=bn, residual=cfg.residual))
    ld = cfg.layout_denoiser
    sd.update(convert_layout_denoiser(
        params["layout_denoiser"], stats.get("layout_denoiser"), LAYOUT_PREFIX,
        channel_mult=tuple(ld.channel_mult), num_res_blocks=ld.num_res_blocks,
        attention_resolutions=tuple(ld.attention_resolutions),
        gconv_num_layers=ld.gconv_num_layers, enable_t_emb=ld.enable_t_emb,
        transformer_depth=ld.transformer_depth))
    if "rel_s_mlp" in params:
        sd.update(convert_mlp(params["rel_s_mlp"], stats.get("rel_s_mlp"),
                              "rel_s_mlp", 2, bn, final_nonlinearity=False))
    if "shape_denoiser" in params:
        sdn = cfg.shape_branch.denoiser
        sd["shape_df"] = convert_shape_denoiser(
            params["shape_denoiser"], stats.get("shape_denoiser"),
            SHAPE_PREFIX, channel_mult=tuple(sdn.channel_mult),
            num_res_blocks=sdn.num_res_blocks,
            attention_resolutions=tuple(sdn.attention_resolutions),
            gconv_num_layers=sdn.gconv_num_layers,
            enable_t_emb=sdn.enable_t_emb,
            message_passing=sdn.message_passing,
            transformer_depth=sdn.transformer_depth)
    if "vqvae" in params:
        vqc = cfg.shape_branch.vqvae
        sd["vqvae"] = convert_vqvae(params["vqvae"],
                                    ch_mult=tuple(vqc.ch_mult),
                                    num_res_blocks=vqc.num_res_blocks)
    return sd


def checkpoint_to_module(ckpt: Mapping[str, object]) -> StateDict:
    """A reference checkpoint dict -> the flat key space of the port's
    EchoSceneModule (layout_denoiser.*, shape_denoiser.*, vqvae.*)."""
    out: StateDict = {}
    for key, value in ckpt.items():
        if key == "shape_df":
            out.update({"shape_denoiser." + k[len(SHAPE_PREFIX) + 1:]: v
                        for k, v in value.items()})
        elif key == "vqvae":
            out.update({"vqvae." + k: v for k, v in value.items()})
        elif key.startswith(LAYOUT_PREFIX + "."):
            out["layout_denoiser." + key[len(LAYOUT_PREFIX) + 1:]] = value
        elif key not in ("epoch", "counter", "opt"):
            out[key] = value
    return out


def module_to_checkpoint(sd: Mapping[str, object]) -> Dict[str, object]:
    """The port's EchoSceneModule state_dict -> the reference checkpoint
    layout (the inverse of `checkpoint_to_module`)."""
    out: Dict[str, object] = {}
    for key, value in sd.items():
        head, _, rest = key.partition(".")
        if head == "shape_denoiser":
            out.setdefault("shape_df", {})[f"{SHAPE_PREFIX}.{rest}"] = value
        elif head == "vqvae":
            out.setdefault("vqvae", {})[rest] = value
        elif head == "layout_denoiser":
            out[f"{LAYOUT_PREFIX}.{rest}"] = value
        else:
            out[key] = value
    return out


def adam_state_from_jax(mu: Mapping, nu: Mapping, count: int,
                        stats: Mapping, cfg,
                        param_names: Sequence[str]) -> Dict[str, Dict]:
    """optax ScaleByAdamState (mu, nu: param-shaped trees of numpy arrays,
    the frozen `vqvae` subtree left out; count: its step count) -> per
    parameter `torch.optim.AdamW` state {"step", "exp_avg", "exp_avg_sq"}
    for each name of `param_names`.  mu and nu go through the key mapping
    of `convert_echoscene_checkpoint` (`stats`, the batch statistics, only
    fill the batch-norm entries that are dropped here)."""
    maps = [checkpoint_to_module(convert_echoscene_checkpoint(t, stats, cfg))
            for t in (mu, nu)]
    return {name: {"step": torch.tensor(float(count)),
                   "exp_avg": torch.from_numpy(np.array(maps[0][name])),
                   "exp_avg_sq": torch.from_numpy(np.array(maps[1][name]))}
            for name in param_names}


def load_adam_state(optimizer: torch.optim.Optimizer,
                    named_params: Sequence, state: Mapping[str, Dict]) -> None:
    """Install `adam_state_from_jax`'s output into an AdamW over
    `named_params` ((name, parameter) pairs, the optimizer's order)."""
    for name, p in named_params:
        optimizer.state[p] = {k: v.to(p.device) if k != "step" else v
                              for k, v in state[name].items()}


def to_state_dict(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
