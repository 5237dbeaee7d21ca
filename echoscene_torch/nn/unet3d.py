"""Shape denoiser: 3D UNet over (16, 16, 16, 3) VQ-VAE latents with the echo
scene-graph message-passing pass.

Port of echoscene_tpu/nn/unet3d.py (reference diffusion_shape/
openai_model_3d.py:452-863, UNet3DModel).  The echo pass embeds the noisy
latent (conv 3->32, max-pool /2, conv ->64, max-pool k2 s4, flatten, linear
->64), concatenates it with the per-object conditioning embedding and the
projected time embedding, and message-passes it through a 5-layer
batch-norm triplet GCN; the result replaces the cross-attention context
(crossattn) or is appended as one extra latent channel (concat).

Public layout is JAX's: latents are channel-last (M, D, H, W, C); the torso
runs channel-first inside.  The pooled embedding is flattened channel-last,
as the JAX module does, so weights bridged from JAX give the same function.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from .blocks import GroupNorm32, act_mode, timestep_embedding
from .gcn import GraphTripleConvNet
from .layers import Conv3d, Linear
from .unet_core import UNetTorso


class _FlattenChannelLast(nn.Module):
    def forward(self, x):
        return x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)


class ShapeDenoiser(UNetTorso):
    def __init__(self, image_size: int = 16, in_channels: int = 3,
                 model_channels: int = 224, out_channels: int = 3,
                 num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2),
                 channel_mult: Sequence[int] = (1, 2, 3), num_heads: int = 8,
                 transformer_depth: int = 1, context_dim: int = 1280,
                 conditioning_key: str = "crossattn",
                 message_passing: bool = True, enable_t_emb: bool = True,
                 gconv_dim: int = 64, gconv_num_layers: int = 5,
                 num_preds: int = 16, obj_dim: Optional[int] = None,
                 use_checkpoint: bool = False,
                 factored_upsample: bool = False, winograd: bool = False):
        if conditioning_key == "concat":
            x_dim, torso_in, torso_ctx = image_size ** 3, in_channels + 2, None
        elif conditioning_key == "crossattn":
            x_dim, torso_in, torso_ctx = context_dim, in_channels, context_dim
        else:
            x_dim, torso_in, torso_ctx = context_dim, in_channels, None
        super().__init__(torso_in, model_channels, out_channels,
                         num_res_blocks, attention_resolutions, channel_mult,
                         num_heads, dims=3, transformer_depth=transformer_depth,
                         context_dim=torso_ctx, use_checkpoint=use_checkpoint,
                         factored_upsample=factored_upsample,
                         winograd=winograd)
        self.image_size = image_size
        self.model_channels = model_channels
        self.conditioning_key = conditioning_key
        self.message_passing = message_passing
        self.enable_t_emb = enable_t_emb
        emb_dim = model_channels * 4
        self.time_embed = nn.Sequential(Linear(model_channels, emb_dim),
                                        nn.SiLU(), Linear(emb_dim, emb_dim))
        if message_passing:
            pooled = ((image_size // 2 - 2) // 4 + 1) ** 3
            self.pred_embeddings = nn.Embedding(num_preds, gconv_dim * 2)
            self.shape_embeddings = nn.Sequential(
                Conv3d(in_channels, 32, 3, padding=1), nn.MaxPool3d(2, 2),
                Conv3d(32, 64, 3, padding=1), nn.MaxPool3d(2, 4),
                _FlattenChannelLast(), Linear(64 * pooled, gconv_dim))
            gcn_in = (obj_dim or context_dim) + gconv_dim
            if enable_t_emb:
                self.shape_time_emb = Linear(emb_dim, gconv_dim)
                gcn_in += gconv_dim
            self.shape_code_graph_cov = GraphTripleConvNet(
                gcn_in, gconv_dim * 2, num_layers=gconv_num_layers,
                hidden_dim=gconv_dim * 4, pooling="avg",
                mlp_normalization="batch", residual=True, output_dim=x_dim)

    def echo_message_passing(self, obj_embed, triples, x_cf, emb, obj_mask,
                             triple_mask):
        code = self.shape_embeddings(x_cf)
        if obj_embed.dim() == 3:
            obj_embed = obj_embed[:, 0, :]
        parts = [obj_embed, code]
        if self.enable_t_emb:
            parts.append(self.shape_time_emb(emb))
        dtype = code.dtype
        latent, _ = self.shape_code_graph_cov(
            torch.cat([p.to(dtype) for p in parts], dim=1),
            self.pred_embeddings(triples[:, 1]), triples[:, [0, 2]], obj_mask,
            triple_mask)
        return latent

    def forward(self, x: torch.Tensor, obj_embed: torch.Tensor,
                triples: torch.Tensor, t: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                obj_mask: Optional[torch.Tensor] = None,
                triple_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (M, 16, 16, 16, C) channel-last; obj_embed (M, [1,] D);
        t (M,) -> eps (M, 16, 16, 16, out_channels)."""
        emb = self.time_embed(timestep_embedding(t, self.model_channels))
        x_cf = x.permute(0, 4, 1, 2, 3)
        ctx = context
        if self.message_passing:
            latent = self.echo_message_passing(obj_embed, triples, x_cf, emb,
                                               obj_mask, triple_mask)
            if self.conditioning_key == "concat":
                s = self.image_size
                # the promoted dtype, as jnp.concatenate: the int8 twin's
                # conv_in quantizes the f32 concatenation
                dt = torch.promote_types(x_cf.dtype, latent.dtype)
                x_cf = torch.cat([x_cf.to(dt),
                                  latent.to(dt).reshape(-1, 1, s, s, s)],
                                 dim=1)
                ctx = None
            elif self.conditioning_key == "crossattn":
                ctx = latent[:, None, :]
        # the torso runs channel-first in memory too: the permuted view's
        # channels-last strides would otherwise carry through cuDNN into
        # every activation up to the first upsample, and the fused norm
        # (`blocks.group_norm_act`) reads contiguous (row, group) slabs
        x_cf = x_cf.contiguous()
        out = super().forward(x_cf, emb, ctx)
        return out.permute(0, 2, 3, 4, 1)


# a norm's name in `torso_norm_sites` by the end of its module's path
_NORM_KINDS = {"in_layers.0": "ResBlock in", "out_layers.0": "ResBlock out",
               "norm": "SpatialTransformer", "out.0": "out"}


def torso_norm_sites(cfg, rows: int) -> List[Dict]:
    """The GroupNorms of the torso of one call of a ShapeDenoiser of `cfg`
    (a `ShapeDenoiserConfig`) at `rows` rows, as the model calls them: in
    call order, merged by their arguments into dicts of `name` (kind and
    channels), `x_shape`, `groups`, `eps`, `shift` (the norm adds the time
    embedding), `act` (the activation after it in the bf16 model: "silu"
    or "none"; the int8 twin computes RoundedSiLU where this reads "silu")
    and `calls`.  The torso runs once on the meta device with hooks on its
    norms and activations, so nothing is computed or allocated."""
    with torch.device("meta"):
        model = ShapeDenoiser(
            image_size=cfg.image_size, in_channels=cfg.in_channels,
            model_channels=cfg.model_channels,
            out_channels=cfg.out_channels,
            num_res_blocks=cfg.num_res_blocks,
            attention_resolutions=tuple(cfg.attention_resolutions),
            channel_mult=tuple(cfg.channel_mult), num_heads=cfg.num_heads,
            transformer_depth=cfg.transformer_depth,
            context_dim=cfg.context_dim,
            conditioning_key=cfg.conditioning_key, message_passing=False)
    calls: List[Dict] = []

    def on_norm(name):
        parts = name.split(".")
        kind = _NORM_KINDS[".".join(parts[-2:]) if parts[-1] == "0"
                           else parts[-1]]

        def hook(module, args, kwargs, out):
            x = args[0]
            calls.append(dict(name=f"{kind} {x.shape[1]}",
                              x_shape=tuple(x.shape), groups=module.num_groups,
                              eps=module.eps,
                              shift=kwargs.get("shift") is not None,
                              act="none", out=out))
        return hook

    def on_act(module, args, out):
        if calls and args[0] is calls[-1]["out"]:
            calls[-1]["act"] = act_mode(module)

    for name, module in model.named_modules():
        if isinstance(module, GroupNorm32):
            module.register_forward_hook(on_norm(name), with_kwargs=True)
        elif act_mode(module) is not None:
            module.register_forward_hook(on_act)
    s = cfg.image_size
    meta = dict(device="meta")
    x = torch.zeros(rows, model.input_blocks[0][0].weight.shape[1], s, s, s,
                    **meta)
    ctx = (torch.zeros(rows, 1, cfg.context_dim, **meta)
           if cfg.conditioning_key == "crossattn" else None)
    with torch.no_grad():
        UNetTorso.forward(model, x, torch.zeros(
            rows, 4 * cfg.model_channels, **meta), ctx)
    sites: Dict[tuple, Dict] = {}
    for call in calls:
        del call["out"]
        key = tuple(v for k, v in call.items() if k != "name")
        sites.setdefault(key, dict(call, calls=0))["calls"] += 1
    return list(sites.values())
