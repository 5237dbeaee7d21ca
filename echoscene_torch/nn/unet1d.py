"""Layout denoiser: per-object conditioned UNet over the 8-d box vector, with
the echo scene-graph message-passing pass.

Port of echoscene_tpu/nn/unet1d.py (reference diffusion_layout/
denoise_net.py:451-806, UNet1DModel).  The box vector is one length-1 token;
every forward first runs the echo GCN (box_messsage_passing, :758-771) on
[object embedding, embedded box, projected time embedding], whose per-object
relation latent replaces the cross-attention context (crossattn) or is
appended to the token's channels (concat).  Torso keys sit at the top level
of the state_dict, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .blocks import timestep_embedding
from .gcn import GraphTripleConvNet
from .layers import Linear
from .unet_core import UNetTorso


class LayoutDenoiser(UNetTorso):
    def __init__(self, in_channels: int = 8, model_channels: int = 512,
                 out_channels: int = 8, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2),
                 channel_mult: Sequence[int] = (1, 1, 1, 1),
                 num_heads: int = 8, transformer_depth: int = 1,
                 conditioning_key: str = "crossattn", concat_dim: int = 1280,
                 crossattn_dim: int = 1280, enable_t_emb: bool = True,
                 gconv_dim: int = 64, gconv_num_layers: int = 5,
                 num_preds: int = 16, obj_dim: int = 640,
                 use_checkpoint: bool = False):
        if conditioning_key not in ("crossattn", "concat"):
            raise NotImplementedError(conditioning_key)
        crossattn = conditioning_key == "crossattn"
        super().__init__(
            in_channels + (0 if crossattn else concat_dim), model_channels,
            out_channels, num_res_blocks, attention_resolutions, channel_mult,
            num_heads, dims=1, transformer_depth=transformer_depth,
            context_dim=crossattn_dim if crossattn else None,
            use_checkpoint=use_checkpoint)
        self.conditioning_key = conditioning_key
        self.model_channels = model_channels
        self.enable_t_emb = enable_t_emb
        emb_dim = model_channels * 4
        self.time_embed = nn.Sequential(Linear(model_channels, emb_dim),
                                        nn.SiLU(), Linear(emb_dim, emb_dim))
        self.pred_embeddings = nn.Embedding(num_preds, gconv_dim * 2)
        self.box_embeddings = Linear(in_channels, gconv_dim)
        gcn_in = obj_dim + gconv_dim
        if enable_t_emb:
            self.box_time_emb = Linear(emb_dim, gconv_dim)
            gcn_in += gconv_dim
        self.box_graph_cov = GraphTripleConvNet(
            gcn_in, gconv_dim * 2, num_layers=gconv_num_layers,
            hidden_dim=gconv_dim * 4, pooling="avg", mlp_normalization="batch",
            residual=True, output_dim=crossattn_dim if crossattn else concat_dim)

    def echo_message_passing(self, obj_embed, triples, box_t, emb, obj_mask,
                             triple_mask):
        parts = [obj_embed, self.box_embeddings(box_t)]
        if self.enable_t_emb:
            parts.append(self.box_time_emb(emb))
        dtype = self.box_embeddings.weight.dtype
        obj_box = torch.cat([p.to(dtype) for p in parts], dim=1)
        # the (subject, object) columns as a view: a list index would copy
        # it from the host and synchronise, which a CUDA graph cannot hold
        latent, _ = self.box_graph_cov(
            obj_box, self.pred_embeddings(triples[:, 1]), triples[:, ::2],
            obj_mask, triple_mask)
        return latent

    def forward(self, box_t: torch.Tensor, obj_embed: torch.Tensor,
                triples: torch.Tensor, t: torch.Tensor,
                obj_mask: Optional[torch.Tensor] = None,
                triple_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """box_t (N, 8); obj_embed (N, D); triples (T, 3); t (N,) ->
        eps (N, out_channels)."""
        emb = self.time_embed(timestep_embedding(t, self.model_channels))
        latent = self.echo_message_passing(obj_embed, triples, box_t, emb,
                                           obj_mask, triple_mask)
        if self.conditioning_key == "crossattn":
            h, ctx = box_t, latent[:, None, :]
        else:
            h, ctx = torch.cat([box_t.to(latent.dtype), latent], dim=-1), None
        return super().forward(h[:, :, None], emb, ctx)[:, :, 0]
