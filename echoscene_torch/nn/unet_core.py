"""OpenAI-UNet torso (input / middle / output blocks with skip concat).

Port of echoscene_tpu/nn/unet_core.py (reference denoise_net.py:451-714 and
openai_model_3d.py:452-742).  One torso serves the 1D layout denoiser (a
single length-1 token) and the 3D shape denoiser ((16, H, W) latents,
inner-two-dim resampling).  Channel-first; modules are laid out as the
reference's input_blocks / middle_block / output_blocks / out so the
state_dict keys are the reference's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .attention import SpatialTransformer
from .blocks import (GroupNorm32, ResBlock, Upsample, Downsample,
                     group_norm_act, zero_module)
from .layers import conv_nd, remat


class TimestepEmbedSequential(nn.Sequential):
    """Runs its children in order, passing the time embedding to ResBlocks
    and the context to SpatialTransformers; with `use_checkpoint` each
    ResBlock is rematerialised (JAX's `nn.remat(ResBlock)`)."""

    use_checkpoint = False

    def forward(self, x, emb, context=None):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = (remat(layer, x, emb) if self.use_checkpoint
                     else layer(x, emb))
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class UNetTorso(nn.Module):
    def __init__(self, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int],
                 channel_mult: Sequence[int], num_heads: int, dims: int,
                 transformer_depth: int = 1,
                 context_dim: Optional[int] = None,
                 use_checkpoint: bool = False,
                 factored_upsample: bool = False, winograd: bool = False):
        super().__init__()
        mc = model_channels
        emb_dim = mc * 4

        def res(ch_in, ch_out):
            return ResBlock(ch_in, emb_dim, ch_out, dims=dims,
                            winograd=winograd)

        def attn(ch):
            return SpatialTransformer(ch, num_heads, ch // num_heads,
                                      transformer_depth, context_dim, dims=dims,
                                      use_checkpoint=use_checkpoint)

        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(
            conv_nd(dims, in_channels, mc, 3, padding=1))])
        skip_chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                skip_chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(
                    TimestepEmbedSequential(Downsample(ch, dims)))
                skip_chans.append(ch)
                ds *= 2

        self.middle_block = TimestepEmbedSequential(res(ch, ch), attn(ch),
                                                    res(ch, ch))

        self.output_blocks = nn.ModuleList([])
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [res(ch + skip_chans.pop(), mc * mult)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch, dims, factored_upsample,
                                           winograd))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))

        self.out = nn.Sequential(
            GroupNorm32(ch), nn.SiLU(),
            zero_module(conv_nd(dims, mc, out_channels, 3, padding=1)))
        for seq in self.modules():
            if isinstance(seq, TimestepEmbedSequential):
                seq.use_checkpoint = use_checkpoint

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        hs = []
        h = x
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out[2](group_norm_act(h, self.out[0], self.out[1]))
