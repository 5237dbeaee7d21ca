"""3D VQ-VAE over 64^3 SDF grids (taming-transformers family).

Port of echoscene_tpu/nn/vqvae.py (reference vqvae_networks/{network.py,
vqvae_modules.py, quantizer.py}): Encoder3D (64^3 -> 16^3 with ch_mult
(1, 2, 4)), Decoder3D (nearest-2x upsampling), the L2-nearest
VectorQuantizer with straight-through estimator, and the diffusion-facing
pre-quantisation API encode_no_quant / decode_no_quant, and the training
forward (reconstruction, codebook loss).  Modules are laid out
as the reference's (down.{l}.block.{i}, mid.attn_1, ...), so the state_dict
keys are the reference's.

Numerics kept from the JAX modules: GroupNorm uses the taming group rule
(C // 4 groups when C <= 32, 30 when C % 32 != 0, else 32; eps 1e-6) with
f32 statistics, the activation is the exact erf gelu, and Downsample3D pads
(0, 1) on every spatial dim before its stride-2 conv.  Public tensors are
channel-last (B, D, H, W, C), as in JAX; the networks run channel-first.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import dot_product_attention
from .blocks import factored_upsample_conv, group_norm
from .layers import Conv3d, pointwise


def vq_groups(c: int) -> int:
    if c <= 32:
        return c // 4
    if c % 32 != 0:
        return 30
    return 32


class VQGroupNorm(nn.GroupNorm):
    def __init__(self, channels: int):
        super().__init__(vq_groups(channels), channels, eps=1e-6)

    def forward(self, x):
        return group_norm(x, self.num_groups, self.eps, self.weight, self.bias)


def swish(x):
    return x * torch.sigmoid(x)


class ResnetBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = VQGroupNorm(in_channels)
        self.conv1 = Conv3d(in_channels, out_channels, 3, padding=1)
        self.norm2 = VQGroupNorm(out_channels)
        self.conv2 = Conv3d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = Conv3d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock3D(nn.Module):
    """Single-head self-attention over all voxels (vqvae_modules.py:126-178);
    the 1x1x1 convs are applied as linear maps on the tokens."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = VQGroupNorm(channels)
        self.q = Conv3d(channels, channels, 1)
        self.k = Conv3d(channels, channels, 1)
        self.v = Conv3d(channels, channels, 1)
        self.proj_out = Conv3d(channels, channels, 1)

    def forward(self, x):
        b, c = x.shape[:2]
        tokens = self.norm(x).reshape(b, c, -1).transpose(1, 2)
        q, k, v = (pointwise(conv, tokens).reshape(b, -1, 1, c)
                   for conv in (self.q, self.k, self.v))
        out = dot_product_attention(q, k, v).reshape(b, -1, c)
        out = pointwise(self.proj_out, out)
        return x + out.transpose(1, 2).reshape(x.shape)


class Downsample3D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1, 0, 1)))


class Upsample3D(nn.Module):
    """Nearest 2x in all three dims + conv (vqvae_modules.py:24-39);
    `factored` (the sampling twin only) computes the pair as 8 2-tap
    convolutions on the pre-upsample grid (`blocks.factored_upsample_conv`,
    3.375x fewer multiply-adds), on the same parameters."""

    def __init__(self, channels: int, factored: bool = False):
        super().__init__()
        self.factored = factored
        self.conv = Conv3d(channels, channels, 3, padding=1)

    def forward(self, x):
        if self.factored:
            return factored_upsample_conv(x, self.conv.weight, self.conv.bias,
                                          (0, 1, 2))
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Level(nn.Module):
    """One resolution level: .block (+ .attn) and .downsample / .upsample."""

    def __init__(self, blocks, attns):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)


class _Mid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = ResnetBlock3D(channels, channels)
        self.attn_1 = AttnBlock3D(channels)
        self.block_2 = ResnetBlock3D(channels, channels)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder3D(nn.Module):
    def __init__(self, ch: int = 64, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 1, attn_resolutions: Sequence[int] = (),
                 in_channels: int = 1, z_channels: int = 3,
                 resolution: int = 64):
        super().__init__()
        self.conv_in = Conv3d(in_channels, ch, 3, padding=1)
        self.down = nn.ModuleList()
        block_in, curr_res = ch, resolution
        for i_level, mult in enumerate(ch_mult):
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock3D(block_in, ch * mult))
                block_in = ch * mult
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock3D(block_in))
            level = _Level(blocks, attns)
            if i_level != len(ch_mult) - 1:
                level.downsample = Downsample3D(block_in)
                curr_res //= 2
            self.down.append(level)
        self.mid = _Mid(block_in)
        self.norm_out = VQGroupNorm(block_in)
        self.conv_out = Conv3d(block_in, z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for i, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.gelu(self.norm_out(h)))


class Decoder3D(nn.Module):
    def __init__(self, ch: int = 64, out_ch: int = 1,
                 ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks: int = 1,
                 attn_resolutions: Sequence[int] = (), z_channels: int = 3,
                 resolution: int = 64, factored_upsample: bool = False):
        super().__init__()
        num_levels = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (num_levels - 1)
        self.conv_in = Conv3d(z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        levels = {}
        for i_level in reversed(range(num_levels)):
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock3D(block_in, ch * ch_mult[i_level]))
                block_in = ch * ch_mult[i_level]
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock3D(block_in))
            level = _Level(blocks, attns)
            if i_level != 0:
                level.upsample = Upsample3D(block_in, factored_upsample)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList([levels[i] for i in range(num_levels)])
        self.norm_out = VQGroupNorm(block_in)
        self.conv_out = Conv3d(block_in, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for i, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.gelu(self.norm_out(h)))


class VectorQuantizer(nn.Module):
    """L2-nearest codebook with straight-through gradients
    (quantizer.py:10-119); non-legacy loss with beta on the commitment."""

    def __init__(self, n_embed: int = 8192, embed_dim: int = 3,
                 beta: float = 1.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.beta = beta
        self.embedding = nn.Embedding(n_embed, embed_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_embed, 1.0 / n_embed)

    def forward(self, z: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z (..., embed_dim) channel-last -> (z_q, loss, indices)."""
        book = self.embedding.weight.float()
        zf = z.float()
        flat = zf.reshape(-1, self.embed_dim)
        d = ((flat ** 2).sum(1, keepdim=True) + (book ** 2).sum(1)[None, :]
             - 2.0 * flat @ book.t())
        idx = torch.argmin(d, dim=1)
        z_q = book[idx].reshape(z.shape)
        # the loss in f32 whatever z's dtype, as JAX's (its codebook is f32)
        loss = (self.beta * torch.mean((z_q.detach() - zf) ** 2)
                + torch.mean((z_q - zf.detach()) ** 2))
        z_q = z + (z_q.to(z.dtype) - z).detach()
        return z_q, loss, idx.reshape(z.shape[:-1])


class VQVAE(nn.Module):
    """VQ-VAE with the reference's pre-quant diffusion API
    (network.py:51-141) and JAX's training forward (`forward`, `encode`,
    `decode`; echoscene_tpu/nn/vqvae.py:298-316).  It runs in the dtype of
    its parameters: a caller that trains in bf16 passes bf16 casts of the
    convolutions' f32 masters (`train/vqvae_trainer.py`), while the norms
    keep f32 statistics and the codebook's distances and loss are f32."""

    def __init__(self, n_embed: int = 8192, embed_dim: int = 3, ch: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks: int = 1,
                 attn_resolutions: Sequence[int] = (), in_channels: int = 1,
                 out_ch: int = 1, z_channels: int = 3, resolution: int = 64,
                 factored_upsample: bool = False):
        super().__init__()
        self.encoder = Encoder3D(ch, ch_mult, num_res_blocks, attn_resolutions,
                                 in_channels, z_channels, resolution)
        self.decoder = Decoder3D(ch, out_ch, ch_mult, num_res_blocks,
                                 attn_resolutions, z_channels, resolution,
                                 factored_upsample)
        self.quantize = VectorQuantizer(n_embed, embed_dim)
        self.quant_conv = Conv3d(z_channels, embed_dim, 1)
        self.post_quant_conv = Conv3d(embed_dim, z_channels, 1)

    def encode_no_quant(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 64, 64, 64, 1) -> pre-quant latent (B, 16, 16, 16, 3)."""
        h = self.quant_conv(self.encoder(x.permute(0, 4, 1, 2, 3)))
        return h.permute(0, 2, 3, 4, 1)

    def decode_no_quant(self, h: torch.Tensor,
                        force_not_quantize: bool = False) -> torch.Tensor:
        """(B, 16, 16, 16, 3) latent -> (B, 64, 64, 64, 1) SDF grid."""
        if not force_not_quantize:
            h, _, _ = self.quantize(h)
        return self.decode(h)

    def encode(self, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, 64, 64, 64, 1) -> (z_q, codebook loss, indices)."""
        return self.quantize(self.encode_no_quant(x))

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """Quantised latent (B, 16, 16, 16, 3) -> (B, 64, 64, 64, 1)."""
        dec = self.decoder(self.post_quant_conv(quant.permute(0, 4, 1, 2, 3)))
        return dec.permute(0, 2, 3, 4, 1)

    def forward(self, x: torch.Tensor, forward_no_quant: bool = False,
                encode_only: bool = False):
        """JAX's `VQVAE.__call__`: (reconstruction, codebook loss); with
        forward_no_quant, (decode_no_quant of the latent, the latent), or
        the latent alone with encode_only."""
        if forward_no_quant:
            z = self.encode_no_quant(x)
            if encode_only:
                return z
            return self.decode_no_quant(z), z
        quant, diff, _ = self.encode(x)
        return self.decode(quant), diff
