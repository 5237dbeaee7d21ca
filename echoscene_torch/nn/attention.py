"""LDM-style attention stack.

Port of echoscene_tpu/nn/attention.py (reference diffusion_shape/
attention.py:39-396): CrossAttention (scaled dot-product through
kernels.attention), BasicTransformerBlock (self-attn, cross-attn, GEGLU
feed-forward, all residual), SpatialTransformer (GroupNorm eps 1e-6, 1x1
conv in, token attention, zero-init 1x1 conv out, residual).  Names follow
the reference torch modules.

Numerics kept from the JAX modules: GEGLU uses the tanh-approximate gelu
(flax's default), LayerNorm eps is 1e-6 (flax's default), norms compute
their statistics in f32, and cross-attention to a one-token context is the
exact shortcut to_out(to_v(context)) broadcast over the queries.
"""
from __future__ import annotations

from typing import Optional

import torch.nn.functional as F
from torch import nn

from ..kernels.attention import dot_product_attention
from .blocks import GroupNorm32, group_norm_act, layer_norm, zero_module
from .layers import Linear, conv_nd, pointwise, remat


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Dropout(0.0),
                                 Linear(inner, dim))

    def forward(self, x):
        return self.net(x)


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None
    (attention.py:154-219)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x, context=None):
        if context is not None and context.shape[1] == 1:
            # softmax over one key is 1: the output is to_out(to_v(context))
            # for every query (the echo conditioning case)
            out = self.to_out(self.to_v(context))
            return out.expand(x.shape[0], x.shape[1], out.shape[-1])
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        b, n, _ = q.shape
        m = k.shape[1]
        h, d = self.heads, self.dim_head
        out = dot_product_attention(q.reshape(b, n, h, d),
                                    k.reshape(b, m, h, d),
                                    v.reshape(b, m, h, d))
        return self.to_out(out.reshape(b, n, h * d))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, context=None):
        x = self.attn1(layer_norm(x, self.norm1)) + x
        x = self.attn2(layer_norm(x, self.norm2), context) + x
        return self.ff(layer_norm(x, self.norm3)) + x


class SpatialTransformer(nn.Module):
    """Token attention over the flattened spatial dims of a channel-first
    (B, C, *spatial) input; 1x1 convs stored as the reference's conv
    weights, applied as linear maps on the tokens.  With `use_checkpoint`
    each transformer block is rematerialised (JAX's
    `nn.remat(BasicTransformerBlock)`)."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 dims: int = 3, use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = conv_nd(dims, in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head, context_dim)
            for _ in range(depth)])
        self.proj_out = zero_module(conv_nd(dims, inner, in_channels, 1))

    def forward(self, x, context=None):
        b, c = x.shape[:2]
        spatial = x.shape[2:]
        h = group_norm_act(x, self.norm).reshape(b, c, -1).transpose(1, 2)
        h = pointwise(self.proj_in, h)
        for block in self.transformer_blocks:
            h = (remat(block, h, context) if self.use_checkpoint
                 else block(h, context))
        h = pointwise(self.proj_out, h)
        # x first: the sum takes x's memory layout, not the channels-last
        # strides of the tokens' transposed view (the fused norm of the
        # next block reads channel-first slabs)
        return x + h.transpose(1, 2).reshape(b, c, *spatial)
