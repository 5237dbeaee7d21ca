"""Attention dispatcher: einsum math, or the CUDA kernels for long sequences.

Port of echoscene_tpu/kernels/attention.py.  `dot_product_attention(q, k, v)`
is the entry point of every attention site (nn/attention.py, nn/vqvae.py).
Layout is JAX's: q (B, L, H, D), k/v (B, S, H, D).

Routing is JAX's rule with "tensor is on CUDA" in place of "backend is TPU":
no mask, L == S and L >= PALLAS_MIN_SEQ go to `flash_attention`, which keeps
JAX's one-pass / stream split, so each call site takes the same kernel as in
JAX (the shape UNet's 1024-token sites K1, the VQ-VAE's 4096-token site K2).
Everything else (the 256-token sites, cross-attention, masked attention) is
the einsum math `attention_plain`, as XLA einsum in JAX.  There is no
fallback: on CUDA a routed call launches its kernel or raises (the kernels
take bf16 and f32, as JAX's keep the input dtype; any other dtype at a
routed site raises).  The threshold is JAX's TPU value, not yet re-measured
on the H100.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import attention_plain, flash_attention

PALLAS_MIN_SEQ = 512


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, L, H, D); k, v: (B, S, H, D); mask broadcastable to
    (B, H, L, S).  Returns (B, L, H, D)."""
    if (mask is None and q.shape[1] == k.shape[1]
            and q.shape[1] >= PALLAS_MIN_SEQ and q.is_cuda):
        return flash_attention(q, k, v)
    return attention_plain(q, k, v, mask)
