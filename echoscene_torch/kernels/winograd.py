"""Winograd F(2x2x2, 3x3x3) convolution as torch matrix products.

Port of echoscene_tpu/kernels/winograd.py, which is XLA einsums (no Pallas
kernel): the `sample_conv: winograd` option of the sampling twin, off by
default, as in JAX (whose own measurement found it slower than the direct
convolution at every shape-UNet level).  Lavin & Gray's transforms
(arXiv:1509.09308, correlation convention):

    Y = A^T [ (G g G^T) . (B^T d B) ] A     per axis, tensor product in 3D

Each 2x2x2 output tile comes from a 4x4x4 input tile (stride 2) in 64
multiplies instead of 216.  The casts are JAX's (winograd.py:116-153): the
weight transform u = G3 w in f32, once, cast to the activation dtype;
v = B3^T-transform of the tiles accumulated in f32 and rounded to the
activation dtype; m = the 64 per-position channel products accumulated in
f32 and rounded; the inverse transform in f32, then + bias, then the
activation dtype.  Stages one and three run in f32 on f32 copies (their
matrices hold 0 and +-1, so the products are exact and only the sums
round), stage two in the activation dtype with f32 accumulation.

Layouts are the port's: x channel-first (B, C, D, H, W) with D, H, W even,
weight (K, C, 3, 3, 3).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_BT = np.array([[1, 0, -1, 0],
                [0, 1, 1, 0],
                [0, -1, 1, 0],
                [0, 1, 0, -1]], np.float32)
_G = np.array([[1, 0, 0],
               [0.5, 0.5, 0.5],
               [0.5, -0.5, 0.5],
               [0, 0, 1]], np.float32)
_AT = np.array([[1, 1, 1, 0],
                [0, 1, -1, -1]], np.float32)


@functools.lru_cache(None)
def _mats_np():
    b3 = np.kron(np.kron(_BT, _BT), _BT)    # (64, 64)
    g3 = np.kron(np.kron(_G, _G), _G)       # (64, 27)
    a3 = np.kron(np.kron(_AT, _AT), _AT)    # (8, 64)
    return b3, g3, a3


def _mat(i: int, device) -> torch.Tensor:
    return torch.from_numpy(_mats_np()[i]).to(device)


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """(K, C, 3, 3, 3) -> (64, C, K) f32 Winograd-domain weights, U = G3 w
    (JAX's transform_weights on its (3, 3, 3, C, K) kernel)."""
    k, c = w.shape[:2]
    taps = w.float().permute(2, 3, 4, 1, 0).reshape(27, c * k)
    return (_mat(1, w.device) @ taps).reshape(64, c, k)


def winograd_conv3d(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME stride-1 3x3x3 convolution: x (B, C, D, H, W), D, H, W even;
    w (K, C, 3, 3, 3) -> (B, K, D, H, W) in x's dtype.  `u` (from
    `transform_weights`, in any dtype) skips the weight transform."""
    bs, c, d, h, wd = x.shape
    k = w.shape[0]
    if d % 2 or h % 2 or wd % 2:
        raise ValueError(f"winograd_conv3d needs even D, H, W, got "
                         f"{(d, h, wd)}")
    td, th, tw = d // 2, h // 2, wd // 2
    dt = x.dtype
    if u is None:
        u = transform_weights(w)
    u = u.to(dt)
    # overlapping 4^3 tiles at stride 2 of the zero-padded input, as
    # (64 tile positions, rows, C) with rows = (B, td, th, tw)
    xp = F.pad(x, (1, 1) * 3)
    tiles = xp.unfold(2, 4, 2).unfold(3, 4, 2).unfold(4, 4, 2)
    tiles = tiles.permute(5, 6, 7, 0, 2, 3, 4, 1).reshape(64, -1)
    rows = bs * td * th * tw
    # input transform: sums / differences, f32 accumulation, rounded
    v = (_mat(0, x.device) @ tiles.float()).to(dt).reshape(64, rows, c)
    # the 64 per-position channel products, f32 accumulation, rounded
    m = torch.bmm(v, u)
    # inverse transform in f32
    y = _mat(2, x.device) @ m.float().reshape(64, rows * k)
    y = y.reshape(2, 2, 2, bs, td, th, tw, k)
    y = y.permute(3, 7, 4, 0, 5, 1, 6, 2).reshape(bs, k, d, h, wd)
    if b is not None:
        y = y + b.float().reshape(1, -1, 1, 1, 1)
    return y.to(dt)
