"""Bounding-box parameter codecs needed by sampling (`split_sample`).

Port of echoscene_tpu/core/boxes.py (helpers/util.py:516-568 of the
reference).  Boxes are (l, h, w, x, y, z, angle); angles travel through the
diffusion as (sin, cos) pairs, so the denoised vector is 8-dim.  Works on
torch tensors.
"""
from __future__ import annotations

import torch


def descale_box_params(normed: torch.Tensor, stats,
                       angle: bool = False) -> torch.Tensor:
    """Inverse min-max scaling from [-1, 1] (helpers/util.py:542-557).

    `normed` is (..., >=6); `stats` holds 14 values: min_lhw(3), max_lhw(3),
    min_xyz(3), max_xyz(3), min_angle(1), max_angle(1)."""
    s = torch.as_tensor(stats, dtype=normed.dtype, device=normed.device)
    min_lhw, max_lhw, min_xyz, max_xyz = s[:3], s[3:6], s[6:9], s[9:12]
    min_a, max_a = s[12:13], s[13:14]
    size = (normed[..., :3] + 1) / 2 * (max_lhw - min_lhw) + min_lhw
    loc = (normed[..., 3:6] + 1) / 2 * (max_xyz - min_xyz) + min_xyz
    rest = normed[..., 6:]
    if angle and rest.shape[-1] > 0:
        rest = (rest + 1) / 2 * (max_a - min_a) + min_a
    return torch.cat([size, loc, rest], dim=-1)


def angle_to_sincos(angle: torch.Tensor) -> torch.Tensor:
    """(..., 1) angle -> (..., 2) (sin, cos)."""
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def sincos_to_angle(sincos: torch.Tensor) -> torch.Tensor:
    """(..., 2) (sin, cos) -> (..., 1) angle via atan2."""
    return torch.atan2(sincos[..., 0:1], sincos[..., 1:2])
