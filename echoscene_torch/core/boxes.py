"""Bounding-box parameter codecs.

Port of echoscene_tpu/core/boxes.py (helpers/util.py:516-644 of the
reference).  Boxes are (l, h, w, x, y, z, angle); angles travel through the
diffusion as (sin, cos) pairs, so the denoised vector is 8-dim.  The scaling
codecs work on torch tensors (sampling) and on numpy arrays (the data layer
and the evaluator); the stats file and the legacy bin-angle helpers are
numpy.
"""
from __future__ import annotations

import numpy as np
import torch


def load_box_stats(file: str) -> np.ndarray:
    """The `centered_bounds_<room>_trainval.txt` stats file: 14 floats,
    min_lhw(3), max_lhw(3), min_xyz(3), max_xyz(3), min_angle(1),
    max_angle(1) (helpers/util.py:519-520)."""
    stats = np.loadtxt(file).reshape(-1)
    if stats.shape[0] != 14:
        raise NotImplementedError(f"expected 14 stats values, got {stats.shape}")
    return stats.astype(np.float32)


def _stats_like(x, stats):
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(stats, dtype=x.dtype, device=x.device), torch.cat
    return np.asarray(stats), np.concatenate


def scale_box_params(box_params, stats, angle: bool = False):
    """Min-max scale size / loc (and optionally angle) to [-1, 1]
    (helpers/util.py:516-532).  `box_params` is (..., 7)."""
    s, cat = _stats_like(box_params, stats)
    size = 2 * (box_params[..., :3] - s[:3]) / (s[3:6] - s[:3]) - 1
    loc = 2 * (box_params[..., 3:6] - s[6:9]) / (s[9:12] - s[6:9]) - 1
    rest = box_params[..., 6:]
    if angle:
        rest = 2 * (rest - s[12:13]) / (s[13:14] - s[12:13]) - 1
    return cat([size, loc, rest], -1)


def descale_box_params(normed, stats, angle: bool = False):
    """Inverse min-max scaling from [-1, 1] (helpers/util.py:542-557).
    `normed` is (..., >=6)."""
    s, cat = _stats_like(normed, stats)
    min_lhw, max_lhw, min_xyz, max_xyz = s[:3], s[3:6], s[6:9], s[9:12]
    min_a, max_a = s[12:13], s[13:14]
    size = (normed[..., :3] + 1) / 2 * (max_lhw - min_lhw) + min_lhw
    loc = (normed[..., 3:6] + 1) / 2 * (max_xyz - min_xyz) + min_xyz
    rest = normed[..., 6:]
    if angle and rest.shape[-1] > 0:
        rest = (rest + 1) / 2 * (max_a - min_a) + min_a
    return cat([size, loc, rest], -1)


def angle_to_sincos(angle: torch.Tensor) -> torch.Tensor:
    """(..., 1) angle -> (..., 2) (sin, cos)."""
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def sincos_to_angle(sincos: torch.Tensor) -> torch.Tensor:
    """(..., 2) (sin, cos) -> (..., 1) angle via atan2."""
    return torch.atan2(sincos[..., 0:1], sincos[..., 1:2])


def box_vec_from_boxes(boxes7: torch.Tensor) -> torch.Tensor:
    """(..., 7) scaled boxes with the raw angle -> (..., 8) diffusion-space
    vectors (size, translation, sin, cos)."""
    return torch.cat([boxes7[..., :6], angle_to_sincos(boxes7[..., 6:7])],
                     dim=-1)


def standardize_box_params(box_params, stats_mean, stats_std,
                           scale: float = 3.0):
    """Mean/std standardisation (helpers/util.py:570-590)."""
    return scale * ((box_params - stats_mean) / stats_std)


def destandardize_box_params(box_params, stats_mean, stats_std,
                             scale: float = 3.0):
    return (box_params * stats_std) / scale + stats_mean


ANGLE_BIN_EDGES = np.linspace(np.deg2rad(-180), np.deg2rad(180), 24)


def digitize_angle(angle: float) -> float:
    """Angle (rad) -> 15-degree bin index, clamped into [0, 24)
    (threedfront_dataset.py:300-303; train_3dfront.py:230-233)."""
    b = float(np.digitize(angle, ANGLE_BIN_EDGES))
    return b if 0.0 < b < 24.0 else 0.0


def bin_angles_to_degrees(angles_pred: np.ndarray) -> np.ndarray:
    """Legacy 24-bin angle decode: -180 + (argmax + 1) * 15 degrees
    (eval_3dfront.py:158, :279).  angles_pred: (N, K>=2) bin scores."""
    return -180.0 + (np.argmax(np.asarray(angles_pred), axis=1,
                               keepdims=True) + 1) * 15.0
