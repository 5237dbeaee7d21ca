"""Rotated 3D box overlap: a differentiable soft IoU for the collision loss.

Port of echoscene_tpu/core/box_overlap.py (the reference's own obb path,
mmcv's rotated IoU, is unreachable: its import is commented out,
diffusion_ddpm.py:15).  A fixed lattice of points is placed inside each
subject box; each point's soft membership in the object box is the product
of per-axis sigmoids of its signed distance to the faces in the object's
frame, and their mean approximates Vol(A ∩ B) / Vol(A).
"""
from __future__ import annotations

import torch


def _yaw_rot(yaw: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation about +y (helpers/util.py get_rotation_3dfront)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, zeros, -s], -1),
                        torch.stack([zeros, ones, zeros], -1),
                        torch.stack([s, zeros, c], -1)], -2)


def _lattice(k: int, device=None) -> torch.Tensor:
    """(k^3, 3) unit-cube lattice in [-0.5, 0.5] (y in [0, 1])."""
    ax = (torch.arange(k, dtype=torch.float32, device=device) + 0.5) / k - 0.5
    gx, gy, gz = torch.meshgrid(ax, ax + 0.5, ax, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)


def soft_rotated_iou_matrix(boxes: torch.Tensor, k: int = 4,
                            tau: float = 25.0) -> torch.Tensor:
    """boxes: (N, 7) [l, h, w, x, y, z, yaw] with (x, y, z) the bottom
    centre -> soft pairwise overlap (N, N); entry (i, j) ~ Vol(Bi ∩ Bj) /
    Vol(Bi) in [0, 1]."""
    size, center, yaw = boxes[:, :3], boxes[:, 3:6], boxes[:, 6]
    rot = _yaw_rot(yaw)                        # world -> local
    rot_inv = rot.transpose(-1, -2)
    # subject points: scale (w, h, l) on (x, y, z), then local -> world
    scale = torch.stack([size[:, 2], size[:, 1], size[:, 0]], -1)
    pts = _lattice(k, boxes.device)[None] * scale[:, None, :]
    pts = torch.einsum("nij,npj->npi", rot_inv, pts) + center[:, None, :]
    # membership of every subject point in every object box
    rel = pts[:, None, :, :] - center[None, :, None, :]          # (N, N, P, 3)
    local = torch.einsum("mij,nmpj->nmpi", rot, rel)
    half = scale / 2
    # y spans [0, h] rather than [-h/2, h/2]
    shift = torch.zeros(3, device=boxes.device, dtype=boxes.dtype)
    shift[1] = 1.0
    local = local - (half[:, 1:2] * shift)[None, :, None, :]
    dist = half[None, :, None, :] - local.abs()                   # > 0 inside
    return torch.sigmoid(tau * dist).prod(-1).mean(-1)
