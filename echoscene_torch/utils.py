"""Small host utilities.

Port of echoscene_tpu/utils.py (reference helpers/psutil.py:1-83,
model/diff_utils/util.py:100-108, util.py:21): the /proc/meminfo reader,
`seed_everything` (which also seeds torch, every card's generator
included) and the tensor -> uint8 image conversion.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch


class FreeMemLinux:
    """Read /proc/meminfo (helpers/psutil.py)."""

    def __init__(self, unit: str = "GB"):
        self.div = {"KB": 1.0, "MB": 1024.0, "GB": 1024.0 ** 2}[unit.upper()]

    def _read(self, key: str) -> float:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith(key + ":"):
                    return float(line.split()[1]) / self.div
        return 0.0

    @property
    def total(self) -> float:
        return self._read("MemTotal")

    @property
    def available(self) -> float:
        return self._read("MemAvailable")

    @property
    def user_free(self) -> float:
        return self.available


def seed_everything(seed: int) -> None:
    """Seed Python's, numpy's and torch's generators (torch.manual_seed
    seeds every card's default generator too)."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def tensor2im(arr) -> np.ndarray:
    """(H, W, C) float in [0, 1] or [-1, 1] (an array or a tensor on any
    device) -> uint8 image."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().float().cpu().numpy()
    a = np.asarray(arr, np.float32)
    if a.min() < 0:
        a = (a + 1) / 2
    return np.clip(a * 255.0, 0, 255).astype(np.uint8)
