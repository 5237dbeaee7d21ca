"""Profiling and numerics-debugging helpers.

Port of echoscene_tpu/train/profiling.py:
  * `profile_trace(log_dir)`: a `torch.profiler` trace (CPU and CUDA
    activities) around a training window, written as a Chrome trace; the
    program's layers appear in it as `echoscene.<name>` ranges
    (`echoscene_torch/trace.py`), which record only while it runs;
  * `StepTimer`: rolling wall-clock step time and scenes/sec per device;
  * `enable_nan_debugging()`: `torch.autograd.set_detect_anomaly`, the
    reference's switch (train_3dfront.py:210).  The train step itself
    already zeroes NaN gradients, as the reference does at run time; this is
    for debugging.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the enclosed window into `<log_dir>/trace.json`; yields the
    profiler (its `key_averages()` sums time by kernel)."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_debugging(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(on)


class StepTimer:
    """Rolling wall-clock step timing over the last `window` steps; reports
    scenes/sec per device (`devices`: the devices one step runs on)."""

    def __init__(self, scenes_per_step: int, window: int = 50,
                 devices: int = 1):
        self.scenes = scenes_per_step
        self.window = window
        self.devices = devices
        self._t0: Optional[float] = None
        self._times = []

    def tick(self):
        now = time.perf_counter()
        if self._t0 is not None:
            self._times.append(now - self._t0)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._t0 = now

    @property
    def step_seconds(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    @property
    def scenes_per_sec(self) -> float:
        s = self.step_seconds
        return self.scenes / s / max(self.devices, 1) if s else 0.0
