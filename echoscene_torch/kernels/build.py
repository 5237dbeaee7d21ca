"""Build and load the port's CUDA kernels.

A source under `echoscene_torch/csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface, loaded with
`ctypes`.  The library lands in `build/kernels/` at the root of the checkout
(listed in `.gitignore`), named by a hash of its source, so an edited source
rebuilds and an unchanged one is reused.  Nothing is built at import time:
the first wrapper call on a CUDA tensor builds, or `build(source)` does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile `source` unless its library exists; returns nvcc's output
    (the `-Xptxas -v` register / spill report; '' when already built)."""
    target = _target(source)
    if os.path.exists(target):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    res = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stdout}")
    os.replace(tmp, target)
    return res.stdout


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed."""
    lib = _libs.get(source)
    if lib is None:
        build(source)
        lib = _libs[source] = ctypes.CDLL(_target(source))
    return lib
