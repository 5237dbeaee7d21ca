"""Build and load the port's CUDA kernels.

A source under `echoscene_torch/csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface, loaded with
`ctypes`.  The library lands in `build/kernels/` at the root of the checkout
(listed in `.gitignore`), named by a hash of its source, so an edited source
rebuilds and an unchanged one is reused.  Nothing is built at import time:
the first wrapper call on a CUDA tensor builds, or `build(source)` does;
`build_all(sources)` runs one nvcc per source, all at once.  `load` holds
a lock, so that threads of one process (the data-parallel sampler's, one a
device) build and load each library once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


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
    return build_all([source])[source][1]


def build_all(sources: Sequence[str]) -> Dict[str, Tuple[float, str]]:
    """Compile every source whose library is missing, one nvcc each, all
    started together; returns {source: (wall seconds, nvcc output)} (0 s and
    '' for a library already built).  Raises if any nvcc fails, after every
    nvcc it started has ended."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    out: Dict[str, Tuple[float, str]] = {}
    failed = []
    try:
        for source in sources:
            target = _target(source)
            if os.path.exists(target):
                out[source] = (0.0, "")
                continue
            tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
            # nvcc's report is a few KB, well inside the pipe buffer, so it
            # is read after the process ends
            procs[source] = (tmp, target, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC_DIR, source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        pending = dict(procs)
        while pending:
            for source, (tmp, target, proc) in list(pending.items()):
                if proc.poll() is None:
                    continue
                del pending[source]
                log = proc.stdout.read()
                proc.stdout.close()
                out[source] = (time.perf_counter() - t0, log)
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on {source}:\n{log}")
                else:
                    os.replace(tmp, target)
            time.sleep(0.05)
    finally:
        for _, _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build(source)
            lib = _libs[source] = ctypes.CDLL(_target(source))
        return lib
