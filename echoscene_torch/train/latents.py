"""The latent cache: frozen-VQ-VAE latents of every unique SDF of a dataset.

Port of scripts/precompute_latents.py (library part).  The frozen encoder
is deterministic, so the 16^3 x 3 latent of each unique 3D-FUTURE object
is computed once, and training batches carry it instead of the 64^3 grid
(`Trainer(latent_lookup=...)` -> `collate_scenes`): the encoder, and its
K2 launch, leave the training step.  The file is interchangeable with
JAX's: an `np.savez_compressed` archive keyed by SDF path, plus
"__zero__" (the latent of the zero grid that nodes without a model get),
each an f32 array of shape (16, 16, 16, 3).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..data.collate import _sdf_read_pool

ZERO_KEY = "__zero__"
READ_CHUNK = 64    # bounded read-ahead: Executor.map submits everything


@torch.no_grad()
def precompute_latents(vqvae, paths: Sequence[str],
                       load_fn: Callable[[Optional[str]], np.ndarray],
                       batch: int = 8, device="cuda"
                       ) -> Dict[str, np.ndarray]:
    """{path: latent} for `paths` and ZERO_KEY, encoded `batch` grids at a
    time by `vqvae` (a VQVAE module on `device`; `encode_no_quant` in its
    parameters' dtype).  load_fn(path) -> (R, R, R, 1) grid, and
    load_fn(None) the zero grid (the dataset's `load_sdf` contract); the
    reads run on a thread pool and overlap the encodes."""
    out: Dict[str, np.ndarray] = {}
    buf, keys = [], []

    def flush():
        if not buf:
            return
        x = torch.from_numpy(np.stack(buf)).to(device)
        z = vqvae.encode_no_quant(x).float().cpu().numpy()
        for k, zi in zip(keys, z):
            out[k] = zi.astype(np.float32)
        buf.clear()
        keys.clear()

    # the zero grid (floor / _scene_ nodes) has a nonzero latent too
    buf.append(load_fn(None))
    keys.append(ZERO_KEY)
    pool = _sdf_read_pool()
    for start in range(0, len(paths), READ_CHUNK):
        part = list(paths[start:start + READ_CHUNK])
        for path, grid in zip(part, pool.map(load_fn, part)):
            buf.append(grid)
            keys.append(path)
            if len(buf) == batch:
                flush()
    flush()
    return out


def write_latent_cache(dest: str, latents: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(dest, **latents)


def dataset_sdf_paths(dataset) -> list:
    """The sorted unique SDF paths over every example of `dataset`."""
    paths = set()
    for i in range(len(dataset)):
        ex = dataset[i]
        if ex is None or ex.sdf_paths is None:
            continue
        paths.update(p for p in ex.sdf_paths if p)
    return sorted(paths)


def make_latent_lookup(npz_path: str, latent_shape=(16, 16, 16, 3)):
    """callable(path) -> latent, for collate_scenes(latent_lookup=...); a
    path that is None or not in the cache gets the zero grid's latent."""
    data = np.load(npz_path)
    zero = data[ZERO_KEY] if ZERO_KEY in data else np.zeros(
        latent_shape, np.float32)

    def lookup(path):
        if path is None or path not in data:
            return zero
        return data[path]

    return lookup
