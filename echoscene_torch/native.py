"""ctypes bindings for the host C++ geometry library, with NumPy fallbacks.

Port of echoscene_tpu/native.py over the same `cpp/libechoscene_native.so`
(source `cpp/echoscene_native.cpp`): marching-tetrahedra isosurface
extraction, area-weighted mesh sampling, the SDF -> point-cloud step of the
consistency and MMD metrics, host chamfer / approximate EMD, and the
top-down rasterizer of the renders.  These are
host routines, not TPU kernels.  The library is built with `make -C cpp` on
first use if it is missing; if it cannot be built or loaded, the NumPy
fallbacks serve (`available()` says which), and `chamfer_batch` falls back
to the port's plain chamfer.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_REPO, "cpp", "libechoscene_native.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_SO):
        try:
            subprocess.run(["make", "-C", os.path.join(_REPO, "cpp")],
                           check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.chamfer_batch.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, f32p]
    lib.chamfer_batch.restype = None
    lib.emd_batch.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, f32p]
    lib.emd_batch.restype = None
    lib.marching_cubes.restype = ctypes.c_int
    lib.marching_cubes.argtypes = [f32p, ctypes.c_int, ctypes.c_float,
                                   f32p, ctypes.c_int, i32p, ctypes.c_int,
                                   i32p]
    lib.sample_mesh.argtypes = [f32p, i32p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_uint64, f32p]
    lib.sample_mesh.restype = None
    lib.rasterize_topdown.argtypes = [f32p, i32p, f32p, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_float,
                                      ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.c_int, ctypes.c_int]
    lib.rasterize_topdown.restype = None
    _LIB = lib
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def available() -> bool:
    """True when the C++ library serves; False when the NumPy fallbacks do."""
    return _load() is not None


def chamfer_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a: (B,N,3), b: (B,M,3) -> (B,) chamfer (sum of both mean sq dists)."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    lib = _load()
    if lib is None:
        from .eval.pointcloud_metrics import chamfer_distance
        return chamfer_distance(a, b, device="cpu").astype(np.float32)
    out = np.zeros(a.shape[0], np.float32)
    lib.chamfer_batch(_fp(a), _fp(b), a.shape[0], a.shape[1], b.shape[1],
                      _fp(out))
    return out


def emd_batch(a: np.ndarray, b: np.ndarray, iters: int = 30) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    lib = _load()
    if lib is None:
        from .eval.pointcloud_metrics import emd_exact
        return emd_exact(a, b).astype(np.float32)
    out = np.zeros(a.shape[0], np.float32)
    lib.emd_batch(_fp(a), _fp(b), a.shape[0], a.shape[1], iters, _fp(out))
    return out


def marching_cubes(grid: np.ndarray, level: float = 0.0,
                   max_tris: int = 400000) -> Tuple[np.ndarray, np.ndarray]:
    """grid: (R,R,R) SDF -> (verts (V,3) in voxel units, tris (T,3) int32),
    vertices welded across triangles."""
    grid = np.ascontiguousarray(grid, np.float32)
    res = grid.shape[0]
    lib = _load()
    if lib is None:
        verts, tris = _marching_tetrahedra_numpy(grid, level)
        return verts, tris[:max_tris]
    # welded count is ~nt/2 in practice; nt*3 stays the hard upper bound
    verts = np.zeros((max_tris * 3, 3), np.float32)
    tris = np.zeros((max_tris, 3), np.int32)
    nv = np.zeros(1, np.int32)
    nt = lib.marching_cubes(_fp(grid), res, ctypes.c_float(level),
                            _fp(verts), max_tris * 3, _ip(tris), max_tris,
                            _ip(nv))
    if nt < 0:
        raise ValueError(f"grid res {res} exceeds the 32-bit lattice-id "
                         "weld-key space (res <= 1625)")
    return verts[:int(nv[0])].copy(), tris[:nt].copy()


def sample_mesh(verts: np.ndarray, tris: np.ndarray, n_samples: int,
                seed: int = 0) -> np.ndarray:
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    if len(tris) == 0:
        return np.zeros((n_samples, 3), np.float32)
    lib = _load()
    if lib is None:
        return _sample_mesh_numpy(verts, tris, n_samples, seed)
    out = np.zeros((n_samples, 3), np.float32)
    lib.sample_mesh(_fp(verts), _ip(tris), tris.shape[0], n_samples,
                    ctypes.c_uint64(seed), _fp(out))
    return out


def sdf_to_point_cloud(grid: np.ndarray, n_points: int = 5000,
                       level: float = 0.0, seed: int = 0,
                       normalize: bool = True) -> np.ndarray:
    """SDF grid -> surface point cloud (the consistency / MMD input):
    sdf -> mesh -> sample (consistency_check.py:77-89), voxel coords mapped
    to [-1, 1] and optionally recentred / rescaled into the unit sphere."""
    verts, tris = marching_cubes(grid, level)
    if len(tris) == 0:
        return np.zeros((n_points, 3), np.float32)
    pts = sample_mesh(verts, tris, n_points, seed)
    res = grid.shape[0]
    pts = pts / (res - 1) * 2.0 - 1.0
    if normalize:
        center = (pts.max(0) + pts.min(0)) / 2
        pts = pts - center
        scale = np.abs(pts).max() + 1e-8
        pts = pts / scale * 0.5
    return pts.astype(np.float32)


def rasterize_topdown(verts: np.ndarray, tris: np.ndarray,
                      tri_colors: np.ndarray, width: int = 256,
                      height: int = 256, cam_height: float = 8.0,
                      yfov: float = np.pi / 2) -> np.ndarray:
    """Top-down perspective render -> (H, W, 3) uint8: camera at
    (0, cam_height, 0) looking at the origin, up = -z (the reference's
    pyrender camera, helpers/visualize_scene.py:122-153).  Needs the C++
    library: there is no NumPy rasterizer."""
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    tri_colors = np.ascontiguousarray(tri_colors, np.float32)
    lib = _load()
    if lib is None:
        raise RuntimeError("native rasterizer unavailable (make -C cpp)")
    img = np.zeros((height, width, 3), np.uint8)
    lib.rasterize_topdown(
        _fp(verts), _ip(tris), _fp(tri_colors), tris.shape[0],
        ctypes.c_float(cam_height), ctypes.c_float(yfov),
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), width, height)
    return img


# --- NumPy fallbacks -------------------------------------------------------
def _sample_mesh_numpy(verts, tris, n_samples, seed):
    rng = np.random.default_rng(seed)
    v0, v1, v2 = (verts[tris[:, k]] for k in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / (areas.sum() + 1e-12)
    idx = rng.choice(len(tris), size=n_samples, p=probs)
    u = rng.random(n_samples)
    v = rng.random(n_samples)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    return (v0[idx] + u[:, None] * (v1[idx] - v0[idx])
            + v[:, None] * (v2[idx] - v0[idx])).astype(np.float32)


# 6 tetrahedra sharing the 0-6 cube diagonal + their edge enumeration; must
# mirror cpp/echoscene_native.cpp (TETS, E, quad split) so both paths emit
# the same welded 2-manifold meshes.
_MT_CX = (0, 1, 1, 0, 0, 1, 1, 0)
_MT_CY = (0, 0, 1, 1, 0, 0, 1, 1)
_MT_CZ = (0, 0, 0, 0, 1, 1, 1, 1)
_MT_TETS = ((0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
            (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6))
_MT_E = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _mt_case_tables():
    """Per-inside-mask crossing-edge lists (in _MT_E order) + triangle fans.
    np==3 -> one triangle (0,1,2); np==4 -> the C++ quad split (0,1,2),(1,3,2)."""
    edges, tris = {}, {}
    for case in range(1, 15):
        cross = [(a, b) for a, b in _MT_E
                 if ((case >> a) & 1) != ((case >> b) & 1)]
        edges[case] = cross
        tris[case] = [(0, 1, 2)] if len(cross) == 3 else [(0, 1, 2), (1, 3, 2)]
    return edges, tris


_MT_CASE_EDGES, _MT_CASE_TRIS = _mt_case_tables()


def _marching_tetrahedra_numpy(grid, level):
    """Pure-NumPy marching tetrahedra with the C++ path's edge-keyed vertex
    welding: every vertex lies on a lattice edge whose canonical
    (smaller-id-first) interpolation is bit-identical across the tets that
    share it, so np.unique over the packed edge keys welds exactly."""
    res = grid.shape[0]
    if res ** 3 >= 1 << 32:
        raise ValueError(f"grid res {res} exceeds the 32-bit lattice-id "
                         "weld-key space (res <= 1625)")
    grid = np.asarray(grid, np.float32)
    m = res - 1
    # corner value views + lattice ids, each (m, m, m) flattened
    vals, gids = [], []
    ar = np.arange(m, dtype=np.int64)
    for c in range(8):
        cx, cy, cz = _MT_CX[c], _MT_CY[c], _MT_CZ[c]
        vals.append(grid[cx:cx + m, cy:cy + m, cz:cz + m].reshape(-1))
        gid = ((ar[:, None, None] + cx) * res * res
               + (ar[None, :, None] + cy) * res
               + (ar[None, None, :] + cz)).reshape(-1)
        gids.append(gid)

    all_keys, all_pos, all_tris = [], [], []
    n_emitted = 0
    for tet in _MT_TETS:
        tv = [vals[c] for c in tet]
        tg = [gids[c] for c in tet]
        case = sum(((tv[k] < level).astype(np.int32) << k) for k in range(4))
        for cs in range(1, 15):
            sel = np.nonzero(case == cs)[0]
            if sel.size == 0:
                continue
            base = n_emitted
            for a, b in _MT_CASE_EDGES[cs]:
                ia, ib = tg[a][sel], tg[b][sel]
                va, vb = tv[a][sel], tv[b][sel]
                swap = ia > ib
                i0 = np.where(swap, ib, ia)
                i1 = np.where(swap, ia, ib)
                v0 = np.where(swap, vb, va)
                v1 = np.where(swap, va, vb)
                dv = v1 - v0
                ok = np.abs(dv) > 1e-12
                mu = np.where(ok, (np.float32(level) - v0)
                              / np.where(ok, dv, 1.0), 0.5)
                mu = np.clip(mu, 0.0, 1.0).astype(np.float32)
                p0 = np.stack([i0 // (res * res), (i0 // res) % res,
                               i0 % res], -1).astype(np.float32)
                p1 = np.stack([i1 // (res * res), (i1 // res) % res,
                               i1 % res], -1).astype(np.float32)
                all_keys.append((i0.astype(np.uint64) << np.uint64(32))
                                | i1.astype(np.uint64))
                all_pos.append(p0 + mu[:, None] * (p1 - p0))
                n_emitted += sel.size
            for t0, t1, t2 in _MT_CASE_TRIS[cs]:
                all_tris.append(np.stack(
                    [base + t0 * sel.size + np.arange(sel.size),
                     base + t1 * sel.size + np.arange(sel.size),
                     base + t2 * sel.size + np.arange(sel.size)], -1))
    if not all_tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    keys = np.concatenate(all_keys)
    pos = np.concatenate(all_pos).astype(np.float32)
    tris = np.concatenate(all_tris)
    _, first, inverse = np.unique(keys, return_index=True,
                                  return_inverse=True)
    return pos[first], inverse[tris].astype(np.int32)
