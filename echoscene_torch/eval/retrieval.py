"""3D-FUTURE mesh retrieval by predicted box size, and txt2shape meshes.

Port of echoscene_tpu/eval/retrieval.py, host numpy as there (reference
helpers/util.py:71-138: `get_closest_furniture_to_box`, the L2 nearest size
per category of `cat_jid_trainval[_small].json`, and `get_database_objects`,
which loads `<model_dir>/<jid>/raw_model.obj`, yaw-rotates and translates it
into the predicted box, skips `_scene_` / `floor` and may drop lamps; and
`get_sdfusion_models`, :334-374, per-category result meshes fitted to the
boxes).  Angles are radians throughout (the repo's box convention); object
exports are OBJ.  Drives the eval CLI's `--render_type retrieval` and
`txt2shape` modes, the layout-only configs' shape visualisations.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from .render import (box_mesh, class_color, export_obj, fit_verts_to_box,
                     get_rotation_3dfront, read_ply)


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal ASCII OBJ reader (v / f lines; polygons fan-triangulated)."""
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3))


class SizeDatabase:
    """cat_jid_trainval[_small].json wrapper with vectorized nearest-size
    lookup (get_closest_furniture_to_box, helpers/util.py:71-83)."""

    def __init__(self, json_path: str, model_dir: Optional[str] = None):
        with open(json_path) as f:
            self.table: Dict[str, Dict[str, Sequence[float]]] = json.load(f)
        self.model_dir = model_dir or os.path.join(
            os.path.dirname(os.path.abspath(json_path)), "3D-FUTURE-model")
        self._cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._mesh_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def closest(self, label: str, size: Sequence[float]) -> Optional[str]:
        if label not in self.table or not self.table[label]:
            return None
        if label not in self._cache:
            d = self.table[label]
            self._cache[label] = (np.asarray(list(d.keys())),
                                  np.asarray(list(d.values()), np.float32))
        ids, lhw = self._cache[label]
        mses = np.sum((lhw - np.asarray(size, np.float32)) ** 2, axis=-1)
        return str(ids[int(np.argmin(mses))])

    def load_mesh(self, jid: str) -> Tuple[np.ndarray, np.ndarray]:
        if jid not in self._mesh_cache:
            self._mesh_cache[jid] = read_obj(
                os.path.join(self.model_dir, jid, "raw_model.obj"))
        return self._mesh_cache[jid]


def place_retrieved(verts: np.ndarray, box7: Sequence[float]) -> np.ndarray:
    """Yaw + translate a retrieved mesh into the scene (get_database_objects
    :120-128: vertices @ R(angle) + t, no rescale — the mesh was chosen to
    match the predicted size).  box7 angle in RADIANS."""
    angle = float(box7[6])
    t = np.asarray(box7[3:6], np.float32)
    R = get_rotation_3dfront(angle).astype(np.float32)
    return (np.asarray(verts, np.float32) @ R + t).astype(np.float32)


class _SceneAccum:
    """Triangle-soup accumulator with a ground plane (shared by the
    non-generated mesh-source render modes)."""

    def __init__(self, floor_extent: float = 5.0):
        self._v: List[np.ndarray] = []
        self._t: List[np.ndarray] = []
        self._c: List[np.ndarray] = []
        self._off = 0
        fv = np.array([[-floor_extent, 0, -floor_extent],
                       [floor_extent, 0, -floor_extent],
                       [floor_extent, 0, floor_extent],
                       [-floor_extent, 0, floor_extent]], np.float32)
        self.add(fv, np.array([[0, 2, 1], [0, 3, 2]], np.int32),
                 np.array([0.85, 0.85, 0.85], np.float32))

    def add(self, v, t, color):
        if len(t) == 0:
            return
        self._v.append(v)
        self._t.append(t + self._off)
        self._c.append(np.tile(color[None], (len(t), 1)))
        self._off += len(v)

    def result(self):
        if not self._v:
            return (np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.int32),
                    np.zeros((0, 3), np.float32))
        return (np.concatenate(self._v),
                np.concatenate(self._t).astype(np.int32),
                np.concatenate(self._c))


def assemble_scene_retrieval(objs: Sequence[int], boxes7: np.ndarray,
                             class_names: Sequence[str], db: SizeDatabase,
                             skip_classes: Sequence[str] = ("_scene_", "floor"),
                             without_lamp: bool = True,
                             floor_extent: float = 5.0,
                             mesh_dir: Optional[str] = None):
    """-> (verts, tris, tri_colors) with database meshes; objects whose
    category has no table entry fall back to a solid box.  When `mesh_dir`
    is given, each placed object is exported as
    `<label>_<cat>_<instance>.obj` (get_database_objects :118)."""
    acc = _SceneAccum(floor_extent)
    instance = 1
    for i, cid in enumerate(objs):
        name = class_names[int(cid)].rstrip("\n")
        if name in skip_classes or (without_lamp and name == "lamp"):
            continue
        jid = db.closest(name, boxes7[i, :3])
        color = class_color(name)
        if jid is None:
            cv, ct = box_mesh(boxes7[i])
            acc.add(cv, ct, color)
            continue
        mv, mt = db.load_mesh(jid)
        mv = place_retrieved(mv, boxes7[i])
        if mesh_dir:
            os.makedirs(mesh_dir, exist_ok=True)
            export_obj(os.path.join(
                mesh_dir, f"{name}_{int(cid)}_{instance}.obj"), mv, mt)
        instance += 1
        acc.add(mv, mt, color)
    return acc.result()


class MeshResultsDir:
    """Pre-generated per-category mesh results — the reference's `txt2shape`
    render mode (get_sdfusion_models, helpers/util.py:334-374: SDFusion
    text-to-shape outputs organised as `<root>/<label>/*.ply`).

    Pick policy: the reference draws `random.choice` under a per-object
    re-seeded RNG whose seed is itself random (helpers/util.py:350-352) —
    irreproducible by construction.  Here the pick is deterministic
    (`index % len(files)` over the sorted listing) so eval runs repeat.
    """

    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, List[str]] = {}
        self._mesh_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        # A mistyped --txt2shape_dir must fail loudly, not silently degrade
        # every object to the solid-box fallback.
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"txt2shape mesh database not found: {root!r}")
        has_ply = any(
            os.path.isdir(os.path.join(root, d)) and any(
                f.endswith(".ply")
                for f in os.listdir(os.path.join(root, d)))
            for d in os.listdir(root))
        if not has_ply:
            import warnings
            warnings.warn(
                f"txt2shape mesh database {root!r} contains no "
                "<label>/*.ply results; all objects will render as solid "
                "boxes", stacklevel=2)

    def files(self, label: str) -> List[str]:
        if label not in self._files:
            d = os.path.join(self.root, label)
            self._files[label] = sorted(
                f for f in (os.listdir(d) if os.path.isdir(d) else [])
                if f.endswith(".ply"))
        return self._files[label]

    def pick(self, label: str, index: int):
        """-> (verts, faces) for the index-th result of `label`, or None."""
        fs = self.files(label)
        if not fs:
            return None
        path = os.path.join(self.root, label, fs[index % len(fs)])
        if path not in self._mesh_cache:
            self._mesh_cache[path] = read_ply(path)
        return self._mesh_cache[path]


def assemble_scene_txt2shape(objs: Sequence[int], boxes7: np.ndarray,
                             class_names: Sequence[str], db: MeshResultsDir,
                             skip_classes: Sequence[str] = ("_scene_", "floor"),
                             without_lamp: bool = True,
                             floor_extent: float = 5.0,
                             mesh_dir: Optional[str] = None):
    """txt2shape assembly (get_sdfusion_models :334-374): per object load a
    pre-generated category mesh and FIT it to the predicted box (scale +
    yaw + translate via fit_shapes_to_box_v2 semantics — unlike retrieval,
    which only places).  Categories with no results fall back to a solid
    box.  `mesh_dir` exports match the reference's
    `<label>_<cat>_<instance>.obj` naming AND content (:363-364): the RAW
    pre-fit mesh is exported, and lamps are exported (instance advancing)
    before `without_lamp` drops them from the render only (:366-367)."""
    acc = _SceneAccum(floor_extent)
    instance = 1
    for i, cid in enumerate(objs):
        name = class_names[int(cid)].rstrip("\n")
        if name in skip_classes:
            continue
        color = class_color(name)
        got = db.pick(name, i)
        if got is None or got[1] is None or len(got[1]) == 0:
            if without_lamp and name == "lamp":
                continue
            cv, ct = box_mesh(boxes7[i])
            acc.add(cv, ct, color)
            continue
        mv, mt = got
        if mesh_dir:
            os.makedirs(mesh_dir, exist_ok=True)
            export_obj(os.path.join(
                mesh_dir, f"{name}_{int(cid)}_{instance}.obj"), mv, mt)
        instance += 1
        mv = fit_verts_to_box(mv, boxes7[i])
        if without_lamp and name == "lamp":
            continue
        acc.add(mv, mt, color)
    return acc.result()


def render_scene_txt2shape(objs, boxes7, class_names, db: MeshResultsDir,
                           image_size: int = 256, **kw) -> np.ndarray:
    verts, tris, colors = assemble_scene_txt2shape(objs, boxes7, class_names,
                                                   db, **kw)
    return native.rasterize_topdown(verts, tris, colors,
                                    width=image_size, height=image_size)


def render_scene_retrieval(objs, boxes7, class_names, db: SizeDatabase,
                           image_size: int = 256, **kw) -> np.ndarray:
    verts, tris, colors = assemble_scene_retrieval(objs, boxes7, class_names,
                                                   db, **kw)
    return native.rasterize_topdown(verts, tris, colors,
                                    width=image_size, height=image_size)
