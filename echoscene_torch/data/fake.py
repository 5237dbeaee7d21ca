"""Synthetic SG-FRONT-format fixture generator.

Port of echoscene_tpu/data/fake.py: writes a miniature dataset directory in
the exact file layout the reader consumes (classes_<room>.txt,
relationships.txt, mapping.json, relationships_<room>_*.json,
obj_boxes_<room>_*.json, centered_bounds_<room>_trainval.txt and, with
`with_sdf`, 3D-FUTURE-SDF h5 grids), drawing from the same numpy stream as
the JAX package, so both write the same files from the same seed.
"""
from __future__ import annotations

import json
import os

import numpy as np

FAKE_FINE_CLASSES = [
    "_scene_", "armchair", "bookshelf", "cabinet", "double_bed", "floor",
    "lamp", "nightstand", "table", "wardrobe",
]
FAKE_MAPPING = {
    "_scene_": "_scene_", "armchair": "chair", "bookshelf": "shelf",
    "cabinet": "cabinet", "double_bed": "bed", "floor": "floor",
    "lamp": "lamp", "nightstand": "nightstand", "table": "table",
    "wardrobe": "cabinet",
}
FAKE_RELATIONSHIPS = [
    "left", "right", "front", "behind", "close by", "above", "standing on",
    "bigger than", "smaller than", "taller than", "shorter than",
    "symmetrical to", "same style as", "same super category as",
    "same material as",
]


def make_fake_dataset(root: str, room_type: str = "bedroom",
                      num_scenes: int = 6, min_objs: int = 3,
                      max_objs: int = 6, sdf_res: int = 64,
                      with_sdf: bool = True, seed: int = 0,
                      unique_models: bool = False) -> str:
    """`num_scenes` trainval scans and max(2, num_scenes // 2) test scans.
    unique_models=True gives every object instance its own SDF file (the
    real SG-FRONT shape); the default shares ~3 models per class.  Writing
    SDF grids needs h5py."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)

    with open(os.path.join(root, f"classes_{room_type}.txt"), "w") as f:
        f.write("\n".join(FAKE_FINE_CLASSES) + "\n")
    with open(os.path.join(root, "relationships.txt"), "w") as f:
        f.write("\n".join(FAKE_RELATIONSHIPS) + "\n")
    with open(os.path.join(root, "mapping.json"), "w") as f:
        json.dump(FAKE_MAPPING, f)
    # min_lhw(3) max_lhw(3) min_xyz(3) max_xyz(3) min/max angle
    stats = np.array([0.05, 0.05, 0.05, 3.5, 3.0, 3.5,
                      -3.0, -3.0, -3.0, 3.0, 3.0, 3.0,
                      -np.pi, np.pi], np.float32)
    np.savetxt(os.path.join(root, f"centered_bounds_{room_type}_trainval.txt"),
               stats.reshape(1, -1))

    placeable = [c for c in FAKE_FINE_CLASSES if c != "_scene_"]
    sdf_dir = os.path.join(root, "3D-FUTURE-SDF")

    def make_scan(sid: str):
        n = int(rng.integers(min_objs, max_objs + 1))
        labels = ["floor"] + list(rng.choice(
            [c for c in placeable if c != "floor"], size=n - 1, replace=True))
        objects = {str(i + 1): str(labels[i]) for i in range(n)}
        boxes = {}
        for i in range(n):
            size = rng.uniform(0.2, 2.0, 3)
            loc = rng.uniform(-2.0, 2.0, 3)
            angle = rng.uniform(-np.pi, np.pi)
            model_id = (f"model_{sid}_{i}_{labels[i]}" if unique_models
                        else f"model_{labels[i]}_{int(rng.integers(3))}")
            model_path = f"/data/3D-FUTURE-model/{model_id}/raw.obj"
            if labels[i] == "floor":
                model_path = None
            boxes[str(i + 1)] = {
                "param7": [*size.tolist(), *loc.tolist(), float(angle)],
                "scale": [1, 1, 1],
                "model_path": model_path,
            }
            if model_path and with_sdf:
                d = os.path.join(sdf_dir, model_id)
                os.makedirs(d, exist_ok=True)
                h5p = os.path.join(d, "ori_sample_grid.h5")
                if not os.path.exists(h5p):
                    grid = _sphere_sdf(sdf_res, rng)
                    _write_h5(h5p, grid)
        boxes["scene_center"] = [0.0, 0.0, 0.0]
        rels = []
        for i in range(n):
            for j in range(i + 1, n):
                if rng.random() < 0.6:
                    pred = int(rng.integers(1, len(FAKE_RELATIONSHIPS) + 1))
                    rels.append([i + 1, j + 1, pred,
                                 FAKE_RELATIONSHIPS[pred - 1]])
        return objects, boxes, rels

    for suffix, count in (("trainval", num_scenes),
                          ("test", max(2, num_scenes // 2))):
        scans = []
        box_data = {}
        for k in range(count):
            sid = f"fake_scene_{suffix}_{k}"
            objects, boxes, rels = make_scan(sid)
            # model paths point into root, as the reference rewrites them
            # relative to its dataset root (threedfront_dataset.py:109-114)
            for v in boxes.values():
                if isinstance(v, dict) and v.get("model_path"):
                    v["model_path"] = os.path.join(
                        root, "3D-FUTURE-model",
                        v["model_path"].split("3D-FUTURE-model/")[1])
            scans.append({"scan": sid, "objects": objects,
                          "relationships": rels})
            box_data[sid] = boxes
        with open(os.path.join(root, f"relationships_{room_type}_{suffix}.json"),
                  "w") as f:
            json.dump({"scans": scans}, f)
        with open(os.path.join(root, f"obj_boxes_{room_type}_{suffix}.json"),
                  "w") as f:
            json.dump(box_data, f)
    return root


def _write_h5(path: str, grid: np.ndarray) -> None:
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            f"writing the SDF grid {path} needs the h5py package, which is "
            "not installed here; pass with_sdf=False") from e
    with h5py.File(path, "w") as hf:
        hf.create_dataset("pc_sdf_sample", data=grid)


def _sphere_sdf(res: int, rng) -> np.ndarray:
    """Random-radius sphere SDF on a [-1, 1]^3 grid, clamped like the data."""
    coords = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(coords, coords, coords, indexing="ij")
    r = float(rng.uniform(0.3, 0.7))
    sdf = np.sqrt(x * x + y * y + z * z) - r
    return np.clip(sdf, -0.2, 0.2).astype(np.float32)
