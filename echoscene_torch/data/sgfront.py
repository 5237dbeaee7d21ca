"""SG-FRONT dataset reader with manipulation sampling.

Port of echoscene_tpu/data/sgfront.py (reference dataset/
threedfront_dataset.py:47-615); host-side numpy, the same file layout and the
same random streams (`random.Random` and `np.random.default_rng` from the
same seed), so a scene reads identically in both packages:
  classes_<room>.txt, relationships.txt, mapping.json,
  relationships_<room>_{trainval,test}.json, obj_boxes_<room>_*.json,
  centered_bounds_<room>_trainval.txt, 3D-FUTURE-SDF/<model>/ori_sample_grid.h5

Per item (__getitem__ :236-496): optional instance shuffle; coarse class ids
via mapping.json ('large=False'), fine-grained ids kept; boxes as param7 with
the translation centred by scene_center and min-max scaled to [-1, 1] (angle
untouched); SDF paths per node; triples [s, p, o] with predicate ids shifted
+1 for the root 'in' edge; a '_scene_' root node (class 0) with an 'in' edge
from every node; CLIP text features per node and per relation phrase; and,
with with_changes, one manipulation per scene ('addition' drops a node from
the encoder view, 'relationship' fakes an encoder-side predicate at train
time or inverts a decoder-side one in interpretable eval).

SceneExample uses shared node indexing (decoder order): absence from the
encoder view is a mask, not a renumbering (core/graphbatch.py).
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..core.boxes import (digitize_angle, load_box_stats, scale_box_params,
                          standardize_box_params)
from .clip_text import ClipTextEncoder

# relation inversion table (threedfront_dataset.py:21-37)
CHANGED_RELATIONSHIPS = {
    "left": "right", "right": "left", "front": "behind", "behind": "front",
    "bigger than": "smaller than", "smaller than": "bigger than",
    "taller than": "shorter than", "shorter than": "taller than",
    "close by": "close by", "same style as": "same style as",
    "same super category as": "same super category as",
    "same material as": "same material as", "symmetrical to": "symmetrical to",
    "standing on": "standing on", "above": "above",
}

# spatially interpretable predicate ids (threedfront_dataset.py:563)
INTERPRETABLE_RELS = [1, 2, 3, 4, 8, 9, 10, 11]


@dataclasses.dataclass
class SceneExample:
    """One scene, decoder-indexed, numpy."""
    scan_id: str
    objs: np.ndarray              # i32[n] coarse ids
    objs_grained: np.ndarray      # i32[n]
    triples: np.ndarray           # i32[t, 3] decoder triples (local indices)
    boxes: np.ndarray             # f32[n, 7]
    text_feats: np.ndarray        # f32[n, 512]
    rel_feats: np.ndarray         # f32[t, 512] decoder-side phrases
    enc_triples: np.ndarray       # i32[t, 3] encoder-side predicates
    enc_rel_feats: np.ndarray     # f32[t, 512]
    enc_node_mask: np.ndarray     # f32[n] 0 = missing in encoder view
    enc_triple_mask: np.ndarray   # f32[t]
    change_flags: np.ndarray      # f32[n]
    manipulation_type: str = "none"
    sdf_paths: Optional[List[Optional[str]]] = None  # per node; None = zero grid
    instance_ids: Optional[List[int]] = None

    @property
    def num_nodes(self):
        return len(self.objs)


def load_vocab(root: str, room_type: str, large: bool = False):
    """(fine class names, relationships, mapping, coarse class -> id,
    vocab dict) of a dataset root (threedfront_dataset.py:80-105)."""
    with open(os.path.join(root, f"classes_{room_type}.txt")) as f:
        fine_names = [l.rstrip("\n") for l in f if l.strip()]
    with open(os.path.join(root, "relationships.txt")) as f:
        relationships = [l.rstrip("\n").lower() for l in f if l.strip()]
    with open(os.path.join(root, "mapping.json")) as f:
        mapping = json.load(f)
    coarse = (sorted(fine_names) if large
              else sorted(set(mapping[n] for n in fine_names)))
    classes = {c: i for i, c in enumerate(coarse)}
    # predicate vocab: 'in' prepended at id 0 (threedfront_dataset.py:87-89)
    vocab = {
        "object_idx_to_name": [c + "\n" for c in
                               (fine_names if large
                                else [mapping[n] for n in fine_names])],
        "object_idx_to_name_grained": [n + "\n" for n in fine_names],
        "pred_idx_to_name": [p + "\n" for p in ["in"] + relationships],
    }
    return fine_names, relationships, mapping, classes, vocab


class SGFrontDataset:
    def __init__(self, root: str, split: str = "train_scans",
                 room_type: str = "bedroom", shuffle_objs: bool = True,
                 use_sdf: bool = False, use_scene_rels: bool = True,
                 with_changes: bool = True, eval_mode: bool = False,
                 eval_type: str = "none", large: bool = False,
                 clip: Optional[ClipTextEncoder] = None,
                 data_len: Optional[int] = None, seed: Optional[int] = None,
                 sdf_res: int = 64, bin_angle: bool = False):
        self.root = root
        # legacy 24-bin angle + mean/std box standardisation
        # (threedfront_dataset.py:300-304)
        self.bin_angle = bin_angle
        self.room_type = room_type
        self.shuffle_objs = shuffle_objs
        self.use_sdf = use_sdf
        self.use_scene_rels = use_scene_rels
        self.with_changes = with_changes
        self.eval_mode = eval_mode
        self.eval_type = eval_type
        self.large = large
        self.sdf_res = sdf_res
        self.clip = clip or ClipTextEncoder("auto")
        self.rng = random.Random(seed if seed is not None else 47)
        self.np_rng = np.random.default_rng(seed if seed is not None else 47)

        (fine_names, self.relationships, self.mapping, self.classes,
         self.vocab) = load_vocab(root, room_type, large)
        self.pred_names = ["in"] + self.relationships
        self.rel_dict = {r: i + 1 for i, r in enumerate(self.relationships)}
        self.rel_dict_r = {v: k for k, v in self.rel_dict.items()}
        self.fine_grained_classes = dict(
            zip(sorted(fine_names), range(len(fine_names))))
        self.classes_r = {i: c for c, i in self.classes.items()}

        self.box_stats_path = os.path.join(
            root, f"centered_bounds_{room_type}_trainval.txt")
        if bin_angle:
            # mean/std file: 2 rows of >= 7 values (helpers/util.py:570-590),
            # not the 14-float min/max file of the sincos path
            self.box_stats_msd = np.loadtxt(self.box_stats_path,
                                            dtype=np.float32).reshape(2, -1)
            self.box_stats = None
        else:
            self.box_stats = load_box_stats(self.box_stats_path)

        suffix = "trainval" if split == "train_scans" else "test"
        rel_file = os.path.join(root, f"relationships_{room_type}_{suffix}.json")
        box_file = os.path.join(root, f"obj_boxes_{room_type}_{suffix}.json")
        self.scans: List[str] = []
        self.rel_json: Dict[str, list] = {}
        self.objs_json: Dict[str, dict] = {}
        self.boxes_json: Dict[str, dict] = {}
        self._read_jsons(rel_file, box_file)
        self.data_len = data_len
        self._sdf_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._sdf_cache_max = 4096
        self._sdf_cache_lock = threading.Lock()

    def _read_jsons(self, rel_file: str, box_file: str):
        """read_relationship_json (:165-216)."""
        with open(box_file) as f:
            box_data = json.load(f)
        with open(rel_file) as f:
            data = json.load(f)
        for scan in data["scans"]:
            rels = []
            for r in scan["relationships"]:
                r = list(r)
                r[2] -= 1
                rels.append(r)
            sid = scan["scan"]
            self.scans.append(sid)
            self.rel_json[sid] = rels
            self.objs_json[sid] = {int(k): v for k, v in scan["objects"].items()}
            self.boxes_json[sid] = box_data[sid]

    def __len__(self):
        return self.data_len if self.data_len is not None else len(self.scans)

    # ------------------------------------------------------------------
    def _load_scene(self, scan_id: str):
        instance2label = self.objs_json[scan_id]
        keys = list(instance2label.keys())
        if self.shuffle_objs:
            self.rng.shuffle(keys)

        cat_ids, cat_ids_grained, boxes, sdf_paths = [], [], [], []
        instance2mask = {0: 0}
        instances_order = []
        counter = 0
        box_json = self.boxes_json[scan_id]
        scene_center = np.asarray(box_json["scene_center"], np.float32)
        for key in keys:
            label = instance2label[key]
            if not self.large:
                grained_id = self.fine_grained_classes[label]
                class_id = self.classes[self.mapping[label]]
            else:
                grained_id = class_id = self.classes[label]
            instance2mask[key] = counter + 1
            counter += 1
            if class_id >= 0 and key > 0:
                cat_ids.append(class_id)
                cat_ids_grained.append(grained_id)
                b = np.asarray(box_json[str(key)]["param7"], np.float32).copy()
                b[3:6] -= scene_center
                if self.bin_angle:
                    b[6] = digitize_angle(b[6])
                    b[0:6] = standardize_box_params(
                        b[0:6], self.box_stats_msd[0][:6],
                        self.box_stats_msd[1][:6])
                else:
                    b = scale_box_params(b, self.box_stats, angle=False)
                boxes.append(b)
                instances_order.append(key)
                if self.use_sdf:
                    mp = box_json[str(key)].get("model_path")
                    if mp:
                        sdf_paths.append(os.path.join(
                            os.path.dirname(mp.replace("3D-FUTURE-model",
                                                       "3D-FUTURE-SDF")),
                            "ori_sample_grid.h5"))
                    else:
                        sdf_paths.append(None)

        triples, words = [], []
        for r in self.rel_json[scan_id]:
            if r[0] in instance2mask and r[1] in instance2mask:
                s = instance2mask[r[0]] - 1
                o = instance2mask[r[1]] - 1
                p = r[2] + 1
                if s >= 0 and o >= 0:
                    triples.append([s, p, o])
                    sl = (instance2label[r[0]] if self.large
                          else self.mapping[instance2label[r[0]]])
                    ol = (instance2label[r[1]] if self.large
                          else self.mapping[instance2label[r[1]]])
                    words.append(f"{sl} {r[3]} {ol}")

        if self.use_scene_rels:
            scene_idx = len(cat_ids)
            for i, ob in enumerate(cat_ids):
                triples.append([i, 0, scene_idx])
                words.append(f"{self.classes_r[ob]} in room")
            cat_ids.append(0)
            cat_ids_grained.append(0)
            boxes.append(np.full(7, -1.0, np.float32))
            if self.use_sdf:
                sdf_paths.append(None)
        return (cat_ids, cat_ids_grained, triples, words, boxes, sdf_paths,
                instances_order)

    def _node_texts(self, cat_ids):
        texts = [self.classes_r[c] for c in cat_ids]
        if self.use_scene_rels:
            texts[-1] = "room"
        return texts

    # ------------------------------------------------------------------
    def __getitem__(self, index: int) -> Optional[SceneExample]:
        scan_id = self.scans[index % len(self.scans)]
        (cat_ids, grained, triples, words, boxes, sdf_paths,
         instance_ids) = self._load_scene(scan_id)
        n = len(cat_ids)
        t = len(triples)
        if t == 0 or n == 0:
            return None

        text_feats = self.clip.encode_many(self._node_texts(cat_ids))
        rel_feats = self.clip.encode_many(words)
        triples = np.asarray(triples, np.int64)

        enc_triples = triples.copy()
        enc_rel_feats = rel_feats.copy()
        enc_node_mask = np.ones(n, np.float32)
        enc_triple_mask = np.ones(t, np.float32)
        change_flags = np.zeros(n, np.float32)
        mtype = "none"

        if self.with_changes:
            if not self.eval_mode:
                mtype = ["relationship", "addition", "none"][
                    self.np_rng.integers(3)]
            else:
                mtype = self.eval_type

            if mtype == "addition":
                node_id = self._pick_removable(cat_ids)
                if node_id < 0:
                    if self.eval_mode:
                        return None
                    mtype = "none"
                else:
                    enc_node_mask[node_id] = 0.0
                    change_flags[node_id] = 1.0
                    touching = ((triples[:, 0] == node_id) |
                                (triples[:, 2] == node_id))
                    enc_triple_mask[touching] = 0.0
            elif mtype == "relationship":
                idx, new_pred, ok = self._pick_relationship(
                    cat_ids, triples, interpretable=self.eval_mode)
                if not ok:
                    if self.eval_mode:
                        return None
                    mtype = "none"
                else:
                    s, p, o = triples[idx]
                    change_flags[s] = 1.0
                    change_flags[o] = 1.0
                    phrase = words[idx].replace(
                        self.rel_dict_r[int(p)], self.rel_dict_r[int(new_pred)])
                    if not self.eval_mode:
                        # train: fake the encoder side (:446, :604)
                        enc_triples[idx, 1] = new_pred
                        enc_rel_feats[idx] = self.clip.encode(phrase)
                    else:
                        # eval: invert the decoder side (:467)
                        triples = triples.copy()
                        triples[idx, 1] = new_pred
                        rel_feats = rel_feats.copy()
                        rel_feats[idx] = self.clip.encode(phrase)

        return SceneExample(
            scan_id=scan_id,
            objs=np.asarray(cat_ids, np.int32),
            objs_grained=np.asarray(grained, np.int32),
            triples=triples.astype(np.int32),
            boxes=np.stack(boxes).astype(np.float32),
            text_feats=text_feats,
            rel_feats=rel_feats,
            enc_triples=enc_triples.astype(np.int32),
            enc_rel_feats=enc_rel_feats,
            enc_node_mask=enc_node_mask,
            enc_triple_mask=enc_triple_mask,
            change_flags=change_flags,
            manipulation_type=mtype,
            sdf_paths=sdf_paths if self.use_sdf else None,
            instance_ids=instance_ids,
        )

    def _pick_removable(self, cat_ids) -> int:
        """remove_node_and_relationship (:499-516): random non-floor,
        non-root node."""
        excluded = {self.classes.get("floor", -1)}
        candidates = [i for i in range(len(cat_ids) - 1)
                      if cat_ids[i] not in excluded]
        if not candidates:
            return -1
        return int(self.np_rng.choice(candidates))

    def _pick_relationship(self, cat_ids, triples, interpretable: bool):
        """modify_relship (:550-609)."""
        excluded = {self.classes.get("floor", -1)}
        t = len(triples)
        for _ in range(1000):
            idx = int(self.np_rng.integers(t))
            s, p, o = (int(v) for v in triples[idx])
            if p == 0:
                continue
            if cat_ids[s] in excluded or cat_ids[o] in excluded:
                continue
            if interpretable:
                if p not in INTERPRETABLE_RELS:
                    continue
                new_pred = self.rel_dict[
                    CHANGED_RELATIONSHIPS[self.rel_dict_r[p]]]
            else:
                new_pred = int(self.np_rng.integers(1, 12))
                if new_pred == p:
                    continue
            return idx, new_pred, True
        return -1, -1, False

    # ------------------------------------------------------------------
    def load_sdf(self, path: Optional[str]) -> np.ndarray:
        """SDF grid clamped to +-0.2 (:309-318), channel-last (R, R, R, 1);
        zeros for a node without a model or a missing file.  An LRU cache
        keeps recent grids; its bookkeeping is locked because collate reads
        grids from a thread pool (the file read runs outside the lock)."""
        r = self.sdf_res
        if path is None:
            return np.zeros((r, r, r, 1), np.float32)
        with self._sdf_cache_lock:
            hit = self._sdf_cache.get(path)
            if hit is not None:
                self._sdf_cache.move_to_end(path)
                return hit
        if not os.path.exists(path):
            return np.zeros((r, r, r, 1), np.float32)
        try:
            import h5py
        except ImportError as e:
            raise RuntimeError(
                f"reading the SDF grid {path} needs the h5py package, which "
                "is not installed here; run without SDFs (use_sdf=False) or "
                "install h5py") from e
        with h5py.File(path, "r") as f:
            sdf = np.asarray(f["pc_sdf_sample"][:], np.float32)
        sdf = np.clip(sdf.reshape(r, r, r, 1), -0.2, 0.2)
        with self._sdf_cache_lock:
            self._sdf_cache[path] = sdf
            if len(self._sdf_cache) > self._sdf_cache_max:
                self._sdf_cache.popitem(last=False)
        return sdf
