"""Real-data readiness gate: validate an SG-FRONT tree against every file
contract the loader depends on, and warm reference-format CLIP caches.

A copy of echoscene_tpu/data/check.py (numpy, json, pickle and h5py only;
the port cannot import any echoscene_tpu module without pulling in jax),
run by `python -m echoscene_torch.data.check_cli`.  The reference assumes
its data is well-formed and fails deep inside __getitem__ when it isn't;
this module front-loads the format strictness into one command with
actionable errors:

  * classes_<room>.txt / relationships.txt / mapping.json cross-consistency
    (threedfront_dataset.py:73-117),
  * relationships_<room>_{trainval,test}.json schema: scans[].{scan, objects,
    relationships[[s, o, pred_1based, phrase]]} (read_relationship_json
    :165-216),
  * obj_boxes_<room>_*.json: per-scan scene_center + per-instance param7 /
    model_path (:277-318),
  * centered_bounds_<room>_trainval.txt layout (14-float min/max for the
    sincos path; 2-row mean/std for bin_angle — helpers/util.py:516-617),
  * 3D-FUTURE-SDF/<model>/ori_sample_grid.h5 presence + 'pc_sdf_sample'
    dataset at res^3 (:309-318; needs h5py),
  * per-scan CLIP feature pickles `visualization/<scan>/CLIP[_small]_<scan>
    .pkl` with aligned `instance_order` (:352-371).

`write_clip_cache` produces those pickles in the reference's exact layout
(instance_feats ndarray with the room row appended, instance_order WITHOUT
the room node, rel_feats phrase->vector dict — threedfront_dataset.py:393-403)
with the port's CLIP text encoder (data/clip_text.py).
"""
from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class CheckReport:
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    stats: Dict[str, object] = field(default_factory=dict)

    def error(self, msg: str) -> None:
        self.errors.append(msg)

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)

    @property
    def ok(self) -> bool:
        return not self.errors

    def render(self) -> str:
        lines = ["== SG-FRONT readiness report =="]
        for k, v in self.stats.items():
            lines.append(f"  {k}: {v}")
        for w in self.warnings:
            lines.append(f"  WARNING: {w}")
        for e in self.errors:
            lines.append(f"  ERROR: {e}")
        lines.append(f"RESULT: {'OK' if self.ok else 'FAILED'} "
                     f"({len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s))")
        return "\n".join(lines)


def _all_finite(x) -> bool:
    """True iff x converts to a finite float array (non-numeric entries —
    e.g. strings in a corrupted json — report as NOT finite rather than
    crashing the checker with a TypeError)."""
    try:
        return bool(np.isfinite(np.asarray(x, np.float64)).all())
    except (TypeError, ValueError):
        return False


def _sdf_path_for(model_path: str) -> str:
    """model_path -> SDF h5 path, the loader's exact transform
    (data/sgfront.py load path; reference threedfront_dataset.py:309-313)."""
    return os.path.join(
        os.path.dirname(model_path.replace("3D-FUTURE-model",
                                           "3D-FUTURE-SDF")),
        "ori_sample_grid.h5")


def clip_pickle_path(root: str, scan_id: str, large: bool = False) -> str:
    """Reference cache location (threedfront_dataset.py:120-123, 252-256)."""
    name = (f"CLIP_{scan_id}.pkl" if large else f"CLIP_small_{scan_id}.pkl")
    return os.path.join(root, "visualization", scan_id, name)


def check_dataset(root: str, room_type: str = "bedroom",
                  splits: Sequence[str] = ("trainval", "test"),
                  sdf_res: int = 64, sdf_sample: int = 16,
                  large: bool = False, check_clip: bool = False,
                  bin_angle: bool = False) -> CheckReport:
    rep = CheckReport()

    # --- vocab files -----------------------------------------------------
    classes_path = os.path.join(root, f"classes_{room_type}.txt")
    if not os.path.isfile(classes_path):
        rep.error(f"missing {classes_path} (fine class vocabulary)")
        return rep
    with open(classes_path) as f:
        fine_names = [l.rstrip("\n") for l in f if l.strip()]
    if not fine_names:
        rep.error(f"{classes_path} is empty")
    if len(set(fine_names)) != len(fine_names):
        dupes = sorted({n for n in fine_names if fine_names.count(n) > 1})
        rep.error(f"duplicate class names in {classes_path}: {dupes}")
    rep.stats["fine_classes"] = len(fine_names)

    rel_path = os.path.join(root, "relationships.txt")
    if not os.path.isfile(rel_path):
        rep.error(f"missing {rel_path} (predicate vocabulary)")
        return rep
    with open(rel_path) as f:
        relationships = [l.rstrip("\n").lower() for l in f if l.strip()]
    rep.stats["predicates"] = len(relationships)
    if len(relationships) != 15:
        rep.warn(f"{rel_path} lists {len(relationships)} predicates; the "
                 "SG-FRONT release has 15 — manipulation inversion "
                 "(CHANGED_RELATIONSHIPS) assumes that vocabulary")

    mapping_path = os.path.join(root, "mapping.json")
    if not os.path.isfile(mapping_path):
        rep.error(f"missing {mapping_path} (fine->coarse class map)")
        return rep
    try:
        mapping = json.load(open(mapping_path))
    except json.JSONDecodeError as e:
        rep.error(f"{mapping_path} is not valid JSON: {e}")
        return rep
    unmapped = [n for n in fine_names if n not in mapping]
    if unmapped:
        rep.error(f"mapping.json lacks entries for fine classes {unmapped} "
                  "— the loader KeyErrors on these (sgfront.py coarse path)")
    rep.stats["coarse_classes"] = len(
        set(mapping.get(n) for n in fine_names if n in mapping))

    # --- box normalisation stats ----------------------------------------
    bounds_path = os.path.join(root,
                               f"centered_bounds_{room_type}_trainval.txt")
    if not os.path.isfile(bounds_path):
        rep.error(f"missing {bounds_path} (box scale stats)")
    else:
        try:
            vals = np.loadtxt(bounds_path, dtype=np.float64)
        except ValueError as e:
            vals = None
            rep.error(f"{bounds_path} unparsable: {e}")
        if vals is not None:
            flat = np.asarray(vals).reshape(-1)
            if bin_angle:
                if vals.ndim != 2 or vals.shape[0] != 2 or vals.shape[1] < 7:
                    rep.error(
                        f"{bounds_path}: bin_angle expects a 2-row mean/std "
                        f"file with >=7 columns (helpers/util.py:570-590), "
                        f"got shape {np.asarray(vals).shape}")
            elif flat.size != 14:
                rep.error(
                    f"{bounds_path}: sincos path expects 14 values "
                    f"(min_lhw, max_lhw, min_xyz, max_xyz, min/max angle — "
                    f"core/boxes.load_box_stats), got {flat.size}")
            elif not np.isfinite(flat).all():
                rep.error(f"{bounds_path} contains non-finite values")

    # --- per-split scan jsons --------------------------------------------
    model_paths: Dict[str, str] = {}   # model_path -> first scan using it
    all_scan_words: Dict[str, List[str]] = {}
    all_scan_objs: Dict[str, Dict[int, str]] = {}
    n_nodes_all: List[int] = []
    n_rels_all: List[int] = []
    for suffix in splits:
        rjson = os.path.join(root, f"relationships_{room_type}_{suffix}.json")
        bjson = os.path.join(root, f"obj_boxes_{room_type}_{suffix}.json")
        if not os.path.isfile(rjson):
            rep.error(f"missing {rjson}")
            continue
        if not os.path.isfile(bjson):
            rep.error(f"missing {bjson}")
            continue
        try:
            rel_data = json.load(open(rjson))
        except json.JSONDecodeError as e:
            rep.error(f"{rjson} is not valid JSON: {e}")
            continue
        try:
            box_data = json.load(open(bjson))
        except json.JSONDecodeError as e:
            rep.error(f"{bjson} is not valid JSON: {e}")
            continue
        if "scans" not in rel_data or not isinstance(rel_data["scans"], list):
            rep.error(f"{rjson}: top-level 'scans' list missing")
            continue

        seen_ids = set()
        for scan in rel_data["scans"]:
            sid = scan.get("scan")
            if not sid:
                rep.error(f"{rjson}: scan entry without 'scan' id")
                continue
            if sid in seen_ids:
                rep.error(f"{rjson}: duplicate scan id {sid}")
            seen_ids.add(sid)
            objects = scan.get("objects")
            if not isinstance(objects, dict) or not objects:
                rep.error(f"{rjson}:{sid}: 'objects' missing or empty")
                continue
            inst_ids = {}
            for k, label in objects.items():
                try:
                    ik = int(k)
                except ValueError:
                    rep.error(f"{rjson}:{sid}: object key {k!r} not an int")
                    continue
                inst_ids[ik] = label
                if label not in fine_names:
                    rep.error(f"{rjson}:{sid}: object label {label!r} not in "
                              f"classes_{room_type}.txt")
            rels = scan.get("relationships", [])
            words = []
            for r in rels:
                if not isinstance(r, (list, tuple)) or len(r) < 4:
                    rep.error(f"{rjson}:{sid}: relationship row {r!r} must "
                              "be [subj, obj, pred_id, phrase]")
                    continue
                s, o, p, phrase = r[0], r[1], r[2], r[3]
                if s not in inst_ids or o not in inst_ids:
                    rep.error(f"{rjson}:{sid}: relationship {r[:3]} touches "
                              "instance(s) absent from 'objects'")
                try:
                    pid = int(p)
                except (TypeError, ValueError):
                    rep.error(f"{rjson}:{sid}: predicate id {p!r} is not an "
                              "integer (the loader's int() would crash)")
                    pid = None
                if pid is None:
                    pass
                elif not (1 <= pid <= len(relationships)):
                    rep.error(f"{rjson}:{sid}: predicate id {p} outside "
                              f"1..{len(relationships)} (ids are 1-based; "
                              "the loader shifts by -1, sgfront.py:165)")
                elif str(phrase).lower() != relationships[pid - 1]:
                    rep.warn(f"{rjson}:{sid}: phrase {phrase!r} != predicate "
                             f"{pid} ({relationships[pid - 1]!r}); the "
                             "loader uses the TEXT for CLIP phrases and the "
                             "ID for supervision — they should agree")
                if s in inst_ids and o in inst_ids:
                    sl = (inst_ids[s] if large
                          else mapping.get(inst_ids[s], inst_ids[s]))
                    ol = (inst_ids[o] if large
                          else mapping.get(inst_ids[o], inst_ids[o]))
                    words.append(f"{sl} {phrase} {ol}")
            # scene-rel phrases: with use_scene_rels the loader appends an
            # '<label> in room' word per instance and indexes
            # clip_feats_rel[word] (threedfront_dataset.py:344, :419) — a
            # cache lacking them KeyErrors inside the reference __getitem__
            for ik in sorted(inst_ids):
                lbl = (inst_ids[ik] if large
                       else mapping.get(inst_ids[ik], inst_ids[ik]))
                words.append(f"{lbl} in room")
            n_nodes_all.append(len(inst_ids))
            n_rels_all.append(len(rels))
            all_scan_words[sid] = words
            all_scan_objs[sid] = inst_ids

            # box entries
            if sid not in box_data:
                rep.error(f"{bjson}: scan {sid} missing (present in {rjson})")
                continue
            boxes = box_data[sid]
            sc = boxes.get("scene_center")
            if (not isinstance(sc, (list, tuple)) or len(sc) != 3
                    or not _all_finite(sc)):
                rep.error(f"{bjson}:{sid}: scene_center must be 3 finite "
                          f"floats, got {sc!r}")
            for ik in inst_ids:
                ent = boxes.get(str(ik))
                if ent is None:
                    rep.error(f"{bjson}:{sid}: no box entry for instance {ik}")
                    continue
                p7 = ent.get("param7")
                if (not isinstance(p7, (list, tuple)) or len(p7) != 7
                        or not _all_finite(p7)):
                    rep.error(f"{bjson}:{sid}:{ik}: param7 must be 7 finite "
                              f"floats, got {p7!r}")
                mp = ent.get("model_path")
                if mp:
                    model_paths.setdefault(mp, sid)

        rep.stats[f"scans_{suffix}"] = len(seen_ids)

    if n_nodes_all:
        rep.stats["objects_per_scene(min/mean/max)"] = (
            int(np.min(n_nodes_all)), round(float(np.mean(n_nodes_all)), 1),
            int(np.max(n_nodes_all)))
        rep.stats["relations_per_scene(min/mean/max)"] = (
            int(np.min(n_rels_all)), round(float(np.mean(n_rels_all)), 1),
            int(np.max(n_rels_all)))

    # --- SDF grids --------------------------------------------------------
    rep.stats["unique_models"] = len(model_paths)
    sdf_paths = {_sdf_path_for(mp): sid for mp, sid in model_paths.items()}
    missing = [p for p in sdf_paths if not os.path.isfile(p)]
    rep.stats["sdf_files(found/missing)"] = (len(sdf_paths) - len(missing),
                                             len(missing))
    if missing:
        rep.warn(f"{len(missing)}/{len(sdf_paths)} SDF h5 files missing "
                 f"(loader zero-fills them — shape branch would train on "
                 f"empty grids); first: {missing[0]}")
        if len(missing) == len(sdf_paths) and sdf_paths:
            rep.error("ALL SDF grids are missing — check the "
                      "3D-FUTURE-SDF tree layout "
                      "(<root-of-model-path>/3D-FUTURE-SDF/<model>/"
                      "ori_sample_grid.h5)")
    present = [p for p in sdf_paths if os.path.isfile(p)]
    to_open = present if sdf_sample <= 0 else present[:sdf_sample]
    for p in to_open:
        try:
            import h5py
            with h5py.File(p, "r") as f:
                if "pc_sdf_sample" not in f:
                    rep.error(f"{p}: dataset 'pc_sdf_sample' missing "
                              f"(has {list(f.keys())})")
                    continue
                arr = np.asarray(f["pc_sdf_sample"][:], np.float32)
            if arr.size != sdf_res ** 3:
                rep.error(f"{p}: {arr.size} values != sdf_res^3 "
                          f"({sdf_res}^3={sdf_res ** 3}); pass the correct "
                          "--sdf_res")
            elif not np.isfinite(arr).all():
                rep.error(f"{p}: non-finite SDF values")
        except OSError as e:
            rep.error(f"{p}: unreadable h5 ({e})")
    if to_open:
        rep.stats["sdf_files_opened"] = len(to_open)

    # --- CLIP caches --------------------------------------------------------
    if check_clip:
        n_found = 0
        for sid, inst_ids in all_scan_objs.items():
            path = clip_pickle_path(root, sid, large)
            if not os.path.isfile(path):
                continue
            n_found += 1
            try:
                with open(path, "rb") as f:
                    d = pickle.load(f)
            except Exception as e:  # noqa: BLE001 — any unpickle failure
                rep.error(f"{path}: unreadable pickle ({e})")
                continue
            for k in ("instance_feats", "instance_order", "rel_feats"):
                if k not in d:
                    rep.error(f"{path}: key {k!r} missing")
            if rep.errors and rep.errors[-1].startswith(path):
                continue
            feats = np.asarray(d["instance_feats"])
            order = list(d["instance_order"])
            if feats.ndim != 2 or feats.shape[1] != 512:
                rep.error(f"{path}: instance_feats must be (n, 512), got "
                          f"{feats.shape}")
                continue
            # loader alignment (threedfront_dataset.py:358-369): one feature
            # per ordered instance, optionally + a trailing room row
            if len(feats) - len(order) not in (0, 1):
                rep.error(f"{path}: instance_feats rows ({len(feats)}) must "
                          f"equal len(instance_order) ({len(order)}) or "
                          "+1 (trailing room feature)")
            missing_inst = [i for i in inst_ids if i not in order]
            if missing_inst:
                rep.error(f"{path}: instance_order lacks instances "
                          f"{missing_inst} of the scan — the loader's "
                          "order-matching would produce EMPTY feature rows")
            rf = d.get("rel_feats", {})
            if not isinstance(rf, dict):
                rep.error(f"{path}: rel_feats must be a phrase->vector dict")
            else:
                miss = [w for w in all_scan_words.get(sid, []) if w not in rf]
                if miss:
                    rep.warn(f"{path}: rel_feats lacks {len(miss)} phrase(s) "
                             f"used by the scan, e.g. {miss[0]!r}")
        rep.stats["clip_pickles_found"] = (
            f"{n_found}/{len(all_scan_objs)}")
        if n_found == 0 and all_scan_objs:
            rep.warn("no CLIP pickles found — run with --write_clip_cache "
                     "(or the reference's warm pass) before training "
                     "with_CLIP")
    return rep


def write_clip_cache(root: str, room_type: str = "bedroom",
                     splits: Sequence[str] = ("trainval", "test"),
                     large: bool = False, encoder=None,
                     overwrite: bool = False) -> int:
    """Write reference-format per-scan CLIP pickles
    (threedfront_dataset.py:393-403): instance_feats has ONE ROW PER
    instance in instance_order plus a trailing 'room' row; instance_order
    excludes the room node; rel_feats maps '<subj> <phrase> <obj>' -> vector.

    Returns the number of pickles written."""
    from .clip_text import ClipTextEncoder

    enc = encoder or ClipTextEncoder("auto")
    mapping = json.load(open(os.path.join(root, "mapping.json")))
    written = 0
    for suffix in splits:
        rjson = os.path.join(root, f"relationships_{room_type}_{suffix}.json")
        rel_data = json.load(open(rjson))
        for scan in rel_data["scans"]:
            sid = scan["scan"]
            path = clip_pickle_path(root, sid, large)
            if os.path.exists(path) and not overwrite:
                continue
            objects = {int(k): v for k, v in scan["objects"].items()}
            order = sorted(objects)
            labels = [objects[k] if large else mapping[objects[k]]
                      for k in order]
            feats = enc.encode_many(labels + ["room"])
            rel_feats = {}
            for r in scan.get("relationships", []):
                s, o, _, phrase = r[0], r[1], r[2], r[3]
                sl = objects[s] if large else mapping[objects[s]]
                ol = objects[o] if large else mapping[objects[o]]
                rel_feats[f"{sl} {phrase} {ol}"] = enc.encode(
                    f"{sl} {phrase} {ol}")
            # '<label> in room' scene-rel phrases: the reference builds one
            # per instance when use_scene_rels is on and indexes
            # clip_feats_rel[word] (threedfront_dataset.py:344, :419)
            for lbl in labels:
                word = f"{lbl} in room"
                if word not in rel_feats:
                    rel_feats[word] = enc.encode(word)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump({"instance_feats": np.asarray(feats, np.float32),
                             "instance_order": order,
                             "rel_feats": rel_feats}, f)
            written += 1
    return written
