"""Scene-generation evaluator (the core of eval_3dfront.py:234-328).

Port of echoscene_tpu/eval/evaluator.py.  `SceneEvaluator` generates scenes
group-wise with the port's `SGDiff.sample_fn` on its device, scores the
scene-graph constraint accuracy per scene, dumps each scene's SDFs in the
JAX `.npz` format (`--dump_sdfs`, the consistency CLI's input) and writes the
reference report; `write_accuracy_report` keeps the reference line format.

Not ported yet, and raising NotImplementedError: data-parallel generation
over several cards (`dp_devices > 1`, the multi-GPU slice) and the renders
(`render_dir`, the render / retrieval slice).
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.boxes import (bin_angles_to_degrees, descale_box_params,
                          destandardize_box_params)
from ..data.collate import collate_scenes
from ..models.sgdiff import shape_row_capacity
from .metrics import (new_accuracy_dict, validate_constrains,
                      validate_constrains_changes)


def write_accuracy_report(path: str, named_accs) -> str:
    """Reference report format (eval_3dfront.py:307-328)."""
    lines = []
    for dic, typ in named_accs:
        m = lambda k: float(np.mean(dic[k])) if dic[k] else float("nan")
        lr = np.nanmean([m("left"), m("right")])
        fb = np.nanmean([m("front"), m("behind")])
        bism = np.nanmean([m("bigger"), m("smaller")])
        tash = np.nanmean([m("taller"), m("shorter")])
        stand, close, symm, total = (m("standing on"), m("close by"),
                                     m("symmetrical to"), m("total"))
        mom = np.nanmean([lr, fb, bism, tash, stand, close, symm])
        lines.append(
            "{} & L/R: {:.2f} & F/B: {:.2f} & Bi/Sm: {:.2f} & Ta/Sh: {:.2f} "
            "& Stand: {:.2f} & Close: {:.2f} & Symm: {:.2f}. Total: &{:.2f}"
            .format(typ, lr, fb, bism, tash, stand, close, symm, total))
        lines.append("means of mean: {:.2f}\n".format(mom))
    text = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(text)
    print(text)
    return text


class SceneEvaluator:
    """Generates scenes group-wise and scores constraint accuracy.

    The reference evaluates one scene per 1100-step run
    (eval_3dfront.py:236-241); grouping `eval_batch` scenes per generation
    call gives per-scene identical results in fewer calls."""

    def __init__(self, sg, spec, stats, *, gen_shape: bool = False,
                 store_path: str = "./eval_out",
                 render_dir: Optional[str] = None,
                 dump_sdfs: bool = False, eval_batch: int = 1,
                 dp_devices: int = 1, bin_angle: bool = False,
                 export_3d: bool = False):
        if dp_devices > 1:
            raise NotImplementedError(
                "data-parallel generation (dp_devices > 1) comes with the "
                "port's multi-GPU slice")
        if render_dir:
            raise NotImplementedError(
                "renders (render_dir) come with the port's render / "
                "retrieval slice (eval/render.py, eval/retrieval.py)")
        self.sg = sg
        self.spec = spec
        self.stats = stats
        self.gen_shape = gen_shape
        self.store_path = store_path
        self.dump_sdfs = dump_sdfs
        self.eval_batch = eval_batch
        self.bin_angle = bin_angle
        # per-scene JSON of generated boxes (+ shape refs): the reference
        # parses --export_3d but never consumes it (eval_3dfront.py:34)
        self.export_3d = export_3d
        self.skipped_scenes: List[str] = []
        os.makedirs(store_path, exist_ok=True)

    # ------------------------------------------------------------------
    def score_scene(self, ds, ex, out_slice: Dict[str, np.ndarray],
                    etype: str, acc, acc_unchanged) -> None:
        n = ex.num_nodes
        sizes, trans, angles, keep = (out_slice["sizes"],
                                      out_slice["translations"],
                                      out_slice["angles"], out_slice["keep"])
        if self.bin_angle:
            # legacy decode (eval_3dfront.py:158, :279): argmax bin ->
            # degrees and mean/std destandardisation; stats is the (2, >=6)
            # mean/std file
            angles = np.deg2rad(bin_angles_to_degrees(angles))
            boxes6 = destandardize_box_params(
                np.concatenate([sizes, trans], -1),
                self.stats[0][:6], self.stats[1][:6])
        else:
            boxes6 = descale_box_params(
                np.concatenate([sizes, trans], -1), self.stats)
        if (self.gen_shape and out_slice.get("shapes") is not None
                and self.dump_sdfs):
            np.savez_compressed(
                os.path.join(self.store_path, f"{ex.scan_id}.npz"),
                # f32: bf16 sampling outputs are cast before they get here;
                # the metric CLIs read f32 grids
                sdfs=np.asarray(out_slice["shapes"][..., 0], np.float32),
                instance_ids=np.asarray(
                    (ex.instance_ids or list(range(n - 1))) + [-1]),
                categories=np.asarray(
                    [ds.vocab["object_idx_to_name"][c].rstrip("\n")
                     for c in ex.objs]))
        gen_boxes6 = boxes6
        if etype != "none":
            # untouched nodes keep their GT boxes (eval_3dfront.py:191-202)
            if self.bin_angle:
                gt6 = destandardize_box_params(
                    ex.boxes[:, :6], self.stats[0][:6], self.stats[1][:6])
            else:
                gt6 = descale_box_params(ex.boxes[:, :6], self.stats)
            boxes6 = np.where(keep[:, None] == 1, gt6, boxes6)
            validate_constrains_changes(ex.triples, boxes6, keep,
                                        ds.vocab["pred_idx_to_name"], acc)
            validate_constrains(ex.triples, boxes6, keep,
                                ds.vocab["pred_idx_to_name"], acc_unchanged)
        else:
            validate_constrains(ex.triples, boxes6, None,
                                ds.vocab["pred_idx_to_name"], acc)
        if self.export_3d:
            d = os.path.join(self.store_path, "export_3d")
            os.makedirs(d, exist_ok=True)
            rec = {
                "scan_id": ex.scan_id,
                "objs": [int(c) for c in ex.objs],
                "classes": [ds.vocab["object_idx_to_name"][c].rstrip("\n")
                            for c in ex.objs],
                "triples": np.asarray(ex.triples).tolist(),
                "angle_unit": "radians",
                "boxes_generated": np.concatenate(
                    [gen_boxes6, angles], -1).astype(float).tolist(),
                "keep": np.asarray(keep).astype(int).tolist(),
            }
            if etype != "none":
                rec["boxes_scored"] = np.concatenate(
                    [boxes6, angles], -1).astype(float).tolist()
            if self.gen_shape and self.dump_sdfs:
                rec["sdf_file"] = f"{ex.scan_id}.npz"
            with open(os.path.join(d, f"{etype}_{ex.scan_id}.json"),
                      "w") as f:
                json.dump(rec, f, indent=1)

    # ------------------------------------------------------------------
    def sample(self, batch, generator: Optional[torch.Generator],
               manip: bool) -> Dict[str, np.ndarray]:
        """One generation call over a collated group -> host f32 arrays."""
        out = self.sg.sample_fn(batch.to(self.sg.device), generator,
                                gen_shape=self.gen_shape,
                                with_manipulation=manip,
                                shape_rows=shape_row_capacity(batch))
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def run(self, ds, etype: str, limit: int,
            generator: Optional[torch.Generator] = None):
        """Evaluate up to `limit` scenes of `ds` (all when 0); returns (acc,
        acc_unchanged, generator).  Writes `<etype>_accuracy_analysis.txt`
        in store_path.  `generator` draws every group's noise in turn, as
        JAX splits its key per group."""
        spec = self.spec
        acc = new_accuracy_dict()
        acc_unchanged = new_accuracy_dict()
        n_eval = min(limit or len(ds), len(ds))
        manip = etype != "none"

        # Scenes that don't fit the current group are requeued for the next
        # one (never dropped); scenes over capacity even alone are counted
        # and reported, since the reference scores every scene.
        queue: deque = deque()
        self.skipped_scenes = []
        scored = 0
        i = 0
        while i < n_eval or queue:
            while len(queue) < self.eval_batch and i < n_eval:
                ex = ds[i]
                i += 1
                if ex is None:
                    continue
                if (ex.num_nodes > spec.max_nodes
                        or len(ex.triples) > spec.max_triples):
                    self.skipped_scenes.append(ex.scan_id)
                    print(f"[eval] WARNING: scene {ex.scan_id} exceeds "
                          f"collate capacity ({ex.num_nodes} nodes / "
                          f"{len(ex.triples)} triples vs "
                          f"{spec.max_nodes}/{spec.max_triples}) - skipped; "
                          "raise --max_nodes/--max_triples to score it")
                    continue
                queue.append(ex)
            if not queue:
                break
            group, nn, tt = [], 0, 0
            cap = min(self.eval_batch, spec.max_scenes)
            while queue:
                e = queue[0]
                if group and (nn + e.num_nodes > spec.max_nodes
                              or tt + len(e.triples) > spec.max_triples
                              or len(group) >= cap):
                    break
                group.append(queue.popleft())
                nn += e.num_nodes
                tt += len(e.triples)
            batch = collate_scenes(group, spec)
            if batch is None:
                continue
            scored += len(group)
            out_np = self.sample(batch, generator, manip)
            off = 0
            for ex_i in group:
                sl = {k: v[off:off + ex_i.num_nodes] for k, v in out_np.items()}
                self.score_scene(ds, ex_i, sl, etype, acc, acc_unchanged)
                off += ex_i.num_nodes
        report = os.path.join(self.store_path,
                              f"{etype}_accuracy_analysis.txt")
        if etype != "none":
            write_accuracy_report(report, [(acc, "changed nodes"),
                                           (acc_unchanged, "unchanged nodes")])
        else:
            write_accuracy_report(report, [(acc, "acc")])
        if self.skipped_scenes:
            note = (f"skipped {len(self.skipped_scenes)} over-capacity "
                    f"scene(s) of {scored + len(self.skipped_scenes)}: "
                    f"{self.skipped_scenes}\n")
            with open(report, "a") as f:
                f.write(note)
            print("[eval] " + note, end="")
        return acc, acc_unchanged, generator
