"""Batched scene-generation service.

Port of echoscene_tpu/serve/service.py (the reference has no serving path:
generation lives only inside its eval script).  Requests are plain dicts of
object class names and named relationship triples; they are grouped into
padded flat graph batches (one `CollateSpec` bucket per call), generated by
`SGDiff.sample_fn`, and answered with descaled world-unit boxes per object
and, optionally, the SDF grids or marching-tetrahedra meshes.  A request may
name a previous response and apply an addition or relationship change to
it; untouched objects keep that response's values.

The vocabulary (class list, predicate list, box-normalization stats, CLIP
text features) comes from the dataset root the model was trained on.

JAX compiles one sampler program per (rows, manip) variant and `warmup`
compiles the ladder ahead of time.  PyTorch runs eagerly, so here a variant
is a shape the card has run: `warmup` runs one layout-denoiser call, one
shape-denoiser call and one decode chunk at each (rows, manip) of the
ladder, so that the kernel modules are loaded, cuDNN has picked its
algorithms and the caching allocator has grown before the first request.

With `dp_devices` N > 1 (or an explicit `devices` list, which may repeat a
device) the request groups of one `generate` call go to
`parallel.dp.DPSampler` N at a time, one group a device, concurrently (JAX
spreads them over a ('data',) mesh, service.py:202-215, 472-535): a call
that changes the manipulation flag flushes the groups before it, and each
call draws one generator a group from the service's generator, in group
order, so that every group takes the seed the single-device service's
dispatch of that group takes.  A call of fewer groups than devices runs
only those (JAX pads it with repeats, which its shard_map needs).  Warmup
runs the ladder on every device's replica.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.boxes import descale_box_params
from ..data.clip_text import ClipTextEncoder
from ..data.collate import collate_scenes
from ..data.sgfront import SceneExample
from ..models.sgdiff import compact_graph, shape_row_capacity


def request_to_example(req: Dict[str, Any], classes: Dict[str, int],
                       rel_dict: Dict[str, int], clip: ClipTextEncoder,
                       use_scene_rels: bool = True,
                       request_id: str = "request",
                       manipulation: Optional[Dict[str, Any]] = None
                       ) -> SceneExample:
    """Build a SceneExample from a user request.

    req = {"objects": ["bed", "wardrobe", ...],
           "triples": [[0, "left", 1], ...]}          (predicate by name)

    As the dataset builds a scene graph (data/sgfront.py): the scene root
    node appended with 'in' edges, CLIP text features per node and per
    relation phrase.

    `manipulation` makes the example a paired encoder / decoder view, the
    sample_with_changes / _additions semantics (model/EchoScene.py:422-532,
    as data/sgfront.py's eval-mode manipulation):
      {"type": "addition", "object": "lamp",
       "triples": [[-1, "left", 0], ...]}   # -1 = the added node
        -> the decoder holds the new node (change-flagged); the encoder
           view masks it and its edges out,
      {"type": "relationship", "index": k, "predicate": "left"}
        -> the decoder gets the new predicate on user triple k (and its CLIP
           phrase re-encoded); the encoder keeps the original; both
           endpoints are change-flagged.
    """
    names = [str(o) for o in req.get("objects", [])]
    added_idx = changed_idx = None
    if manipulation is not None:
        mtype = manipulation.get("type")
        if mtype == "addition":
            new_name = str(manipulation["object"])
            if new_name not in classes:
                raise KeyError(f"unknown added object class {new_name!r}")
            added_idx = len(names)
            names = names + [new_name]
            req = dict(req)
            extra = []
            for s, p, o in manipulation.get("triples", []):
                s = added_idx if int(s) < 0 else int(s)
                o = added_idx if int(o) < 0 else int(o)
                extra.append([s, p, o])
            req["triples"] = list(req.get("triples", [])) + extra
        elif mtype == "relationship":
            changed_idx = int(manipulation["index"])
            if not (0 <= changed_idx < len(req.get("triples", []))):
                raise IndexError(
                    f"manipulation index {changed_idx} out of range")
            new_pred = str(manipulation["predicate"])
            if new_pred not in rel_dict:
                raise KeyError(f"unknown predicate {new_pred!r}")
        else:
            raise ValueError(f"unknown manipulation type {mtype!r}")
    if not names:
        raise ValueError(f"request {req.get('id', request_id)!r}: "
                         "'objects' must be a non-empty list")
    if not use_scene_rels and not req.get("triples"):
        raise ValueError(f"request {req.get('id', request_id)!r}: at least "
                         "one triple required without scene-root edges")
    unknown = [n for n in names if n not in classes]
    if unknown:
        raise KeyError(f"unknown object classes {unknown}; "
                       f"known: {sorted(classes)[:8]}...")
    cat_ids = [classes[n] for n in names]
    triples: List[List[int]] = []
    words: List[str] = []
    for s, p, o in req.get("triples", []):
        s, o = int(s), int(o)
        if not (0 <= s < len(names) and 0 <= o < len(names)):
            raise IndexError(f"triple ({s},{p},{o}) out of range")
        if p not in rel_dict:
            raise KeyError(f"unknown predicate {p!r}; known: {sorted(rel_dict)}")
        triples.append([s, rel_dict[p], o])
        words.append(f"{names[s]} {p} {names[o]}")
    node_texts = list(names)
    if use_scene_rels:
        scene_idx = len(cat_ids)
        for i, nm in enumerate(names):
            triples.append([i, 0, scene_idx])
            words.append(f"{nm} in room")
        cat_ids.append(0)
        node_texts.append("room")
    n, t = len(cat_ids), len(triples)
    tri = np.asarray(triples, np.int32)
    enc_tri = tri.copy()
    enc_words = list(words)
    enc_node_mask = np.ones(n, np.float32)
    enc_triple_mask = np.ones(t, np.float32)
    change_flags = np.zeros(n, np.float32)
    mtype = "none"
    if added_idx is not None:
        # eval-mode addition (data/sgfront.py): the encoder never sees the
        # new node or any edge touching it
        mtype = "addition"
        enc_node_mask[added_idx] = 0.0
        change_flags[added_idx] = 1.0
        touching = (tri[:, 0] == added_idx) | (tri[:, 2] == added_idx)
        enc_triple_mask[touching] = 0.0
    elif changed_idx is not None:
        # eval-mode relationship change: the DECODER side gets the new
        # predicate and re-encoded phrase; the encoder keeps the old one
        mtype = "relationship"
        new_pred = str(manipulation["predicate"])
        s, _, o = tri[changed_idx]
        tri[changed_idx, 1] = rel_dict[new_pred]
        words[changed_idx] = f"{names[int(s)]} {new_pred} {names[int(o)]}"
        change_flags[int(s)] = 1.0
        change_flags[int(o)] = 1.0
    return SceneExample(
        scan_id=str(req.get("id", request_id)),
        objs=np.asarray(cat_ids, np.int32),
        objs_grained=np.asarray(cat_ids, np.int32),
        triples=tri,
        boxes=np.full((n, 7), -1.0, np.float32),   # no GT at serve time
        text_feats=clip.encode_many(node_texts),
        rel_feats=clip.encode_many(words),
        enc_triples=enc_tri,
        enc_rel_feats=clip.encode_many(enc_words),
        enc_node_mask=enc_node_mask,
        enc_triple_mask=enc_triple_mask,
        change_flags=change_flags,
        manipulation_type=mtype,
    )


class GenerationService:
    """Owns an SGDiff and turns request dicts into scene outputs.

    It draws each dispatch's noise from a `torch.Generator` on the model's
    device, seeded from `seed` and advanced once per dispatch (JAX splits
    its key once per dispatch), so two services with one seed and one model
    answer the same requests with the same bits."""

    def __init__(self, sg, spec, stats, classes: Dict[str, int],
                 rel_dict: Dict[str, int],
                 clip: Optional[ClipTextEncoder] = None,
                 gen_shape: bool = True, return_meshes: bool = False,
                 use_scene_rels: bool = True, seed: int = 0,
                 result_format: str = "json", dp_devices: int = 1,
                 row_buckets: Optional[Sequence[int]] = None,
                 devices: Optional[Sequence] = None):
        if result_format not in ("json", "arrays"):
            raise ValueError(f"result_format must be json|arrays, got "
                             f"{result_format!r}")
        self.dp_sampler = None
        if int(dp_devices) > 1 or devices is not None:
            from ..parallel.dp import DPSampler
            from ..parallel.mesh import resolve_devices
            self.dp_sampler = DPSampler(sg, resolve_devices(
                None if devices is not None else dp_devices, devices))
        self.sg = sg
        self.spec = spec
        self.stats = stats
        self.classes = classes
        self.rel_dict = rel_dict
        self.clip = clip or ClipTextEncoder("auto")
        self.gen_shape = gen_shape
        self.return_meshes = return_meshes
        # "json": big payloads (sdfs / meshes) as nested Python lists, ready
        # for json.dumps.  "arrays": numpy f32 / int32 arrays, the format a
        # binary serializer takes.  Boxes and angles stay lists in both (the
        # splice store writes into them).
        self.result_format = result_format
        self.use_scene_rels = use_scene_rels
        self._generator = torch.Generator(device=sg.device).manual_seed(seed)
        # `row_buckets` pins the chains' row count to a coarse ladder (e.g.
        # (16, 32, 48)), so that the shapes the card runs are few and
        # `warmup` can run each of them before the first request
        self.row_buckets = tuple(sorted(int(r) for r in row_buckets)) \
            if row_buckets else None
        if self.row_buckets and self.row_buckets[-1] < spec.max_nodes:
            self.row_buckets = self.row_buckets + (spec.max_nodes,)
        self._variants = set()   # (rows, manip) run so far
        # previous-response store for manipulation requests
        # (sample_with_changes / _additions, model/EchoScene.py:422-532)
        self._store: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._store_cap = 256

    # ------------------------------------------------------------------
    def _rows(self, batch) -> int:
        """Row count of both chains for a batch, bucket-pinned when
        row_buckets is set."""
        rows = shape_row_capacity(batch)
        if self.row_buckets:
            for b in self.row_buckets:
                if b >= rows:
                    return min(b, self.spec.max_nodes)
            return self.spec.max_nodes
        return rows

    def _dummy_batch(self):
        """A one-object collated batch: the same padded shapes as any real
        one (they are fixed by the CollateSpec)."""
        name = next(iter(self.classes))
        ex = request_to_example({"objects": [name]}, self.classes,
                                self.rel_dict, self.clip,
                                use_scene_rels=self.use_scene_rels)
        return collate_scenes([ex], self.spec)

    def compiled_variants(self):
        """The (rows, manip) variants warmed or run so far (JAX's compiled
        sampler variants; here the shapes the card has run)."""
        return sorted(self._variants)

    @torch.no_grad()
    def _warm(self, model, batch, rows: int, manip: bool, dev) -> None:
        """One layout-denoiser call, one shape-denoiser call and one decode
        chunk at `rows` rows, on zeros, on `dev`."""
        sg = self.sg
        cfg = sg.cfg
        change = torch.zeros((batch.num_nodes, cfg.embedding_dim), device=dev)
        ctx = model.encode_context(batch, change,
                                   manip and not cfg.replace_latent)
        triples, obj_mask, tri_mask = compact_graph(batch, rows)
        t = torch.zeros((rows,), dtype=torch.long, device=dev)
        model.layout_eps(
            torch.zeros((rows, cfg.layout_denoiser.in_channels), device=dev),
            t, ctx["obj_embed"][:rows], triples, obj_mask, tri_mask)
        if self.gen_shape and sg.is_echoscene:
            sb = cfg.shape_branch
            r, zc = sb.denoiser.image_size, sb.vqvae.embed_dim
            z = torch.zeros((rows, r, r, r, zc), device=dev)
            model.shape_eps(z, t, ctx["uc_s"][:rows, None, :], triples,
                            obj_mask, tri_mask)
            chunk = torch.zeros((8, r, r, r, zc), device=dev)
            model.decode_latent(chunk)

    def warmup(self, manips=(False, True), verbose: bool = True) -> int:
        """Run every (rows, manip) variant of the ladder once (`_warm`), on
        every device's replica under data parallelism, so that no request
        is the first to run its shapes.  The ladder is the bucket list with
        row_buckets set, otherwise every multiple of 4 up to max_nodes.
        Returns the number of variants warmed."""
        ladder = list(self.row_buckets) if self.row_buckets else \
            list(range(4, self.spec.max_nodes + 1, 4))
        if self.spec.max_nodes not in ladder:
            ladder.append(self.spec.max_nodes)
        if self.dp_sampler is None:
            replicas = {self.sg.device: self.sg.inference_module()}
        else:
            replicas = self.dp_sampler.models
        batch = self._dummy_batch()
        done = 0
        for manip in manips:
            for rows in ladder:
                t0 = time.perf_counter()
                fresh = (rows, manip) not in self._variants
                for dev, model in replicas.items():
                    self._warm(model, batch.to(dev), rows, manip, dev)
                self._variants.add((rows, manip))
                done += 1
                if verbose and fresh:
                    print(f"[serve] warmup ({rows} rows, manip={manip}): "
                          f"{time.perf_counter() - t0:.2f}s")
        return done

    def _sample(self, batch, rows: int, manip: bool) -> Dict[str, np.ndarray]:
        """One generation call on a collated group -> host f32 arrays."""
        self._variants.add((rows, manip))
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._generator,
                                 device=self._generator.device).item())
        gen = torch.Generator(device=self.sg.device).manual_seed(seed)
        out = self.sg.sample_fn(batch.to(self.sg.device), gen,
                                gen_shape=self.gen_shape,
                                with_manipulation=manip, shape_rows=rows)
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def _sample_dp(self, batches, manip: bool) -> Dict[str, np.ndarray]:
        """One data-parallel call on up to one collated group a device ->
        host f32 arrays with a leading group axis."""
        rows = max(self._rows(b) for b in batches)
        self._variants.add((rows, manip))
        return self.dp_sampler(batches,
                               self.dp_sampler.generators(self._generator,
                                                          len(batches)),
                               gen_shape=self.gen_shape,
                               with_manipulation=manip, shape_rows=rows)

    # ------------------------------------------------------------------
    def _scene_result(self, ex: SceneExample, out_slice) -> Dict[str, Any]:
        n_real = ex.num_nodes - (1 if self.use_scene_rels else 0)
        boxes6 = descale_box_params(
            np.concatenate([out_slice["sizes"], out_slice["translations"]],
                           -1), self.stats)
        res: Dict[str, Any] = {
            "id": ex.scan_id,
            "sizes": boxes6[:n_real, :3].tolist(),
            "translations": boxes6[:n_real, 3:6].tolist(),
            "angles": out_slice["angles"][:n_real, 0].tolist(),
        }
        shapes = out_slice.get("shapes")
        if shapes is not None:
            as_json = self.result_format == "json"
            sdfs = np.asarray(shapes[:n_real, ..., 0], np.float32)
            if self.return_meshes:
                from ..eval.render import (fit_verts_to_box,
                                           sdf_to_canonical_mesh)
                meshes = []
                for i in range(n_real):
                    verts, faces = sdf_to_canonical_mesh(sdfs[i])
                    if len(verts):
                        box7 = np.concatenate(
                            [boxes6[i], [out_slice["angles"][i, 0]]])
                        verts = fit_verts_to_box(verts, box7)
                    verts = np.asarray(verts, np.float32)
                    faces = np.asarray(faces, np.int32)
                    meshes.append(
                        {"vertices": verts.tolist() if as_json else verts,
                         "faces": faces.tolist() if as_json else faces})
                res["meshes"] = meshes
            else:
                res["sdf_shape"] = list(sdfs.shape)
                res["sdfs"] = sdfs.tolist() if as_json else sdfs
        return res

    @staticmethod
    def effective_request(base: Dict[str, Any],
                          manip: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        """The scene graph after the manipulation, as a plain request dict:
        what is stored, so that manipulations chain."""
        out = {"objects": list(base.get("objects", [])),
               "triples": [list(t) for t in base.get("triples", [])]}
        if manip is None:
            return out
        if manip.get("type") == "addition":
            new_idx = len(out["objects"])
            out["objects"].append(str(manip["object"]))
            for s, p, o in manip.get("triples", []):
                s = new_idx if int(s) < 0 else int(s)
                o = new_idx if int(o) < 0 else int(o)
                out["triples"].append([s, p, o])
        elif manip.get("type") == "relationship":
            out["triples"][int(manip["index"])][1] = str(manip["predicate"])
        return out

    def _remember(self, effective_req: Dict[str, Any],
                  result: Dict[str, Any]) -> None:
        self._store[str(result["id"])] = {"request": effective_req,
                                          "result": result}
        self._store.move_to_end(str(result["id"]))
        while len(self._store) > self._store_cap:
            self._store.popitem(last=False)

    @staticmethod
    def _splice_previous(res: Dict[str, Any], prev: Dict[str, Any],
                         keep) -> None:
        """Untouched nodes keep the previous response's values, the keep-mask
        contract (eval_3dfront.py:192-202 keeps GT boxes where keep == 1)."""
        for j, k in enumerate(keep):
            if k != 1.0 or j >= len(prev.get("sizes", [])):
                continue
            for field in ("sizes", "translations", "angles"):
                if field in res and field in prev:
                    res[field][j] = prev[field][j]
            for field in ("sdfs", "meshes"):
                if field in res and field in prev and j < len(prev[field]):
                    res[field][j] = prev[field][j]

    def generate(self, requests: Sequence[Dict[str, Any]]
                 ) -> List[Dict[str, Any]]:
        """Group the requests into padded generation calls; returns one
        result per request, in order.

        A request may name a PREVIOUS response and apply a manipulation
        (the serving form of sample_with_changes / _additions):
          {"previous": "<result id>",
           "manipulation": {"type": "addition", "object": "lamp",
                            "triples": [[-1, "left", 0]]}}
          {"previous": "<result id>",
           "manipulation": {"type": "relationship", "index": 0,
                            "predicate": "right"}}
        Untouched nodes keep the previous response's boxes and shapes (the
        keep mask, EchoScene.py:465-471); only change-flagged nodes are
        sampled anew.  `manipulation` without `previous` also works (no
        splice source).  Every request is validated before the first
        generation call."""
        examples, manips, prevs = [], [], []
        for i, r in enumerate(requests):
            manip = r.get("manipulation")
            prev_res = None
            if r.get("previous") is not None:
                stored = self._store.get(str(r["previous"]))
                if stored is None:
                    raise KeyError(
                        f"unknown previous response id {r['previous']!r}")
                base = dict(stored["request"])
                base["id"] = r.get("id", f"req{i}")
                prev_res = stored["result"]
            else:
                base = r
            examples.append(request_to_example(
                base, self.classes, self.rel_dict, self.clip,
                use_scene_rels=self.use_scene_rels, request_id=f"req{i}",
                manipulation=manip))
            manips.append(manip is not None)
            prevs.append(prev_res)
        req_effective = [
            self.effective_request(
                dict(self._store[str(r["previous"])]["request"])
                if r.get("previous") is not None else r,
                r.get("manipulation"))
            for r in requests]
        for e in examples:
            if (e.num_nodes > self.spec.max_nodes
                    or len(e.triples) > self.spec.max_triples):
                raise ValueError(
                    f"request {e.scan_id} exceeds capacity "
                    f"({e.num_nodes} nodes / {len(e.triples)} triples vs "
                    f"{self.spec.max_nodes}/{self.spec.max_triples})")
        results: List[Optional[Dict[str, Any]]] = [None] * len(examples)

        # split the request stream into padded-bucket groups
        groups: List[Any] = []          # (group examples, their indices, manip)
        idx = 0
        while idx < len(examples):
            group, gidx, nn, tt = [], [], 0, 0
            manip_flag = manips[idx]
            while idx < len(examples):
                e = examples[idx]
                # manipulated and plain scenes never share a batch: the
                # manipulation path splices encoder latents, which is a
                # no-op for unflagged scenes only under replace_latent
                if (group and (nn + e.num_nodes > self.spec.max_nodes
                               or tt + len(e.triples) > self.spec.max_triples
                               or len(group) >= self.spec.max_scenes
                               or manips[idx] != manip_flag)):
                    break
                group.append(e)
                gidx.append(idx)
                nn += e.num_nodes
                tt += len(e.triples)
                idx += 1
            groups.append((group, gidx, manip_flag))

        def finish(group, gidx, out):
            off = 0
            for e, i in zip(group, gidx):
                n = e.num_nodes
                res = self._scene_result(
                    e, {k: v[off:off + n] for k, v in out.items()})
                off += n
                if manips[i]:
                    n_real = e.num_nodes - (1 if self.use_scene_rels else 0)
                    keep = (1.0 - e.change_flags[:n_real]).tolist()
                    res["keep"] = keep
                    res["manipulation"] = e.manipulation_type
                    if prevs[i] is not None:
                        self._splice_previous(res, prevs[i], keep)
                results[i] = res
                self._remember(req_effective[i], res)

        pending: List[Any] = []   # (group, gidx, batch) awaiting a dp call
        pending_manip = False       # one dp call runs one manipulation flag

        def flush_dp():
            if pending:
                out = self._sample_dp([b for _, _, b in pending],
                                      pending_manip)
                for d, (group, gidx, _) in enumerate(pending):
                    finish(group, gidx, {k: v[d] for k, v in out.items()})
                pending.clear()

        for group, gidx, manip_flag in groups:
            batch = collate_scenes(group, self.spec)
            if self.dp_sampler is None:
                finish(group, gidx,
                       self._sample(batch, self._rows(batch), manip_flag))
                continue
            if manip_flag != pending_manip:
                flush_dp()
                pending_manip = manip_flag
            pending.append((group, gidx, batch))
            if len(pending) == len(self.dp_sampler.devices):
                flush_dp()
        flush_dp()
        # every request slot is filled exactly once: a grouping fault fails
        # loudly instead of dropping a scene
        missing = [i for i, r in enumerate(results) if r is None]
        if missing:
            raise RuntimeError(f"unfilled request slots {missing}")
        return results


def service_from_experiment(exp: str, dataset: Optional[str] = None,
                            epoch: Optional[int] = None,
                            gen_shape: bool = True,
                            return_meshes: bool = False,
                            max_nodes: int = 48, max_triples: int = 160,
                            max_scenes: int = 8,
                            sample_dtype: Optional[str] = None,
                            layout_sampler: Optional[str] = None,
                            layout_steps: int = 0,
                            shape_sampler: Optional[str] = None,
                            shape_steps: int = 0,
                            result_format: str = "json",
                            dp_devices: int = 1, row_buckets=None,
                            device="cuda") -> GenerationService:
    """Rebuild the model from an experiment directory (the args.json
    contract of the eval CLI) on `device` and wrap it in a
    GenerationService.  `epoch=None` serves the latest checkpoint and
    raises if there is none; `epoch=-1` serves fresh weights drawn from
    seed 0, with a warning."""
    import json
    import os

    from ..data.collate import CollateSpec
    from ..data.sgfront import SGFrontDataset
    from ..models.config import load_config
    from ..models.sgdiff import SGDiff
    from ..train.checkpoint import latest_epoch, restore_for_inference

    with open(os.path.join(exp, "args.json")) as f:
        margs = json.load(f)
    clip = ClipTextEncoder(margs.get("clip_backend", "hash"))
    ds = SGFrontDataset(
        root=dataset or margs["dataset"], split="test",
        room_type=margs["room_type"], shuffle_objs=False, use_sdf=False,
        use_scene_rels=margs["use_scene_rels"], with_changes=False,
        large=margs["large"], clip=clip, seed=0,
        sdf_res=margs.get("sdf_res", 64))
    cfg = load_config(margs["diff_yaml"], network_type=margs["network_type"],
                      with_clip=margs["with_CLIP"])
    cfg.replace_latent = margs["replace_latent"]
    cfg.residual = margs["residual"]
    cfg.layout_diffusion.train_stats_file = ds.box_stats_path
    if sample_dtype:
        cfg.sample_dtype = sample_dtype
    if layout_sampler:
        cfg.layout_diffusion.sampler = layout_sampler
    if layout_steps:
        cfg.layout_diffusion.sample_steps = layout_steps
    if shape_sampler:
        cfg.shape_branch.sampler = shape_sampler
    if shape_steps:
        cfg.shape_branch.ddim_steps = shape_steps

    spec = CollateSpec(max_nodes=max_nodes, max_triples=max_triples,
                       max_scenes=max_scenes, diffusion_bs=max_nodes,
                       with_sdf=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        sg = SGDiff(cfg, num_objs=len(ds.classes),
                    num_preds=len(ds.pred_names), device=device,
                    iou_stats=ds.box_stats)
    if epoch is None:
        epoch = latest_epoch(exp)
        if epoch < 0:
            raise FileNotFoundError(
                f"no checkpoint found under {os.path.join(exp, 'checkpoint')}"
                "; refusing to serve uninitialized params (pass --epoch -1 "
                "to override for smoke testing)")
    if epoch >= 0:
        restore_for_inference(
            os.path.join(exp, "checkpoint", f"model{epoch}"), sg.module)
    else:
        print("[serve] WARNING: --epoch -1 — serving UNRESTORED random "
              "params; outputs are garbage. Train or pass a checkpoint epoch.")
    return GenerationService(sg, spec, ds.box_stats, ds.classes, ds.rel_dict,
                             clip=clip, gen_shape=gen_shape,
                             return_meshes=return_meshes,
                             use_scene_rels=margs["use_scene_rels"],
                             result_format=result_format,
                             dp_devices=dp_devices, row_buckets=row_buckets)
