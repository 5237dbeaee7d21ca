"""Scene-graph visualisation as Graphviz DOT (and a PNG where `dot` exists).

Port of echoscene_tpu/eval/graph_viz.py (reference
helpers/visualize_graph.py:7-93): a digraph of object nodes and predicate
edges, with manipulated nodes and changed edges highlighted; the loaders of
graph json and demo-graph yaml files (helpers/viz_util.py:5-114).  Host code;
`save_dot` renders a PNG only when the graphviz `dot` binary is installed.
"""
from __future__ import annotations

import os
import subprocess
from typing import Optional, Sequence

import numpy as np


def scene_graph_dot(objs: Sequence[int], triples: np.ndarray,
                    class_names: Sequence[str], pred_names: Sequence[str],
                    changed_nodes: Optional[Sequence[int]] = None,
                    changed_triples: Optional[Sequence[int]] = None,
                    title: str = "scene") -> str:
    changed_nodes = set(changed_nodes or [])
    changed_triples = set(changed_triples or [])
    lines = [f'digraph "{title}" {{',
             '  rankdir=LR; node [shape=box, style="rounded,filled"];']
    for i, c in enumerate(objs):
        name = class_names[int(c)].rstrip("\n")
        color = "lightcoral" if i in changed_nodes else "lightsteelblue"
        lines.append(f'  n{i} [label="{name}", fillcolor={color}];')
    for k, (s, p, o) in enumerate(np.asarray(triples)):
        pred = pred_names[int(p)].rstrip("\n")
        style = ' color=red penwidth=2' if k in changed_triples else ""
        lines.append(f'  n{int(s)} -> n{int(o)} [label="{pred}"{style}];')
    lines.append("}")
    return "\n".join(lines)


def load_graph_json(path: str):
    """Scene-graph json loader (helpers/viz_util.py:5-114 role): returns
    (objects {id: name}, triples [[s, pred_name, o], ...])."""
    import json
    with open(path) as f:
        data = json.load(f)
    if "scans" in data:   # relationships_*.json format
        scan = data["scans"][0]
        objects = {int(k): v for k, v in scan["objects"].items()}
        triples = [[r[0], r[3], r[1]] for r in scan["relationships"]]
        return objects, triples
    objects = {int(k): v for k, v in data.get("objects", {}).items()}
    triples = data.get("relationships", data.get("triples", []))
    return objects, triples


def load_scene_graphs_yaml(path: str, with_manipulation: bool = False):
    """Custom demo-graph yaml loader (helpers/viz_util.py:5-72 semantics).

    Input format: {Scenes: {<id>: {nodes: [label, ...],
                                   relships: [[s, o, pred_name], ...],
                                   manipulations: [...]}}}.
    Returns {scene_id: {objects: [label, ...],
                        triples: [[s, pred_name, o], ...],
                        node_mask, edge_mask}} where mask 0 marks
    manipulation-added nodes / changed edges (the reference's highlight
    convention).  Manipulation entries:
      ['chair', 'add', [[2, 'standing on'], [1, 'left']]]  — add node +
          edges FROM the new node to the listed (target, pred) pairs;
      ['', 'rel', [s, o, old, new]]                        — relabel edge;
      ['', 'rel', [s, o, old, [s2, o2, new]]]             — relabel when
          (s2, o2) == (s, o), else replace the edge with (s2, o2, new).
    """
    import yaml
    with open(path) as f:
        graphs = yaml.safe_load(f)
    out = {}
    for scene_id, scene in graphs["Scenes"].items():
        objects = list(scene["nodes"])
        triples = [[r[0], r[2], r[1]] for r in scene["relships"]]
        node_mask = [1] * len(objects)
        edge_mask = [1] * len(triples)
        if with_manipulation:
            for m in scene.get("manipulations", []):
                if m[1] == "add":
                    new_id = len(objects)
                    objects.append(m[0])
                    node_mask.append(0)
                    for target, pred in m[2]:
                        triples.append([new_id, pred, target])
                        edge_mask.append(0)
                elif m[1] == "rel":
                    s, o, old = m[2][0], m[2][1], m[2][2]
                    new = m[2][3]
                    for rid, (ts, pred, to) in enumerate(triples):
                        if (ts, to, pred) != (s, o, old):
                            continue
                        if not isinstance(new, list):
                            triples[rid] = [s, f"{old}->{new}", o]
                            edge_mask[rid] = 0
                        elif (new[0], new[1]) == (s, o):
                            triples[rid] = [s, f"{old}->{new[2]}", o]
                            edge_mask[rid] = 0
                        else:   # overwrite with a brand-new (s, o) pair
                            del triples[rid]
                            del edge_mask[rid]
                            triples.append([new[0], new[2], new[1]])
                            edge_mask.append(0)
                        break
        out[str(scene_id)] = {"objects": objects, "triples": triples,
                              "node_mask": node_mask, "edge_mask": edge_mask}
    return out


def loaded_graph_dot(scene: dict, title: str = "scene") -> str:
    """DOT for a load_scene_graphs_yaml scene (labels instead of class ids;
    mask-0 entries highlighted)."""
    objects, triples = scene["objects"], scene["triples"]
    changed_nodes = {i for i, m in enumerate(scene.get(
        "node_mask", [1] * len(objects))) if m == 0}
    changed_edges = {k for k, m in enumerate(scene.get(
        "edge_mask", [1] * len(triples))) if m == 0}
    # reuse scene_graph_dot: node i's "class" is itself, edge k's "pred id"
    # is k into the per-edge label list
    tri = (np.asarray([[s, k, o] for k, (s, _, o) in enumerate(triples)],
                      np.int64)
           if triples else np.zeros((0, 3), np.int64))
    return scene_graph_dot(
        list(range(len(objects))), tri,
        class_names=[str(x) for x in objects],
        pred_names=[p for _, p, _ in triples] or ["-"],
        changed_nodes=changed_nodes, changed_triples=changed_edges,
        title=title)


def save_dot(dot: str, path: str, render_png: bool = True) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(dot)
    if render_png:
        try:
            subprocess.run(["dot", "-Tpng", path, "-o",
                            os.path.splitext(path)[0] + ".png"],
                           check=True, capture_output=True, timeout=30)
        except (OSError, subprocess.SubprocessError):
            pass  # graphviz binary optional
