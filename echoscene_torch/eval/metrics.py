"""Scene-graph constraint metrics over generated layouts.

Port of echoscene_tpu/eval/metrics.py (reference helpers/metrics_3dfront.py:
57-433), host numpy.  Geometric rule check of every predicted relation:
  left/right:   z-gap beyond +-0.05 AND (strict) top-down obb IoU <= 0.3,
  front/behind: x-gap beyond +-0.05 AND the same overlap veto,
  bigger/smaller: +-15% relative volume,
  taller/shorter: +-10% relative absolute height (y + h),
  standing on:  |y_s - y_o| < 0.04,
  close by:     min corner-to-corner distance <= 0.45,
  symmetrical:  any axis-flip of the subject's (x, z) lands within 0.45 of the
                object's (x, z).
Boxes are world-unit [l, h, w, x, y, z(, angle)] with (x, y, z) the bottom
center.  The `_changes` variant scores only triples touching changed nodes
(keep == 0); the plain variant only triples whose endpoints are both kept.
The top-down IoU is Sutherland-Hodgman clipping + the shoelace area
(metrics_3dfront.py:367-433), over the min volume (:362).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

RELATION_KEYS = ["left", "right", "front", "behind", "bigger", "smaller",
                 "taller", "shorter", "standing on", "close by",
                 "symmetrical to", "total"]


def new_accuracy_dict() -> Dict[str, List[int]]:
    return {k: [] for k in RELATION_KEYS}


def corners_from_box(box: np.ndarray, with_translation: bool = False) -> np.ndarray:
    """(8,3) corners; box = [l, h, w, x, y, z(, angle)], bottom-center origin
    (metrics_3dfront.py:308-328)."""
    l, h, w = box[0], box[1], box[2]
    tx, ty, tz = (box[3], box[4], box[5]) if with_translation else (0, 0, 0)
    x = np.array([w / 2, w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2])
    y = np.array([h, h, h, h, 0, 0, 0, 0], dtype=np.float64)
    z = np.array([l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2, l / 2])
    return np.stack([x + tx, y + ty, z + tz], axis=1)


def _poly_area(x, y):
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def _polygon_clip(subject, clip):
    """Sutherland–Hodgman (metrics_3dfront.py:390-433)."""
    def inside(p, cp1, cp2):
        return ((cp2[0] - cp1[0]) * (p[1] - cp1[1])
                > (cp2[1] - cp1[1]) * (p[0] - cp1[0]))

    def intersect(cp1, cp2, s, e):
        dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
        dp = (s[0] - e[0], s[1] - e[1])
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
        n2 = s[0] * e[1] - s[1] * e[0]
        denom = dc[0] * dp[1] - dc[1] * dp[0]
        if denom == 0:
            return [e[0], e[1]]
        n3 = 1.0 / denom
        return [(n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3]

    output = list(subject)
    cp1 = clip[-1]
    for cp2 in clip:
        if not output:
            return None
        inputs = output
        output = []
        s = inputs[-1]
        for e in inputs:
            if inside(e, cp1, cp2):
                if not inside(s, cp1, cp2):
                    output.append(intersect(cp1, cp2, s, e))
                output.append(e)
            elif inside(s, cp1, cp2):
                output.append(intersect(cp1, cp2, s, e))
            s = e
        cp1 = cp2
    return output if output else None


def _convex_hull_area(points) -> float:
    from scipy.spatial import ConvexHull, QhullError
    try:
        return float(ConvexHull(points).volume)  # 2D hull: volume == area
    except (QhullError, ValueError):
        # fewer than 3 points or a degenerate (collinear) clip: no area
        return 0.0


def box3d_iou(box1: np.ndarray, box2: np.ndarray,
              with_translation: bool = False):
    """Top-down clipped-polygon IoU + volume IoU over MIN volume
    (metrics_3dfront.py:331-364)."""
    c1 = corners_from_box(box1, with_translation)
    c2 = corners_from_box(box2, with_translation)
    rect1 = [(c1[i, 2], c1[i, 0]) for i in range(4)]
    rect2 = [(c2[i, 2], c2[i, 0]) for i in range(4)]
    area1 = _poly_area(np.array(rect1)[:, 0], np.array(rect1)[:, 1])
    area2 = _poly_area(np.array(rect2)[:, 0], np.array(rect2)[:, 1])
    inter_p = _polygon_clip(rect1, rect2)
    inter_area = _convex_hull_area(inter_p) if inter_p else 0.0
    denom = area1 + area2 - inter_area
    iou_2d = inter_area / denom if denom > 0 else 0.0
    ymax = min(c1[0, 1], c2[0, 1])
    ymin = max(c1[4, 1], c2[4, 1])
    inter_vol = inter_area * max(0.0, ymax - ymin)
    vol = lambda c: (np.linalg.norm(c[0] - c[1]) * np.linalg.norm(c[1] - c[2])
                     * np.linalg.norm(c[0] - c[4]))
    volmin = min(vol(c1), vol(c2))
    iou = inter_vol / volmin if volmin > 0 else 0.0
    return iou, iou_2d


def _close_dis(c1, c2) -> float:
    d = (-2 * c1 @ c2.T + np.sum(c1 ** 2, -1)[:, None]
         + np.sum(c2 ** 2, -1)[None, :])
    return float(np.sqrt(np.maximum(d, 0)).min())


def _check(pred_name: str, box_s, box_o, strict: bool,
           overlap_threshold: float) -> Optional[int]:
    """Returns 1/0 for scored predicates, None for unscored ones."""
    overlap = lambda: box3d_iou(box_s, box_o, with_translation=True)[0]
    if pred_name == "left":
        bad = box_s[5] - box_o[5] > -0.05 or (strict and overlap() > overlap_threshold)
        return 0 if bad else 1
    if pred_name == "right":
        bad = box_s[5] - box_o[5] < 0.05 or (strict and overlap() > overlap_threshold)
        return 0 if bad else 1
    if pred_name == "front":
        bad = box_s[3] - box_o[3] < -0.05 or (strict and overlap() > overlap_threshold)
        return 0 if bad else 1
    if pred_name == "behind":
        bad = box_s[3] - box_o[3] > 0.05 or (strict and overlap() > overlap_threshold)
        return 0 if bad else 1
    if pred_name == "bigger than":
        vs = box_s[0] * box_s[1] * box_s[2]
        vo = box_o[0] * box_o[1] * box_o[2]
        return 0 if (vs - vo) / vs < 0.15 else 1
    if pred_name == "smaller than":
        vs = box_s[0] * box_s[1] * box_s[2]
        vo = box_o[0] * box_o[1] * box_o[2]
        return 0 if (vs - vo) / vs > -0.15 else 1
    if pred_name == "taller than":
        hs, ho = box_s[4] + box_s[1], box_o[4] + box_o[1]
        return 0 if (hs - ho) / hs < 0.1 else 1
    if pred_name == "shorter than":
        hs, ho = box_s[4] + box_s[1], box_o[4] + box_o[1]
        return 0 if (hs - ho) / hs > -0.1 else 1
    if pred_name == "standing on":
        return 1 if abs(box_s[4] - box_o[4]) < 0.04 else 0
    if pred_name == "close by":
        cs = corners_from_box(box_s, with_translation=True)
        co = corners_from_box(box_o, with_translation=True)
        return 0 if _close_dis(cs, co) > 0.45 else 1
    if pred_name == "symmetrical to":
        flips = ([-box_s[3], box_s[5]], [box_s[3], -box_s[5]],
                 [-box_s[3], -box_s[5]])
        oc = np.array([box_o[3], box_o[5]])
        ok = any(np.linalg.norm(np.array(f) - oc) < 0.45 for f in flips)
        return 1 if ok else 0
    return None


_KEY_FOR_PRED = {
    "left": "left", "right": "right", "front": "front", "behind": "behind",
    "bigger than": "bigger", "smaller than": "smaller",
    "taller than": "taller", "shorter than": "shorter",
    "standing on": "standing on", "close by": "close by",
    "symmetrical to": "symmetrical to",
}


def _validate(triples, boxes, keep, pred_names, accuracy, strict,
              overlap_threshold, changes_mode: bool):
    boxes = np.asarray(boxes, np.float64)
    for s, p, o in np.asarray(triples):
        if keep is not None:
            if changes_mode:
                if keep[s] != 0 and keep[o] != 0:
                    continue        # only triples touching changed nodes
            else:
                if not (keep[s] == 1 and keep[o] == 1):
                    continue        # only fully-kept triples
        name = pred_names[int(p)].rstrip("\n")
        res = _check(name, boxes[int(s)], boxes[int(o)], strict,
                     overlap_threshold)
        if res is not None:
            accuracy[_KEY_FOR_PRED[name]].append(res)
            accuracy["total"].append(res)
    return accuracy


def validate_constrains(triples, boxes, keep, pred_names,
                        accuracy=None, strict: bool = True,
                        overlap_threshold: float = 0.3):
    """metrics_3dfront.py:57-179.  boxes: (N, 6/7) world-unit."""
    if accuracy is None:
        accuracy = new_accuracy_dict()
    return _validate(triples, boxes, keep, pred_names, accuracy, strict,
                     overlap_threshold, changes_mode=False)


def validate_constrains_changes(triples, boxes, keep, pred_names,
                                accuracy=None, strict: bool = True,
                                overlap_threshold: float = 0.3):
    """metrics_3dfront.py:181-306."""
    if accuracy is None:
        accuracy = new_accuracy_dict()
    return _validate(triples, boxes, keep, pred_names, accuracy, strict,
                     overlap_threshold, changes_mode=True)


def accuracy_means(accuracy: Dict[str, List[int]]) -> Dict[str, float]:
    return {k: (float(np.mean(v)) if len(v) else float("nan"))
            for k, v in accuracy.items()}


# --- point-cloud overlap (collision) metric --------------------------------
STRUCTURAL_CLASSES = ("floor", "wall", "ceiling", "_scene_")
TOUCHING_PREDS = ("none", "inside", "attached to", "part of", "cover",
                  "belonging to", "build in", "connected to")


def get_rotation_3dfront(y_rad: float) -> np.ndarray:
    """Yaw about +y (helpers/util.py:507-513, radians); a copy of
    echoscene_tpu/eval/render.py:27-30."""
    c, s = np.cos(y_rad), np.sin(y_rad)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float64)


def fit_points_to_box(points: np.ndarray, box7) -> np.ndarray:
    """Scale unit-ish canonical points into a world box (helpers/util.py
    fit_shapes_to_box role for point clouds)."""
    l, h, w, px, py, pz, angle = [float(v) for v in box7]
    p = np.asarray(points, np.float64).copy()
    lo, hi = p.min(0), p.max(0)
    center = (lo + hi) / 2
    center[1] = lo[1]
    p -= center
    ext = p.max(0) - p.min(0)
    ext[ext < 1e-8] = 1.0
    p = p / ext * np.array([w, h, l])
    R_inv = np.linalg.inv(get_rotation_3dfront(angle))
    return (p @ R_inv.T + np.array([px, py, pz])).astype(np.float32)


def pointcloud_overlap_pair(pc1: np.ndarray, pc2: np.ndarray) -> int:
    """#points of pc1 whose nearest OTHER point belongs to pc2
    (metrics_3dfront.py:466-475)."""
    allpc = np.concatenate([pc1, pc2], 0)
    d = (-2 * pc1 @ allpc.T + np.sum(pc1 ** 2, -1)[:, None]
         + np.sum(allpc ** 2, -1)[None, :])
    # first NN is the point itself; take the second-smallest
    idx2 = np.argsort(d, axis=1)[:, 1]
    return int(np.sum(idx2 >= len(pc1)))


def pointcloud_overlap(pclouds, objs, boxes7, triples, class_names,
                       pred_names, overlap_metric: Optional[list] = None):
    """Scene collision metric (metrics_3dfront.py:436-463): for every pair of
    non-structural objects whose relation does not imply touching, fit their
    point clouds into the predicted boxes and count cross-cloud nearest
    neighbours."""
    if overlap_metric is None:
        overlap_metric = []
    pair2pred = {(int(t[0]), int(t[2])): int(t[1]) for t in np.asarray(triples)}
    n = len(pclouds)
    for i in range(n - 1):
        for j in range(i + 1, n):
            ci = class_names[int(objs[i])].rstrip("\n")
            cj = class_names[int(objs[j])].rstrip("\n")
            if ci in STRUCTURAL_CLASSES or cj in STRUCTURAL_CLASSES:
                continue
            pred_ij = pair2pred.get((i, j))
            pred_ji = pair2pred.get((j, i))
            skip = False
            for p in (pred_ij, pred_ji):
                if p is not None and pred_names[p].rstrip("\n") in TOUCHING_PREDS:
                    skip = True
            if skip:
                continue
            pc1 = fit_points_to_box(pclouds[i], boxes7[i])
            pc2 = fit_points_to_box(pclouds[j], boxes7[j])
            overlap_metric.append(pointcloud_overlap_pair(pc1, pc2))
    return overlap_metric
