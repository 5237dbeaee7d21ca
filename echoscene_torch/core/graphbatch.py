"""Fixed-shape, mask-padded scene-graph batches as torch dataclasses.

Port of echoscene_tpu/core/graphbatch.py; the conventions are the same:
  * scenes are flat-concatenated with global node indices, padded to static
    (N, T) capacities; encoder and decoder views share the decoder's node
    indexing,
  * padded node slots have obj_mask == 0, category 0 and
    obj_to_scene == num_scenes (a "ghost scene"),
  * padded triple slots have triple_mask == 0 and endpoints at node 0,
  * nodes are ordered scene-major with all padding at the global tail, so
    the real nodes are a prefix and sampling can run over that prefix only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _to(x, device):
    return None if x is None else x.to(device)


@dataclasses.dataclass
class GraphBatch:
    """One graph view (encoder or decoder) over the flat node axis."""
    objs: torch.Tensor            # long[N] coarse category ids
    triples: torch.Tensor         # long[T, 3] (subject, predicate, object)
    obj_mask: torch.Tensor        # f32[N] 1 = real node
    triple_mask: torch.Tensor     # f32[T] 1 = real edge
    text_feats: Optional[torch.Tensor] = None   # f32[N, 512] per-node CLIP
    rel_feats: Optional[torch.Tensor] = None    # f32[T, 512] per-edge CLIP

    @property
    def num_nodes(self) -> int:
        return self.objs.shape[0]

    @property
    def num_triples(self) -> int:
        return self.triples.shape[0]

    def edges(self) -> torch.Tensor:
        """long[T, 2] (s, o) endpoints."""
        return self.triples[:, [0, 2]]

    def preds(self) -> torch.Tensor:
        return self.triples[:, 1]

    def to(self, device) -> "GraphBatch":
        return GraphBatch(*(_to(getattr(self, f.name), device)
                            for f in dataclasses.fields(self)))


@dataclasses.dataclass
class ShapeSelection:
    """Shape-branch object sub-batch (greedy prefix or host-selected rows);
    see echoscene_tpu/core/graphbatch.py ShapeSelection."""
    sdf: Optional[torch.Tensor]          # f32[M, R, R, R, 1] SDF grids
    num_valid: torch.Tensor              # long[] real sub-batch slots
    latent: Optional[torch.Tensor] = None   # f32[M, r, r, r, z]
    indices: Optional[torch.Tensor] = None  # long[M] node slot per row
    mp_valid: bool = True

    @property
    def capacity(self) -> int:
        src = self.sdf if self.sdf is not None else self.latent
        return src.shape[0]

    def mask(self) -> torch.Tensor:
        """f32[M] 1 for the real sub-batch slots."""
        return (torch.arange(self.capacity, device=self.num_valid.device)
                < self.num_valid).float()

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This sub-batch's rows of a per-node array."""
        if self.indices is None:
            return x[:self.capacity]
        return x[self.indices]

    def to(self, device) -> "ShapeSelection":
        return ShapeSelection(_to(self.sdf, device), _to(self.num_valid, device),
                              _to(self.latent, device), _to(self.indices, device),
                              self.mp_valid)


@dataclasses.dataclass
class SceneBatch:
    """Paired encoder/decoder graph views plus targets and manipulation
    bookkeeping (train_3dfront.parse_data of the reference)."""
    enc: GraphBatch
    dec: GraphBatch
    objs_grained: torch.Tensor     # long[N]
    obj_to_scene: torch.Tensor     # long[N]; padded slots -> num_scenes
    triple_to_scene: torch.Tensor  # long[T]
    boxes: torch.Tensor            # f32[N, 7] scaled boxes, raw angle last
    change_flags: torch.Tensor     # f32[N] 1 = node added/manipulated
    enc_obj_mask: torch.Tensor     # f32[N] 1 = node exists in encoder view
    num_scenes: int = 1
    shapes: Optional[ShapeSelection] = None

    @property
    def num_nodes(self) -> int:
        return self.boxes.shape[0]

    def scene_one_hot(self) -> torch.Tensor:
        """f32[N, S] scene membership (padded nodes map to no scene)."""
        scenes = torch.arange(self.num_scenes, device=self.obj_to_scene.device)
        return (self.obj_to_scene[:, None] == scenes[None, :]).float()

    def same_scene_matrix(self) -> torch.Tensor:
        """f32[N, N] 1 where two real nodes share a scene, diagonal zeroed
        (the IoU collision loss's pair mask, diffusion_ddpm.py:412-418)."""
        same = self.obj_to_scene[:, None] == self.obj_to_scene[None, :]
        real = self.dec.obj_mask[:, None] * self.dec.obj_mask[None, :] > 0
        n = self.num_nodes
        eye = torch.eye(n, device=same.device)
        return (same & real).float() * (1.0 - eye)

    def to(self, device) -> "SceneBatch":
        return SceneBatch(
            self.enc.to(device), self.dec.to(device),
            self.objs_grained.to(device), self.obj_to_scene.to(device),
            self.triple_to_scene.to(device), self.boxes.to(device),
            self.change_flags.to(device), self.enc_obj_mask.to(device),
            self.num_scenes,
            None if self.shapes is None else self.shapes.to(device))
