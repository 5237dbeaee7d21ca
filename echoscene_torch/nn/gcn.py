"""Triplet scene-graph convolution on mask-padded flat batches.

Port of echoscene_tpu/nn/gcn.py (reference model/graph.py:37-250).  Per layer:
gather subject/object vectors for every triple, run the per-triple MLP net1
on [s, p, o], scatter-pool the new s/o vectors back to their nodes ('sum',
'avg' with counts clamped to >= 1, or 'wAvg' with learned sigmoid weights),
run the node MLP net2, and add the residual projections.  Pooling is JAX's
one-hot matmul: a masked (T, N) one-hot matrix times the values, accumulated
in f32, so padded triples contribute zero rows.  On the card that is one f32
product (TF32 off), which adds in a fixed order and gives the same bits on
every run, where an atomic scatter (`index_add_`) would not.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import Linear
from .mlp import MLP


def scatter_sum(values: torch.Tensor, idx: torch.Tensor,
                mask: Optional[torch.Tensor], num_nodes: int) -> torch.Tensor:
    """sum over t with idx[t] == n and mask[t] == 1 of values[t] -> (N, D),
    as JAX's `scatter_sum_onehot`: onehot^T values with f32 accumulation."""
    nodes = torch.arange(num_nodes, device=idx.device)
    onehot = (idx[:, None] == nodes[None, :]).float()
    if mask is not None:
        onehot = onehot * mask.float()[:, None]
    return (onehot.t() @ values.float()).to(values.dtype)


class WeightNetGCN(nn.Module):
    """Learned scatter weights for 'wAvg' pooling (graph.py:37-86); names
    follow the JAX module's."""

    def __init__(self, obj_dim: int, pred_dim: int, feat_dim: int = 128):
        super().__init__()
        self.down_sample_obj = Linear(obj_dim, feat_dim)
        self.down_sample_obj_o = Linear(obj_dim, feat_dim)
        self.down_sample_pred = Linear(pred_dim, feat_dim)
        self.net_s = nn.Sequential(Linear(3 * feat_dim, 64), nn.ReLU(),
                                   Linear(64, 1), nn.Sigmoid())
        self.net_o = nn.Sequential(Linear(3 * feat_dim, 64), nn.ReLU(),
                                   Linear(64, 1), nn.Sigmoid())

    def forward(self, s, p, o):
        feat = torch.cat([self.down_sample_obj(s), self.down_sample_obj_o(o),
                          self.down_sample_pred(p)], dim=1)
        return self.net_s(feat), self.net_o(feat)


class GraphTripleConv(nn.Module):
    """One scene-graph convolution layer (graph.py:89-211)."""

    def __init__(self, input_dim_obj: int, input_dim_pred: int,
                 output_dim: Optional[int] = None, hidden_dim: int = 512,
                 pooling: str = "avg", mlp_normalization: str = "none",
                 residual: bool = True):
        super().__init__()
        assert pooling in ("sum", "avg", "wAvg"), pooling
        output_dim = output_dim or input_dim_obj
        self.pooling = pooling
        self.residual = residual
        self.hidden_dim = hidden_dim
        self.input_dim_pred = input_dim_pred
        h, dp = hidden_dim, input_dim_pred
        self.net1 = MLP([2 * input_dim_obj + dp, h, 2 * h + dp],
                        batch_norm=mlp_normalization)
        self.net2 = MLP([h, h, output_dim], batch_norm=mlp_normalization)
        if pooling == "wAvg":
            self.weight_net = WeightNetGCN(h, dp)
        if residual:
            self.linear_projection = Linear(input_dim_obj, output_dim)
            self.linear_projection_pred = Linear(dp, dp)

    def forward(self, obj_vecs: torch.Tensor, pred_vecs: torch.Tensor,
                edges: torch.Tensor, obj_mask: Optional[torch.Tensor] = None,
                triple_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = obj_vecs.shape[0]
        h, dp = self.hidden_dim, self.input_dim_pred
        s_idx, o_idx = edges[:, 0], edges[:, 1]
        t_in = torch.cat([obj_vecs[s_idx], pred_vecs.to(obj_vecs.dtype),
                          obj_vecs[o_idx]], dim=1)
        new_t = self.net1(t_in, triple_mask)
        new_s, new_p, new_o = new_t[:, :h], new_t[:, h:h + dp], new_t[:, h + dp:]

        if self.pooling == "wAvg":
            s_w, o_w = self.weight_net(new_s.detach(), new_p.detach(),
                                       new_o.detach())
            new_s, new_o = s_w * new_s, o_w * new_o

        pooled = (scatter_sum(new_s, s_idx, triple_mask, n)
                  + scatter_sum(new_o, o_idx, triple_mask, n))
        if self.pooling == "avg":
            ones = torch.ones(edges.shape[0], 1, device=pooled.device,
                              dtype=pooled.dtype)
            counts = (scatter_sum(ones, s_idx, triple_mask, n)
                      + scatter_sum(ones, o_idx, triple_mask, n))
            pooled = pooled / counts.clamp_min(1.0)
        elif self.pooling == "wAvg":
            wsum = (scatter_sum(s_w, s_idx, triple_mask, n)
                    + scatter_sum(o_w, o_idx, triple_mask, n))
            pooled = pooled / (wsum + 1e-4)

        new_obj = self.net2(pooled, obj_mask)
        if self.residual:
            new_obj = new_obj + self.linear_projection(obj_vecs)
            new_p = new_p + self.linear_projection_pred(pred_vecs)
        return new_obj, new_p


class GraphTripleConvNet(nn.Module):
    """Stack of GraphTripleConv layers; the last may change the width
    (graph.py:214-250).  `input_dim_obj` is the node width of the first
    layer; later layers keep it."""

    def __init__(self, input_dim_obj: int, input_dim_pred: int,
                 num_layers: int = 2, hidden_dim: int = 512,
                 pooling: str = "avg", mlp_normalization: str = "none",
                 residual: bool = False, output_dim: Optional[int] = None):
        super().__init__()
        self.gconvs = nn.ModuleList([
            GraphTripleConv(
                input_dim_obj, input_dim_pred,
                output_dim=output_dim if i == num_layers - 1 else None,
                hidden_dim=hidden_dim, pooling=pooling,
                mlp_normalization=mlp_normalization, residual=residual)
            for i in range(num_layers)])

    def forward(self, obj_vecs, pred_vecs, edges, obj_mask=None,
                triple_mask=None):
        for gconv in self.gconvs:
            obj_vecs, pred_vecs = gconv(obj_vecs, pred_vecs, edges, obj_mask,
                                        triple_mask)
        return obj_vecs, pred_vecs
