"""Tensor parallelism of the shape denoiser (Megatron-style).

Port of `shard_params_for_model_parallel` and `build_dp_tp_sample`
(echoscene_tpu/parallel/dp.py:100-185).  JAX only places the shape UNet's
parameters on a 'model' mesh axis and lets GSPMD insert the collectives;
here each rank of a model group holds its shard of those parameters and
runs the collectives itself, inside the shape denoiser only:

  * each torso ResBlock: `in_layers.2` (JAX's Conv_0) and its bias, the
    time embedding's `emb_layers.1` (Dense_0) and `out_layers.0`'s affine
    (GroupNorm32_1) split on output channels, so the activation between
    the two convolutions is channel-sharded and its GroupNorm statistics
    stay shard-local (every shard holds whole groups); `out_layers.3`
    (Conv_1) splits on input channels, its partial outputs are summed over
    the model group and its bias is added once.  The skip path is
    replicated.
  * each CrossAttention (self-attention and the single-key
    cross-attention, nn/attention.py): `to_q` / `to_k` / `to_v` split on
    heads, `to_out`'s matrix on its input, summed over the group, its bias
    added once.

Two autograd Functions mark a region: on entry the identity forward and a
sum over the model group backward (each rank's sharded branch passes back
its part of the input's gradient), on exit the sum forward and the
identity backward.  The sums run in f32 whatever the activations' dtype.

The sampling twins keep the split.  Under `sample_conv: winograd` the
row-split `out_layers.3` is a WinogradConv3d whose transformed weight `u`
is that of this rank's shard: its partial output (no bias) goes through
`winograd_conv3d` and the exit's f32 sum, the bias added once.  Under
`sample_dtype: int8` it is the row-split `Int8Conv3d` (nn/quant.py), equal
to the unsharded int8 convolution bit for bit through three collectives
over the model group, each of them GSPMD's in JAX: (1) when the twin is
built, a MAX of the per-output-channel weight abs-max over the input
channels (so building the twin of a sharded module is collective: every
rank of the group builds it, in module order); in each forward (2) a MAX
of the activation's abs-max word between Q1's two passes, and (3) a SUM of
Q2's int32 accumulators (exact; they pass f32's exact integers), then one
dequantize with the bias.  The column-split `in_layers.2` needs none: its
input is replicated (every rank computes the whole tensor's scale) and
its per-output-channel weight scales are local to the shard.

A block whose channels, groups or heads the group size does not divide
stays replicated (JAX never shards a dimension `n_model` does not divide,
dp.py:152-159); everything outside the shape denoiser is replicated.

`shard_module_` shards a module in place (its parameters become this
rank's slices; the sharded blocks' classes become the tensor-parallel
ones, which keep the state_dict keys); `split_dims` names the sharded
parameters and their split dimension; `shard_state_dict` /
`gather_shards` convert between a full state_dict and the ranks' shards,
and `gather_state_dict` gathers a sharded module's state over its group,
so checkpoints keep the reference layout.  `global_norm` is the norm of
the logical (unsharded) tensors: the sharded leaves' sums of squares
summed over the group, each replicated leaf counted once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from ..kernels.attention import dot_product_attention
from ..kernels.winograd import winograd_conv3d
from ..models import sgdiff
from ..nn.attention import CrossAttention
from ..nn.blocks import ResBlock, WinogradConv3d, group_norm_act
from ..nn.quant import Int8Conv3d
from .mesh import Mesh, all_gather, all_reduce_

# the split dimension of each sharded parameter, by its key in the block
RES_DIMS = {"in_layers.2.weight": 0, "in_layers.2.bias": 0,
            "emb_layers.1.weight": 0, "emb_layers.1.bias": 0,
            "out_layers.0.weight": 0, "out_layers.0.bias": 0,
            "out_layers.3.weight": 1}
ATTN_DIMS = {"to_q.weight": 0, "to_k.weight": 0, "to_v.weight": 0,
             "to_out.0.weight": 1}


@dataclasses.dataclass
class TPPlan:
    """A sharded module's plan: `n` ranks in the model group, this one at
    `rank`, and the split dimension of each sharded parameter by its
    name in the module."""
    n: int
    rank: int
    group: object
    dims: Dict[str, int]

    def __deepcopy__(self, memo):   # copies of the module share the plan
        return self


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """The f32 sum of `t` over `group` (a new tensor)."""
    return all_reduce_(t.to(torch.float32, copy=True), group=group)


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group).to(g.dtype), None


class _Exit(torch.autograd.Function):
    """The partial outputs summed over the model group (in f32);
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def _exit_with_bias(part: torch.Tensor, bias: Optional[torch.Tensor],
                    group, channel_dim: int) -> torch.Tensor:
    """The sum over the group of the partial outputs, plus the replicated
    bias (added once, in f32), in the partial outputs' dtype."""
    out = _Exit.apply(part, group)
    if bias is not None:
        shape = [1] * part.dim()
        shape[channel_dim] = -1
        out = out + bias.float().reshape(shape)
    return out.to(part.dtype)


class TPResBlock(ResBlock):
    """A ResBlock whose two convolutions are split column / row over the
    model group (`shard_module_` makes one from a ResBlock)."""

    tp: TPPlan

    def forward(self, x, emb):
        g = self.tp.group
        h = group_norm_act(x, self.in_layers[0], self.in_layers[1])
        h = self.in_layers[2](_Enter.apply(h, g))
        emb_out = self.emb_layers[1](_Enter.apply(
            self.emb_layers[0](emb), g))
        h = group_norm_act(h, self.out_layers[0], self.out_layers[1],
                           shift=emb_out)
        conv = self.out_layers[3]
        if isinstance(conv, Int8Conv3d):    # sums over the group itself
            return self.skip_connection(x) + conv(h)
        if isinstance(conv, WinogradConv3d):
            part = winograd_conv3d(h.to(conv.act_dtype or h.dtype),
                                   conv.weight, None, u=conv.u)
        else:
            part = conv._conv_forward(h.to(conv.weight.dtype), conv.weight,
                                      None)
        h = _exit_with_bias(part, conv.bias, g, 1)
        return self.skip_connection(x) + h


class TPCrossAttention(CrossAttention):
    """A CrossAttention over this rank's heads, its output projection
    summed over the model group (`shard_module_` makes one)."""

    tp: TPPlan

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        lin = self.to_out[0]
        part = F.linear(t.to(lin.weight.dtype), lin.weight)
        return _exit_with_bias(part, lin.bias, self.tp.group, -1)

    def forward(self, x, context=None):
        g = self.tp.group
        if context is not None and context.shape[1] == 1:
            out = self._out(self.to_v(_Enter.apply(context, g)))
            return out.expand(x.shape[0], x.shape[1], out.shape[-1])
        xe = _Enter.apply(x, g)
        ce = xe if context is None else _Enter.apply(context, g)
        q, k, v = self.to_q(xe), self.to_k(ce), self.to_v(ce)
        b, n, _ = q.shape
        m = k.shape[1]
        h, d = self.heads, self.dim_head
        out = dot_product_attention(q.reshape(b, n, h, d),
                                    k.reshape(b, m, h, d),
                                    v.reshape(b, m, h, d))
        return self._out(out.reshape(b, n, h * d))


def _splits(block: torch.nn.Module, n: int) -> bool:
    if isinstance(block, ResBlock):
        return (block.in_layers[2].out_channels % n == 0
                and block.out_layers[0].num_groups % n == 0)
    return isinstance(block, CrossAttention) and block.heads % n == 0


def _blocks(module: torch.nn.Module, n: int):
    """(name, block, its dims) of every block of the shape denoiser that
    splits over n ranks, in module order."""
    sd = getattr(module, "shape_denoiser", None)
    if sd is None or n <= 1:
        return []
    out = []
    for name, m in sd.named_modules():
        if isinstance(m, (ResBlock, CrossAttention)) and _splits(m, n):
            dims = RES_DIMS if isinstance(m, ResBlock) else ATTN_DIMS
            out.append((f"shape_denoiser.{name}", m, dims))
    return out


def split_dims(module: torch.nn.Module, n: int) -> Dict[str, int]:
    """{parameter name: split dimension} of the parameters of an unsharded
    `module` that shard over a model group of n ranks."""
    return {f"{name}.{k}": d for name, _, dims in _blocks(module, n)
            for k, d in dims.items()}


def shard_tensor(t: torch.Tensor, dim: int, rank: int, n: int
                 ) -> torch.Tensor:
    """Rank `rank`'s contiguous 1/n of `t` along `dim`."""
    return t.chunk(n, dim)[rank].contiguous()


def shard_state_dict(sd: Mapping[str, torch.Tensor], dims: Mapping[str, int],
                     rank: int, n: int) -> Dict[str, torch.Tensor]:
    """A full state_dict -> rank `rank`'s (the entries of `dims` sliced)."""
    return {k: shard_tensor(v, dims[k], rank, n) if k in dims else v
            for k, v in sd.items()}


def gather_shards(shards: Sequence[Mapping[str, torch.Tensor]],
                  dims: Mapping[str, int]) -> Dict[str, torch.Tensor]:
    """Every rank's state_dict, in rank order -> the full state_dict."""
    return {k: torch.cat([s[k] for s in shards], dims[k]) if k in dims
            else v for k, v in shards[0].items()}


def plan_of(module: torch.nn.Module) -> Optional[TPPlan]:
    """The plan of a sharded module (None when it is not sharded)."""
    return getattr(module, "tp_plan", None)


@torch.no_grad()
def shard_module_(module: torch.nn.Module, mesh: Mesh) -> TPPlan:
    """Shard `module`'s shape denoiser over the mesh's model group in
    place: each splitting block's parameters become this rank's slices and
    the block becomes a TPResBlock / TPCrossAttention.  Returns the plan
    (also `module.tp_plan`).  Make the optimizer after this call.  The
    sampling twin of a sharded module (`models.sgdiff.inference_twin`) is
    built by every rank of the group together under `sample_dtype: int8`
    (module docstring)."""
    n, rank = mesh.model, mesh.model_rank
    plan = TPPlan(n, rank, mesh.model_group, split_dims(module, n))
    for _, block, dims in _blocks(module, n):
        params = dict(block.named_parameters())
        for k, d in dims.items():
            p = params[k]
            p.data = shard_tensor(p.data, d, rank, n)
        if isinstance(block, ResBlock):
            block.__class__ = TPResBlock
            conv = block.in_layers[2]
            conv.out_channels //= n
            block.emb_layers[1].out_features //= n
            block.out_layers[0].num_groups //= n
            block.out_layers[0].num_channels //= n
            block.out_layers[3].in_channels //= n
        else:
            block.__class__ = TPCrossAttention
            block.heads //= n
            for lin in (block.to_q, block.to_k, block.to_v):
                lin.out_features //= n
            block.to_out[0].in_features //= n
        block.tp = plan
    module.tp_plan = plan
    return plan


def _gather(t: torch.Tensor, dim: int, plan: TPPlan) -> torch.Tensor:
    """The full tensor of the group's shards of `t` along `dim`."""
    moved = t.detach().movedim(dim, 0).contiguous()
    out = moved.new_empty((plan.n * moved.numel(),))
    all_gather(out, moved.reshape(-1), plan.group)
    return out.reshape((plan.n * moved.shape[0],)
                       + moved.shape[1:]).movedim(0, dim)


def gather_tensors(names: Sequence[str], tensors: Sequence[torch.Tensor],
                   module: torch.nn.Module) -> List[torch.Tensor]:
    """Each named tensor (a parameter's shard, or a tensor shaped as one,
    such as its gradient or moment) gathered to its full shape over the
    module's model group; replicated ones as they are.  Every rank of the
    group must call it."""
    plan = plan_of(module)
    if plan is None:
        return list(tensors)
    return [_gather(t, plan.dims[n], plan) if n in plan.dims else t
            for n, t in zip(names, tensors)]


def gather_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The module's full state_dict (every rank of a sharded module's
    group must call it; every rank receives it)."""
    sd = module.state_dict()
    return dict(zip(sd, gather_tensors(list(sd), list(sd.values()), module)))


def local_state_dict(module: torch.nn.Module,
                     full: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full state_dict for `module` (the full one
    when the module is not sharded)."""
    plan = plan_of(module)
    if plan is None:
        return dict(full)
    return shard_state_dict(full, plan.dims, plan.rank, plan.n)


def global_norm(names: Sequence[str], tensors: Sequence[torch.Tensor],
                module: torch.nn.Module) -> torch.Tensor:
    """sqrt of the sum of squares of the logical tensors (optax.global_norm
    of the unsharded gradients): the sharded leaves' sums of squares summed
    over the module's model group, each replicated leaf counted once."""
    plan = plan_of(module)
    if plan is None or plan.n == 1:
        return sgdiff.global_norm(tensors)
    sq = [torch.linalg.vector_norm(t.float()) ** 2 for t in tensors]
    zero = tensors[0].new_zeros((), dtype=torch.float32)
    sharded = sum((s for n, s in zip(names, sq) if n in plan.dims), zero)
    replicated = sum((s for n, s in zip(names, sq) if n not in plan.dims),
                     zero)
    return (_sum(sharded, plan.group) + replicated).sqrt()
