"""EchoScene in plain float32 PyTorch: the benchmark's reference.

A frozen restatement of the model the benchmark runs (the EchoScene paper,
ECCV 2024, and its reference code: `model/EchoScene.py`, the echo GCNs of
`model/graph.py`, the layout UNet1D of `diffusion_layout/denoise_net.py`,
the shape UNet3D of `diffusion_shape/openai_model_3d.py` and the VQ-VAE of
`vqvae_networks/`).  Module and parameter names follow those reference
modules, so one state dict loads into this module and into the program's.

Everything runs in float32 with TF32 off, with none of the program's
kernels: attention is softmax(q k^T / sqrt(d)) v written out, in blocks of
rows so that it fits; convolutions are `F.conv*`.  Two departures from a
literal reading, both exact in real arithmetic:

  * cross-attention to a one-token context is to_out(to_v(context)) (the
    softmax over one key is 1), so to_q / to_k are never read;
  * when `factored` is set (the sampling paths), a nearest-2x upsample
    followed by a SAME 3^r convolution is computed as 2^a convolutions
    with 2-tap kernels on the pre-upsample grid, one a parity of the
    upsampled axes, as the published sampling twin does.

`Numerics` names the arithmetic of the products.  Mode "f32" is the
reference; with `quant_sites` the shape torso's convolutions are the
configuration's W8A8 sites, their scales worked out here from the f32
weights and this module's own activations (per-tensor abs-max for
activations, per-output-channel for weights, symmetric, round half to
even, clipped to +-127).  Mode "control" is the nearest precision below the
configuration's, which the benchmark's correctness check must reject: every
other product operand in float8 with a per-tensor scale (e4m3, its gradient
in e5m2), and the quantized sites in int4 (+-7).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

ATTN_ROWS = 16       # batch rows of one attention block


class Numerics:
    """The arithmetic of the products: mode "f32" or "control" (module
    docstring); `quant_sites` says whether the shape torso's convolutions
    are the configuration's int8 sites."""

    def __init__(self, mode: str = "f32", quant_sites: bool = False):
        if mode not in ("f32", "control"):
            raise ValueError(f"numerics {mode!r}")
        self.mode = mode
        self.quant_sites = quant_sites

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """A product operand as the arithmetic sees it."""
        if self.mode == "f32":
            return x
        return fp8_round(x)

    def levels(self) -> int:
        """Largest magnitude of the quantized torso's integers."""
        return 127 if self.mode == "f32" else 7


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in the float8 format `dtype` after a per-tensor scale onto its
    range, back in x's dtype."""
    top = torch.finfo(dtype).max
    s = x.abs().amax().clamp_min(1e-30) / top
    return (x / s).to(dtype).to(x.dtype) * s


class _Fp8Operand(torch.autograd.Function):
    """A product operand in float8 as fp8 training takes it: e4m3 forward,
    its gradient in e5m2, each with a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad, torch.float8_e5m2)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded as a float8 product operand (`_Fp8Operand`)."""
    if x.requires_grad:
        return _Fp8Operand.apply(x)
    with torch.no_grad():
        return _fp8(x, torch.float8_e4m3fn)


def quantize(x: torch.Tensor, levels: int, dims=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric abs-max quantization over `dims` (all when None): the
    integers (as floats) and the scale max(amax, 1e-8) / levels."""
    dims = tuple(range(x.dim())) if dims is None else tuple(dims)
    amax = x.detach().abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / levels
    return torch.clamp(torch.round(x / scale), -levels, levels), scale


# ----------------------------------------------------------------------
# layers

class Linear(nn.Linear):
    num: Numerics

    def forward(self, x):
        return F.linear(self.num.operand(x), self.num.operand(self.weight),
                        self.bias)


class Conv(nn.Module):
    """A Conv1d / Conv3d holding `weight` and `bias` under torch's names;
    `quant` marks an int8 site of the shape torso."""

    num: Numerics

    def __init__(self, dims: int, c_in: int, c_out: int, kernel: int,
                 stride=1, padding=0, bias: bool = True):
        super().__init__()
        self.dims = dims
        self.stride = stride
        self.padding = padding
        self.quant = False
        self.weight = nn.Parameter(torch.empty(
            (c_out, c_in) + (kernel,) * dims))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None

    def conv(self, x, w, bias, stride=None, padding=None):
        fn = F.conv1d if self.dims == 1 else F.conv3d
        stride = self.stride if stride is None else stride
        padding = self.padding if padding is None else padding
        if self.quant and self.num.quant_sites:
            lv = self.num.levels()
            xq, xs = quantize(x, lv)
            wq, ws = quantize(w, lv, dims=range(1, w.dim()))
            out = fn(xq, wq, None, stride, padding) * (xs * ws.reshape(1, -1, *(
                (1,) * self.dims)))
            return out if bias is None else out + bias.reshape(
                1, -1, *((1,) * self.dims))
        return fn(self.num.operand(x), self.num.operand(w), bias, stride,
                  padding)

    def forward(self, x):
        return self.conv(x, self.weight, self.bias)


def tokens_linear(conv: Conv, tokens: torch.Tensor) -> torch.Tensor:
    """A 1x1 convolution applied to channel-last tokens."""
    w = conv.weight
    return F.linear(conv.num.operand(tokens),
                    conv.num.operand(w.reshape(w.shape[0], w.shape[1])),
                    conv.bias)


def parities(up_axes: Sequence[int]):
    out = [()]
    for _ in up_axes:
        out = [p + (r,) for p in out for r in (0, 1)]
    return out


def upsample_conv(conv: Conv, x: torch.Tensor, up_axes: Sequence[int],
                  factored: bool) -> torch.Tensor:
    """Nearest-2x along the spatial axes `up_axes`, then `conv` (SAME
    3^r, stride 1); with `factored`, the exact 2-tap form: output parity r
    along an axis reads taps [W0, W1 + W2] of rows {i - 1, i} (r = 0) or
    [W0 + W1, W2] of rows {i, i + 1} (r = 1)."""
    rank = x.dim() - 2
    if not factored:
        scale = [2 if s in up_axes else 1 for s in range(rank)]
        return conv(F.interpolate(x, scale_factor=tuple(scale),
                                  mode="nearest"))
    out_spatial = tuple(n * (2 if s in up_axes else 1)
                        for s, n in enumerate(x.shape[2:]))
    out = x.new_zeros((x.shape[0], conv.weight.shape[0]) + out_spatial)
    xp = F.pad(x, (1, 1) * rank)
    for parity in parities(up_axes):
        w = conv.weight
        src = [slice(None)] * (2 + rank)
        dst = [slice(None)] * (2 + rank)
        for s, r in zip(up_axes, parity):
            w0, w1, w2 = w.unbind(2 + s)
            w = torch.stack((w0, w1 + w2) if r == 0 else (w0 + w1, w2),
                            dim=2 + s)
            src[2 + s] = slice(r, r + x.shape[2 + s] + 1)
            dst[2 + s] = slice(r, None, 2)
        out[tuple(dst)] = conv.conv(xp[tuple(src)], w, conv.bias, 1, 0)
    return out


def norm_groups(c: int, requested: int = 32) -> int:
    g = min(requested, c)
    while c % g:
        g -= 1
    return g


class GroupNorm(nn.GroupNorm):
    def forward(self, x, shift=None):
        if shift is not None:
            x = x + shift.reshape(shift.shape[0], shift.shape[1],
                                  *(1,) * (x.dim() - 2))
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.eps)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def attention(num: Numerics, q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, L, H, D) q and (B, S, H, D) k, v,
    in blocks of ATTN_ROWS batch rows."""
    outs = []
    scale = q.shape[-1] ** -0.5
    for i in range(0, q.shape[0], ATTN_ROWS):
        qb, kb, vb = (num.operand(t[i:i + ATTN_ROWS].transpose(1, 2))
                      for t in (q, k, v))
        p = torch.softmax(qb @ kb.transpose(-1, -2) * scale, dim=-1)
        outs.append((num.operand(p) @ vb).transpose(1, 2))
    return torch.cat(outs, 0)


# ----------------------------------------------------------------------
# graph convolution

class BatchNorm(nn.Module):
    """BatchNorm1d over the rows whose mask is 1 (eps 1e-5, momentum 0.1,
    unbiased running variance)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x, mask=None):
        if self.training:
            m = (torch.ones(x.shape[0], device=x.device) if mask is None
                 else mask.float())[:, None]
            n = m.sum().clamp_min(1.0)
            mean = (x * m).sum(0) / n
            var = (((x - mean) ** 2) * m).sum(0) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * unbiased)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias


class MLP(nn.Sequential):
    def __init__(self, dims: Sequence[int], batch_norm: bool = True,
                 final_nonlinearity: bool = True):
        layers = []
        for i in range(len(dims) - 1):
            layers.append(Linear(dims[i], dims[i + 1]))
            if i < len(dims) - 2 or final_nonlinearity:
                if batch_norm:
                    layers.append(BatchNorm(dims[i + 1]))
                layers.append(nn.ReLU())
        super().__init__(*layers)

    def forward(self, x, mask=None):
        for layer in self:
            x = layer(x, mask) if isinstance(layer, BatchNorm) else layer(x)
        return x


def scatter_sum(values, idx, mask, n):
    onehot = (idx[:, None] == torch.arange(n, device=idx.device)[None, :]
              ).float() * mask.float()[:, None]
    return onehot.t() @ values


class GraphTripleConv(nn.Module):
    """One triplet graph convolution, 'avg' pooling."""

    def __init__(self, din: int, dp: int, dout: Optional[int], hidden: int,
                 batch_norm: bool, residual: bool):
        super().__init__()
        dout = dout or din
        self.hidden, self.dp, self.residual = hidden, dp, residual
        self.net1 = MLP([2 * din + dp, hidden, 2 * hidden + dp], batch_norm)
        self.net2 = MLP([hidden, hidden, dout], batch_norm)
        if residual:
            self.linear_projection = Linear(din, dout)
            self.linear_projection_pred = Linear(dp, dp)

    def forward(self, obj, pred, edges, obj_mask, triple_mask):
        n, h, dp = obj.shape[0], self.hidden, self.dp
        s, o = edges[:, 0], edges[:, 1]
        t = self.net1(torch.cat([obj[s], pred, obj[o]], 1), triple_mask)
        new_s, new_p, new_o = t[:, :h], t[:, h:h + dp], t[:, h + dp:]
        pooled = (scatter_sum(new_s, s, triple_mask, n)
                  + scatter_sum(new_o, o, triple_mask, n))
        ones = torch.ones(edges.shape[0], 1, device=obj.device)
        counts = (scatter_sum(ones, s, triple_mask, n)
                  + scatter_sum(ones, o, triple_mask, n))
        new_obj = self.net2(pooled / counts.clamp_min(1.0), obj_mask)
        if self.residual:
            new_obj = new_obj + self.linear_projection(obj)
            new_p = new_p + self.linear_projection_pred(pred)
        return new_obj, new_p


class GraphTripleConvNet(nn.Module):
    def __init__(self, din: int, dp: int, num_layers: int, hidden: int,
                 batch_norm: bool, residual: bool, dout: int):
        super().__init__()
        self.gconvs = nn.ModuleList([
            GraphTripleConv(din, dp, dout if i == num_layers - 1 else None,
                            hidden, batch_norm, residual)
            for i in range(num_layers)])

    def forward(self, obj, pred, edges, obj_mask, triple_mask):
        for g in self.gconvs:
            obj, pred = g(obj, pred, edges, obj_mask, triple_mask)
        return obj, pred


# ----------------------------------------------------------------------
# UNet torso

class ResBlock(nn.Module):
    def __init__(self, c_in: int, emb: int, c_out: int, dims: int):
        super().__init__()
        self.in_layers = nn.Sequential(
            GroupNorm(norm_groups(c_in), c_in), nn.SiLU(),
            Conv(dims, c_in, c_out, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb, c_out))
        self.out_layers = nn.Sequential(
            GroupNorm(norm_groups(c_out), c_out), nn.SiLU(), nn.Dropout(0.0),
            Conv(dims, c_out, c_out, 3, padding=1))
        self.skip_connection = (nn.Identity() if c_in == c_out
                                else Conv(dims, c_in, c_out, 1))
        for m in (self.in_layers[2], self.out_layers[3], self.skip_connection):
            if isinstance(m, Conv) and dims == 3:
                m.quant = True

    def forward(self, x, emb):
        h = self.in_layers(x)
        h = self.out_layers[0](h, shift=self.emb_layers(emb))
        h = self.out_layers[3](self.out_layers[1](h))
        return self.skip_connection(x) + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, ctx_dim: Optional[int], heads: int,
                 dim_head: int):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = ctx_dim or dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(ctx_dim, inner, bias=False)
        self.to_v = Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), nn.Dropout(0.0))

    def forward(self, x, context=None):
        if context is not None and context.shape[1] == 1:
            out = self.to_out(self.to_v(context))
            return out.expand(x.shape[0], x.shape[1], out.shape[-1])
        context = x if context is None else context
        b, n = x.shape[:2]
        h, d = self.heads, self.dim_head
        q = self.to_q(x).reshape(b, n, h, d)
        k = self.to_k(context).reshape(b, -1, h, d)
        v = self.to_v(context).reshape(b, -1, h, d)
        out = attention(self.to_q.num, q, k, v)
        return self.to_out(out.reshape(b, n, h * d))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * 4), nn.Dropout(0.0),
                                 Linear(dim * 4, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, d_head: int,
                 ctx_dim: Optional[int]):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, ctx_dim, heads, d_head)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, c: int, heads: int, ctx_dim: Optional[int],
                 dims: int, depth: int):
        super().__init__()
        self.norm = GroupNorm(norm_groups(c), c, eps=1e-6)
        self.proj_in = Conv(dims, c, c, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(c, heads, c // heads, ctx_dim)
            for _ in range(depth)])
        self.proj_out = Conv(dims, c, c, 1)

    def forward(self, x, context=None):
        b, c = x.shape[:2]
        h = self.norm(x).reshape(b, c, -1).transpose(1, 2)
        h = tokens_linear(self.proj_in, h)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = tokens_linear(self.proj_out, h)
        return h.transpose(1, 2).reshape(x.shape) + x


class Downsample(nn.Module):
    def __init__(self, c: int, dims: int):
        super().__init__()
        self.op = Conv(dims, c, c, 3, stride=(1, 2, 2) if dims == 3 else 2,
                       padding=1)
        self.op.quant = dims == 3

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, c: int, dims: int):
        super().__init__()
        self.dims = dims
        self.factored = False
        self.conv = Conv(dims, c, c, 3, padding=1)
        self.conv.quant = dims == 3

    def forward(self, x):
        if self.dims == 1:
            return self.conv(x)
        return upsample_conv(self.conv, x, (1, 2), self.factored)


class TimestepSequential(nn.Sequential):
    """A torso block; with `remat` (training) each ResBlock and transformer
    is recomputed in the backward pass instead of kept (the published
    use_checkpoint), so that a float32 step fits."""

    remat = False

    def forward(self, x, emb, context=None):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = self.call(layer, x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = self.call(layer, x, context)
            else:
                x = layer(x)
        return x

    def call(self, layer, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)


class UNetTorso(nn.Module):
    def __init__(self, c_in: int, mc: int, c_out: int, num_res: int,
                 attn_res: Sequence[int], mult: Sequence[int], heads: int,
                 dims: int, depth: int, ctx_dim: Optional[int]):
        super().__init__()
        emb = mc * 4
        conv_in = Conv(dims, c_in, mc, 3, padding=1)
        conv_in.quant = dims == 3
        self.input_blocks = nn.ModuleList([TimestepSequential(conv_in)])
        skips, ch, ds = [mc], mc, 1
        for level, m in enumerate(mult):
            for _ in range(num_res):
                layers = [ResBlock(ch, emb, m * mc, dims)]
                ch = m * mc
                if ds in attn_res:
                    layers.append(SpatialTransformer(ch, heads, ctx_dim, dims,
                                                     depth))
                self.input_blocks.append(TimestepSequential(*layers))
                skips.append(ch)
            if level != len(mult) - 1:
                self.input_blocks.append(TimestepSequential(
                    Downsample(ch, dims)))
                skips.append(ch)
                ds *= 2
        self.middle_block = TimestepSequential(
            ResBlock(ch, emb, ch, dims),
            SpatialTransformer(ch, heads, ctx_dim, dims, depth),
            ResBlock(ch, emb, ch, dims))
        self.output_blocks = nn.ModuleList()
        for level, m in reversed(list(enumerate(mult))):
            for i in range(num_res + 1):
                layers = [ResBlock(ch + skips.pop(), emb, mc * m, dims)]
                ch = mc * m
                if ds in attn_res:
                    layers.append(SpatialTransformer(ch, heads, ctx_dim, dims,
                                                     depth))
                if level and i == num_res:
                    layers.append(Upsample(ch, dims))
                    ds //= 2
                self.output_blocks.append(TimestepSequential(*layers))
        conv_out = Conv(dims, mc, c_out, 3, padding=1)
        conv_out.quant = dims == 3
        self.out = nn.Sequential(GroupNorm(norm_groups(ch), ch), nn.SiLU(),
                                 conv_out)

    def torso(self, x, emb, context):
        hs, h = [], x
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], 1), emb, context)
        return self.out(h)


def gcn(din: int, num_layers: int, dout: int) -> GraphTripleConvNet:
    """The denoisers' echo GCN: 64-d graph width, batch norm, residual."""
    return GraphTripleConvNet(din, 128, num_layers, 256, True, True, dout)


class LayoutDenoiser(UNetTorso):
    def __init__(self, c: Dict, obj_dim: int):
        super().__init__(c["in_channels"], c["model_channels"],
                         c["out_channels"], c["num_res_blocks"],
                         c["attention_resolutions"], c["channel_mult"],
                         c["num_heads"], 1, c["transformer_depth"],
                         c["crossattn_dim"])
        mc = c["model_channels"]
        self.model_channels = mc
        self.time_embed = nn.Sequential(Linear(mc, mc * 4), nn.SiLU(),
                                        Linear(mc * 4, mc * 4))
        self.pred_embeddings = nn.Embedding(c["num_preds"], 128)
        self.box_embeddings = Linear(c["in_channels"], 64)
        self.box_time_emb = Linear(mc * 4, 64)
        self.box_graph_cov = gcn(obj_dim + 128, c["gconv_num_layers"],
                                 c["crossattn_dim"])

    def forward(self, box_t, obj_embed, triples, t, obj_mask, triple_mask):
        emb = self.time_embed(timestep_embedding(t, self.model_channels))
        obj_box = torch.cat([obj_embed, self.box_embeddings(box_t),
                             self.box_time_emb(emb)], 1)
        latent, _ = self.box_graph_cov(
            obj_box, self.pred_embeddings(triples[:, 1]), triples[:, [0, 2]],
            obj_mask, triple_mask)
        return self.torso(box_t[:, :, None], emb, latent[:, None, :])[:, :, 0]


class ShapeDenoiser(UNetTorso):
    def __init__(self, c: Dict, obj_dim: int):
        super().__init__(c["in_channels"], c["model_channels"],
                         c["out_channels"], c["num_res_blocks"],
                         c["attention_resolutions"], c["channel_mult"],
                         c["num_heads"], 3, c["transformer_depth"],
                         c["context_dim"])
        mc, r = c["model_channels"], c["image_size"]
        self.model_channels = mc
        self.time_embed = nn.Sequential(Linear(mc, mc * 4), nn.SiLU(),
                                        Linear(mc * 4, mc * 4))
        pooled = ((r // 2 - 2) // 4 + 1) ** 3
        self.pred_embeddings = nn.Embedding(c["num_preds"], 128)
        self.shape_embeddings = nn.Sequential(
            Conv(3, c["in_channels"], 32, 3, padding=1), nn.MaxPool3d(2, 2),
            Conv(3, 32, 64, 3, padding=1), nn.MaxPool3d(2, 4),
            nn.Identity(), Linear(64 * pooled, 64))
        self.shape_time_emb = Linear(mc * 4, 64)
        self.shape_code_graph_cov = gcn(obj_dim + 128, c["gconv_num_layers"],
                                        c["context_dim"])

    def forward(self, z, obj_embed, triples, t, obj_mask, triple_mask):
        emb = self.time_embed(timestep_embedding(t, self.model_channels))
        x = z.permute(0, 4, 1, 2, 3)
        se = self.shape_embeddings
        code = se[3](se[2](se[1](se[0](x))))
        code = se[5](code.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1))
        if obj_embed.dim() == 3:
            obj_embed = obj_embed[:, 0, :]
        latent, _ = self.shape_code_graph_cov(
            torch.cat([obj_embed, code, self.shape_time_emb(emb)], 1),
            self.pred_embeddings(triples[:, 1]), triples[:, [0, 2]],
            obj_mask, triple_mask)
        return self.torso(x, emb, latent[:, None, :]).permute(0, 2, 3, 4, 1)


# ----------------------------------------------------------------------
# VQ-VAE

def vq_groups(c: int) -> int:
    if c <= 32:
        return c // 4
    return 30 if c % 32 else 32


def vq_norm(c: int) -> GroupNorm:
    return GroupNorm(vq_groups(c), c, eps=1e-6)


class ResnetBlock3D(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.norm1 = vq_norm(c_in)
        self.conv1 = Conv(3, c_in, c_out, 3, padding=1)
        self.norm2 = vq_norm(c_out)
        self.conv2 = Conv(3, c_out, c_out, 3, padding=1)
        if c_in != c_out:
            self.nin_shortcut = Conv(3, c_in, c_out, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = vq_norm(c)
        self.q, self.k, self.v, self.proj_out = (Conv(3, c, c, 1)
                                                 for _ in range(4))

    def forward(self, x):
        b, c = x.shape[:2]
        tok = self.norm(x).reshape(b, c, -1).transpose(1, 2)
        q, k, v = (tokens_linear(m, tok).reshape(b, -1, 1, c)
                   for m in (self.q, self.k, self.v))
        out = attention(self.q.num, q, k, v).reshape(b, -1, c)
        return x + tokens_linear(self.proj_out, out).transpose(1, 2
                                                               ).reshape(x.shape)


class Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock3D(c, c)
        self.attn_1 = AttnBlock3D(c)
        self.block_2 = ResnetBlock3D(c, c)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Level(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList()


class Downsample3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(3, c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1, 0, 1)))


class Upsample3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.factored = False
        self.conv = Conv(3, c, c, 3, padding=1)

    def forward(self, x):
        return upsample_conv(self.conv, x, (0, 1, 2), self.factored)


class Encoder3D(nn.Module):
    def __init__(self, v: Dict):
        super().__init__()
        ch, mult = v["ch"], v["ch_mult"]
        self.conv_in = Conv(3, v["in_channels"], ch, 3, padding=1)
        self.down = nn.ModuleList()
        c = ch
        for i, m in enumerate(mult):
            blocks = []
            for _ in range(v["num_res_blocks"]):
                blocks.append(ResnetBlock3D(c, ch * m))
                c = ch * m
            level = Level(blocks)
            if i != len(mult) - 1:
                level.downsample = Downsample3D(c)
            self.down.append(level)
        self.mid = Mid(c)
        self.norm_out = vq_norm(c)
        self.conv_out = Conv(3, c, v["z_channels"], 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        return self.conv_out(F.gelu(self.norm_out(self.mid(h))))


class Decoder3D(nn.Module):
    def __init__(self, v: Dict):
        super().__init__()
        ch, mult = v["ch"], v["ch_mult"]
        c = ch * mult[-1]
        self.conv_in = Conv(3, v["z_channels"], c, 3, padding=1)
        self.mid = Mid(c)
        levels = {}
        for i in reversed(range(len(mult))):
            blocks = []
            for _ in range(v["num_res_blocks"]):
                blocks.append(ResnetBlock3D(c, ch * mult[i]))
                c = ch * mult[i]
            level = Level(blocks)
            if i != 0:
                level.upsample = Upsample3D(c)
            levels[i] = level
        self.up = nn.ModuleList([levels[i] for i in range(len(mult))])
        self.norm_out = vq_norm(c)
        self.conv_out = Conv(3, c, v["out_ch"], 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.gelu(self.norm_out(h)))


class Quantizer(nn.Module):
    def __init__(self, n_embed: int, dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, dim)

    def forward(self, z):
        book = self.embedding.weight
        flat = z.reshape(-1, book.shape[1])
        d = ((flat ** 2).sum(1, keepdim=True) + (book ** 2).sum(1)[None]
             - 2.0 * flat @ book.t())
        return book[torch.argmin(d, 1)].reshape(z.shape)


class VQVAE(nn.Module):
    def __init__(self, v: Dict):
        super().__init__()
        self.encoder = Encoder3D(v)
        self.decoder = Decoder3D(v)
        self.quantize = Quantizer(v["n_embed"], v["embed_dim"])
        self.quant_conv = Conv(3, v["z_channels"], v["embed_dim"], 1)
        self.post_quant_conv = Conv(3, v["embed_dim"], v["z_channels"], 1)

    def encode_no_quant(self, x):
        return self.quant_conv(self.encoder(x.permute(0, 4, 1, 2, 3))
                               ).permute(0, 2, 3, 4, 1)

    def decode_no_quant(self, z):
        q = self.quantize(z)
        dec = self.decoder(self.post_quant_conv(q.permute(0, 4, 1, 2, 3)))
        return dec.permute(0, 2, 3, 4, 1)


# ----------------------------------------------------------------------
# the whole model

class EchoScene(nn.Module):
    """The joint model.  `cfg` is the configuration file's `model` group;
    `num` the arithmetic (Numerics), shared by every product."""

    def __init__(self, cfg: Dict, num: Optional[Numerics] = None):
        super().__init__()
        g = cfg["graph"]
        gdim, clip = g["embedding_dim"], g["clip_dim"]
        enc_out = gdim * 2 + clip
        common = dict(num_layers=g["gconv_num_layers"], hidden=gdim * 4,
                      batch_norm=True, residual=False, dout=enc_out)
        self.obj_embeddings_ec = nn.Embedding(g["num_objs"] + 1, gdim * 2)
        self.pred_embeddings_ec = nn.Embedding(g["num_preds"], gdim * 2)
        self.gconv_net_ec = GraphTripleConvNet(enc_out, enc_out, **common)
        self.gconv_net_manipulation = GraphTripleConvNet(
            enc_out + gdim + enc_out, enc_out, **common)
        rel = g["rel_s_dims"]
        self.rel_s_mlp = MLP(rel, True, final_nonlinearity=False)
        self.shape_denoiser = ShapeDenoiser(cfg["shape_denoiser"], rel[-1])
        self.vqvae = VQVAE(cfg["vqvae"])
        self.layout_denoiser = LayoutDenoiser(cfg["layout_denoiser"],
                                              enc_out)
        self.set_numerics(num or Numerics())

    def set_numerics(self, num: Numerics) -> None:
        for m in self.modules():
            m.num = num

    def set_remat(self, remat: bool) -> None:
        for m in self.modules():
            if isinstance(m, TimestepSequential):
                m.remat = remat

    def set_factored(self, factored: bool) -> None:
        """The sampling paths' exact factored upsample (module docstring)."""
        for m in self.modules():
            if isinstance(m, (Upsample, Upsample3D)):
                m.factored = factored

    def embed(self, objs, triples, text, rel):
        obj = torch.cat([text, self.obj_embeddings_ec(objs)], 1)
        pred = torch.cat([rel, self.pred_embeddings_ec(triples[:, 1])], 1)
        return obj, pred

    def encode_context(self, g: Dict[str, torch.Tensor],
                       change: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Encoder and manipulator GCNs over a graph batch `g` (both views
        alike: objs, triples, obj_mask, triple_mask, text_feats, rel_feats,
        enc_obj_mask, change_flags); without manipulation the latent is the
        manipulator's."""
        obj, pred = self.embed(g["objs"], g["triples"], g["text_feats"],
                               g["rel_feats"])
        edges = g["triples"][:, [0, 2]]
        latent, _ = self.gconv_net_ec(obj, pred, edges, g["obj_mask"],
                                      g["triple_mask"])
        latent = latent * g["enc_obj_mask"][:, None]
        ch = change * g["change_flags"][:, None]
        man, _ = self.gconv_net_manipulation(
            torch.cat([latent, ch, obj], 1), pred, edges, g["obj_mask"],
            g["triple_mask"])
        return {"latent": man, "obj_embed": obj,
                "uc_s": self.rel_s_mlp(obj, g["obj_mask"]),
                "c_s": self.rel_s_mlp(man, g["obj_mask"])}

    def layout_eps(self, x, t, obj_embed, triples, obj_mask, triple_mask):
        return self.layout_denoiser(x, obj_embed, triples, t, obj_mask,
                                    triple_mask)

    def shape_eps(self, z, t, obj_embed, triples, obj_mask, triple_mask):
        return self.shape_denoiser(z, obj_embed, triples, t, obj_mask,
                                   triple_mask)

    def decode_latent(self, z):
        return self.vqvae.decode_no_quant(z)


def norm_scale_names(model: nn.Module):
    """Names of the parameters that are a norm's scale (drawn as ones)."""
    out = set()
    for name, m in model.named_modules():
        if isinstance(m, (nn.GroupNorm, nn.LayerNorm, BatchNorm)):
            out.add(f"{name}.weight")
    return out
