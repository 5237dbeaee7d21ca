"""EchoScene module: graph encoder + manipulator GCNs feeding the layout and
shape diffusion branches.

Port of echoscene_tpu/models/echo_scene.py (reference model/EchoScene.py:
14-543): `encode_context` (node streams of [CLIP text feature, class
embedding], the 5-layer encoder GCN, zero latents for nodes absent from the
encoder view, the change code, the manipulator GCN, and rel_s_mlp's
shape-branch conditioning), `layout_eps`, `shape_eps`, `decode_latent`, and
for training the frozen VQ encode `encode_sdf`, the shape sub-batch
`select_shape_subbatch` and the joint forward `train_forward`, which is also
the module's `forward`.  Batch-norm layers run on batch statistics in
`.train()` mode, as JAX's `train=True`.

Inside `layout_graphs()`, the scope of one sampling chain, `layout_eps`
replays the layout denoiser's forward from a CUDA graph where it can: on
CUDA, without autograd, in eval mode.  The first call of an input
signature (each input's shape, strides and dtype, and the device) runs
eagerly, the second captures the forward over static copies of its inputs
and replays it, and every later one copies its inputs into those copies,
replays, and returns a copy of the output: a step's ~1,600 launches become
one graph launch and seven copies.  Elsewhere (training, warm-ups, the
CPU) every call runs eagerly.  Scopes are per thread: the data-parallel
sampler runs one thread and stream a shard over one module.  A failed
capture raises.

Submodule names give the port's state_dict keys; convert/from_jax.py maps
them to and from the reference checkpoint layout (LayoutDiff.df.model.*,
shape_df / vqvae sub-dicts).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import trace
from ..core.graphbatch import GraphBatch, SceneBatch
from ..nn.gcn import GraphTripleConvNet
from ..nn.mlp import MLP
from ..nn.unet1d import LayoutDenoiser
from ..nn.unet3d import ShapeDenoiser
from ..nn.vqvae import VQVAE
from .config import EchoSceneConfig


def rel_s_dims(cfg: EchoSceneConfig):
    """rel_s_mlp widths (EchoScene.py:97-100)."""
    out = cfg.embedding_dim * 2 + (512 if cfg.with_clip else 0)
    if cfg.shape_branch.denoiser.conditioning_key == "concat":
        return [out, 1280, 4096]
    return [out, 960, 1280]


# the device type on which `layout_eps` replays graphs
GRAPH_DEVICE = "cuda"
# this thread's open scopes: module -> {signature: its graph, or None after
# the signature's first (eager) call}
_scopes = threading.local()
# (device, caller stream) -> (capture stream, the graph that holds the pool)
_places: Dict[Tuple[int, int], tuple] = {}
_places_lock = threading.Lock()


def _open_scopes() -> dict:
    if not hasattr(_scopes, "open"):
        _scopes.open = {}
    return _scopes.open


def _capture_place(dev: torch.device) -> tuple:
    """The side stream on which the graphs that the caller's current stream
    replays are captured, and the memory pool they share: one pair per
    caller stream, kept for the process.  A pool's graphs replay in turn
    on that one stream, each on inputs copied in and with its output
    copied out, so a chain's graphs reuse the memory of the last chain's;
    the cuBLAS workspace of the capture stream, made at its first capture,
    stays in it.  Graphs that share a pool keep it only while one of them
    lives: the pool is that of a graph of one fill, kept with the stream."""
    caller = torch.cuda.current_stream(dev)
    key = (caller.device_index, caller.stream_id)
    with _places_lock:
        if key not in _places:
            stream, holder = torch.cuda.Stream(dev), torch.cuda.CUDAGraph()
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                holder.capture_begin(capture_error_mode="thread_local")
                torch.zeros(1, device=dev)
                holder.capture_end()
            _places[key] = (stream, holder)
        return _places[key]


class _LayoutGraph:
    """The layout denoiser's forward captured at one input signature."""

    def __init__(self, forward, args):
        dev = args[0].device
        stream, holder = _capture_place(dev)
        self.inputs = [a.clone() for a in args]
        self.graph = torch.cuda.CUDAGraph()
        # not `torch.cuda.graph`, whose entry synchronises and empties the
        # allocator's cache; thread_local lets other threads' shards run
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            self.graph.capture_begin(pool=holder.pool(),
                                     capture_error_mode="thread_local")
            try:
                self.output = forward(*self.inputs)
            finally:
                self.graph.capture_end()

    def replay(self, args) -> torch.Tensor:
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        self.graph.replay()
        return self.output.clone()


class EchoSceneModule(nn.Module):
    def __init__(self, cfg: EchoSceneConfig, num_objs: int, num_preds: int):
        super().__init__()
        self.cfg = cfg
        gdim = cfg.embedding_dim
        add_dim = 512 if cfg.with_clip else 0
        enc_out = gdim * 2 + add_dim
        self.obj_embeddings_ec = nn.Embedding(num_objs + 1, gdim * 2)
        self.pred_embeddings_ec = nn.Embedding(num_preds, gdim * 2)
        common = dict(hidden_dim=gdim * 4, pooling=cfg.gconv_pooling,
                      mlp_normalization=cfg.mlp_normalization,
                      residual=cfg.residual, output_dim=enc_out)
        self.gconv_net_ec = GraphTripleConvNet(
            gdim * 2 + add_dim, gdim * 2 + add_dim,
            num_layers=cfg.gconv_num_layers, **common)
        self.gconv_net_manipulation = GraphTripleConvNet(
            enc_out + gdim + gdim * 2 + add_dim, gdim * 2 + add_dim,
            num_layers=min(cfg.gconv_num_layers, 5), **common)

        if cfg.network_type == "echoscene":
            dims = rel_s_dims(cfg)
            self.rel_s_mlp = MLP(dims, batch_norm=cfg.mlp_normalization,
                                 final_nonlinearity=False)
            sd = cfg.shape_branch.denoiser
            self.shape_denoiser = ShapeDenoiser(
                image_size=sd.image_size, in_channels=sd.in_channels,
                model_channels=sd.model_channels,
                out_channels=sd.out_channels,
                num_res_blocks=sd.num_res_blocks,
                attention_resolutions=tuple(sd.attention_resolutions),
                channel_mult=tuple(sd.channel_mult), num_heads=sd.num_heads,
                transformer_depth=sd.transformer_depth,
                context_dim=sd.context_dim, use_checkpoint=sd.use_checkpoint,
                conditioning_key=sd.conditioning_key,
                message_passing=sd.message_passing,
                enable_t_emb=sd.enable_t_emb,
                gconv_num_layers=sd.gconv_num_layers, num_preds=16,
                obj_dim=dims[-1], factored_upsample=sd.factored_upsample,
                winograd=sd.winograd)
            vq = cfg.shape_branch.vqvae
            self.vqvae = VQVAE(
                n_embed=vq.n_embed, embed_dim=vq.embed_dim, ch=vq.ch,
                ch_mult=tuple(vq.ch_mult), num_res_blocks=vq.num_res_blocks,
                attn_resolutions=tuple(vq.attn_resolutions),
                in_channels=vq.in_channels, out_ch=vq.out_ch,
                z_channels=vq.z_channels, resolution=vq.resolution,
                factored_upsample=vq.factored_upsample)

        ld = cfg.layout_denoiser
        self.layout_denoiser = LayoutDenoiser(
            in_channels=ld.in_channels, model_channels=ld.model_channels,
            out_channels=ld.out_channels, num_res_blocks=ld.num_res_blocks,
            attention_resolutions=tuple(ld.attention_resolutions),
            channel_mult=tuple(ld.channel_mult), num_heads=ld.num_heads,
            transformer_depth=ld.transformer_depth,
            conditioning_key=ld.conditioning_key, concat_dim=ld.concat_dim,
            crossattn_dim=ld.crossattn_dim, enable_t_emb=ld.enable_t_emb,
            gconv_num_layers=ld.gconv_num_layers, num_preds=16,
            obj_dim=enc_out, use_checkpoint=ld.use_checkpoint)

    def _embed_graph(self, view: GraphBatch):
        """[CLIP feature, class / predicate embedding] (init_encoder
        :149-153)."""
        obj_embed = self.obj_embeddings_ec(view.objs)
        pred_embed = self.pred_embeddings_ec(view.preds())
        if self.cfg.with_clip:
            obj_embed = torch.cat([view.text_feats.to(obj_embed.dtype),
                                   obj_embed], dim=1)
            pred_embed = torch.cat([view.rel_feats.to(pred_embed.dtype),
                                    pred_embed], dim=1)
        return obj_embed, pred_embed

    @trace.spanned("encode_context")
    def encode_context(self, batch: SceneBatch, change_noise: torch.Tensor,
                       splice_untouched: Optional[bool] = None
                       ) -> Dict[str, torch.Tensor]:
        """Encoder + manipulator GCNs; change_noise (N, embedding_dim) is
        masked by batch.change_flags (EchoScene.py:345-353)."""
        cfg = self.cfg
        enc, dec = batch.enc, batch.dec
        enc_obj, enc_pred = self._embed_graph(enc)
        latent_obj, _ = self.gconv_net_ec(enc_obj, enc_pred, enc.edges(),
                                          enc.obj_mask, enc.triple_mask)
        dtype = latent_obj.dtype
        latent_obj = latent_obj * batch.enc_obj_mask[:, None].to(dtype)
        change = (change_noise * batch.change_flags[:, None]).to(dtype)
        dec_obj, dec_pred = self._embed_graph(dec)
        man_in = torch.cat([latent_obj, change, dec_obj], dim=1)
        latent_man, _ = self.gconv_net_manipulation(
            man_in, dec_pred, dec.edges(), dec.obj_mask, dec.triple_mask)
        if splice_untouched is None:
            splice_untouched = not cfg.replace_latent
        if splice_untouched:
            touched = batch.change_flags[:, None].to(dtype)
            latent = latent_obj * (1 - touched) + latent_man * touched
        else:
            latent = latent_man
        out = {"latent": latent, "obj_embed": dec_obj}
        if cfg.network_type == "echoscene":
            out["uc_s"] = self.rel_s_mlp(dec_obj, dec.obj_mask)
            out["c_s"] = self.rel_s_mlp(latent, dec.obj_mask)
        return out

    @contextlib.contextmanager
    def layout_graphs(self):
        """The scope of one sampling chain on this thread, in which
        `layout_eps` replays CUDA graphs (module docstring).  Its graphs,
        their inputs and outputs are dropped when it closes, also when the
        chain raises."""
        scopes = _open_scopes()
        scopes[self] = {}
        try:
            yield
        finally:
            scopes.pop(self, None)

    def _layout_graph_key(self, args) -> Optional[tuple]:
        """The signature a call of `layout_eps` is graphed under, or None
        where it runs eagerly: outside a scope, with autograd recording,
        in training mode, or off GRAPH_DEVICE."""
        dev = args[0].device
        if (self not in _open_scopes() or torch.is_grad_enabled()
                or self.training or dev.type != GRAPH_DEVICE
                or any(a.device != dev for a in args)):
            return None
        return (dev,) + tuple((a.shape, a.stride(), a.dtype) for a in args)

    def _layout_forward(self, box_t, t, obj_embed, triples, obj_mask,
                        triple_mask) -> torch.Tensor:
        return self.layout_denoiser(box_t, obj_embed, triples, t,
                                    obj_mask=obj_mask, triple_mask=triple_mask)

    @trace.spanned("layout_eps")
    def layout_eps(self, box_t: torch.Tensor, t: torch.Tensor,
                   obj_embed: torch.Tensor, triples: torch.Tensor,
                   obj_mask: torch.Tensor,
                   triple_mask: torch.Tensor) -> torch.Tensor:
        """One layout denoiser evaluation; obj_embed is the unconditioned
        stream (raw embedding + CLIP).  Inside `layout_graphs()` it may
        capture (span `layout_capture`) and replay (`layout_graph`) a CUDA
        graph of the denoiser."""
        args = (box_t, t, obj_embed, triples, obj_mask, triple_mask)
        key = self._layout_graph_key(args)
        if key is None:
            return self._layout_forward(*args)
        graphs = _open_scopes()[self]
        if key not in graphs:
            graphs[key] = None
            return self._layout_forward(*args)
        if graphs[key] is None:
            with trace.span("layout_capture"):
                graphs[key] = _LayoutGraph(self._layout_forward, args)
        with trace.span("layout_graph"):
            return graphs[key].replay(args)

    @trace.spanned("shape_eps")
    def shape_eps(self, z_t: torch.Tensor, t: torch.Tensor,
                  obj_embed: torch.Tensor, triples: torch.Tensor,
                  obj_mask: torch.Tensor,
                  triple_mask: torch.Tensor) -> torch.Tensor:
        """One shape denoiser evaluation over M object slots."""
        return self.shape_denoiser(z_t, obj_embed, triples, t,
                                   obj_mask=obj_mask, triple_mask=triple_mask)

    @trace.spanned("decode_chunk")
    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        """Quantize + decode to a 64^3 SDF grid (decode_no_quant)."""
        return self.vqvae.decode_no_quant(z)

    @torch.no_grad()
    def encode_sdf(self, sdf: torch.Tensor, chunk: int = 8) -> torch.Tensor:
        """Frozen VQ-VAE pre-quant encode, (M, R, R, R, 1) -> (M, r, r, r,
        z), without gradients (echo2shape.py:348-349); chunked as JAX
        chunks it, by `chunk` rows when M is a multiple above it."""
        m = sdf.shape[0]
        if m % chunk == 0 and m > chunk:
            return torch.cat([self.vqvae.encode_no_quant(sdf[i:i + chunk])
                              for i in range(0, m, chunk)], 0)
        return self.vqvae.encode_no_quant(sdf)

    def select_shape_subbatch(self, batch: SceneBatch):
        """(obj_mask, triples, triple_mask) of the shape sub-batch
        (select_sdfs, EchoScene.py:246-319): greedy takes the scene-major
        prefix of `num_valid` rows with the graph's triples remapped onto
        it; random / balance rows carry no triples (mp_valid False)."""
        shapes = batch.shapes
        m, nv = shapes.capacity, shapes.num_valid
        s, o = batch.dec.triples[:, 0], batch.dec.triples[:, 2]
        mp = 1.0 if shapes.mp_valid else 0.0
        tri_mask = (batch.dec.triple_mask * mp * (s < nv).float()
                    * (o < nv).float())
        triples = torch.stack([s.clamp(max=m - 1), batch.dec.triples[:, 1],
                               o.clamp(max=m - 1)], dim=1)
        return shapes.mask(), triples, tri_mask

    def train_forward(self, batch: SceneBatch, change_noise: torch.Tensor,
                      box_xt: torch.Tensor, t_box: torch.Tensor,
                      shape_noise: Optional[torch.Tensor] = None,
                      t_shape: Optional[torch.Tensor] = None,
                      sqrt_ac: Optional[torch.Tensor] = None,
                      sqrt_1m_ac: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """The joint forward of one training step (Sg2ScDiffModel.forward,
        EchoScene.py:328-386): the shared graph context, the layout
        denoiser on the noised boxes, and the shape denoiser on the VQ
        latents noised here with the caller's coefficients gathered at
        t_shape.  Returns eps_box, and eps_shape and shape_mask for
        echoscene."""
        ctx = self.encode_context(batch, change_noise)
        out = {"eps_box": self.layout_eps(box_xt, t_box, ctx["obj_embed"],
                                          batch.dec.triples,
                                          batch.dec.obj_mask,
                                          batch.dec.triple_mask)}
        if self.cfg.network_type == "echoscene":
            shapes = batch.shapes
            z0 = (shapes.latent if shapes.latent is not None
                  else self.encode_sdf(shapes.sdf))
            bc = (slice(None),) + (None,) * (z0.dim() - 1)
            z_t = sqrt_ac[bc] * z0 + sqrt_1m_ac[bc] * shape_noise
            obj_mask, triples, tri_mask = self.select_shape_subbatch(batch)
            uc_s = shapes.gather_rows(ctx["uc_s"])[:, None, :]
            out["eps_shape"] = self.shape_eps(z_t, t_shape, uc_s, triples,
                                              obj_mask, tri_mask)
            out["shape_mask"] = obj_mask
        return out

    forward = train_forward
