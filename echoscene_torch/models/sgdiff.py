"""SGDiff facade: builds the model, the diffusion tables and the optimizer;
trains and samples.

Port of echoscene_tpu/models/sgdiff.py (reference model/SGDiff.py and
EchoScene.optimizer_ini / lr_lambda, EchoScene.py:117-141):
  * `loss_fn` / `train_step`: both branches' losses, their gradients, the
    shape denoiser's gradient clipped at norm 5 and NaN gradients zeroed
    (train_3dfront.py:249-261), AdamW over everything but the frozen VQ-VAE
    with a piecewise-constant lr, and gradient accumulation as
    optax.MultiSteps (the clip runs on the accumulated mean);
  * `sample_fn`: the graph context, the layout chain (the 1000-step DDPM
    chain, or JAX's few-step DDIM / DPM-Solver++ over `sample_steps`) and
    the shape chain (DDIM or DPM-Solver++ over `ddim_steps`), each with the
    echo GCN inside every step, and the chunked VQ decode.  The samplers
    are read from the live config at every call, as in JAX.

Both calls mark their parts with `trace.span` (sampling: the twin build,
the chains, the decode; training: forward, backward, the gradient norm,
the clip, AdamW), which records only while a `torch.profiler` runs.  The
layout chain runs inside its module's `layout_graphs()` scope, so that on
the card its denoiser steps replay a CUDA graph (`models/echo_scene.py`).

Precision: the module holds f32 master parameters; the AdamW state is f32.
With cfg.compute_dtype == "bfloat16" (the default) each training step runs
the module on bf16 casts of its parameters, made once per step with
autograd (`torch.func.functional_call`), so gradients land on the f32
masters; buffers (batch-norm running statistics) stay f32 and are updated
in place, norms keep f32 statistics and the losses are f32.  With
cfg.sample_dtype == "bfloat16" (the default) each sampling call runs a bf16
inference twin: a copy of the module whose parameters are cast to bf16 once
per call (buffers stay f32, as JAX casts only `params`).  TF32 is switched
off for f32 matmuls and convolutions
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`), so f32 work stays f32 (the
f32 attention kernel splits each operand for three TF32 products, which
keeps f32 accuracy: `kernels/flash_attention.py`).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..core import schedules as S
from ..core.boxes import box_vec_from_boxes
from ..core.graphbatch import SceneBatch
from ..diffusion.ddpm import LayoutDiffusion
from ..diffusion.ldm import ShapeDiffusion
from ..nn.blocks import Downsample, ResBlock, Upsample, WinogradConv3d
from ..nn.quant import Int8Conv3d, jax_rounding_
from ..nn.vqvae import Upsample3D
from .config import EchoSceneConfig
from .echo_scene import EchoSceneModule


def shape_row_capacity(batch: SceneBatch, multiple: int = 4) -> int:
    """Row count for the compacted sampling chains: the real nodes (a
    scene-major prefix) rounded up to `multiple`."""
    real = int(batch.dec.obj_mask.sum().item())
    rounded = -(-max(real, 1) // multiple) * multiple
    return min(batch.num_nodes, rounded)


def set_precision() -> None:
    """The port's stated matmul precision: no TF32 in PyTorch's f32
    matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def inference_twin(module: torch.nn.Module, dtype: torch.dtype,
                   int8: bool = False,
                   winograd: bool = False) -> torch.nn.Module:
    """A copy of `module` with its parameters (not buffers) cast to dtype:
    JAX's bf16 sampling twin (echoscene_tpu/models/sgdiff.py:143-157).  As
    there, its shape denoiser's and VQ-VAE's 3D upsamples
    (`nn.blocks.Upsample`, `nn.vqvae.Upsample3D`) run the exact factored
    form, whose conv bias stays f32 (JAX's FactoredUpsampleConv adds the
    f32 parameter); every other parameter is in dtype.

    `int8` is the W8A8 twin (`sample_dtype: int8`): the shape denoiser's
    torso convolutions (conv_in, each ResBlock's two 3x3x3 convolutions and
    1x1x1 skip, each Downsample, each Upsample, in its quantized factored
    form, and the output convolution) become `nn.quant.Int8Conv3d`, which
    keep their f32 parameters and quantize the weight once, here; the rest
    is the dtype twin (JAX's `_conv` under the int8 sentinel,
    echoscene_tpu/nn/blocks.py:288-292).  `winograd` (`sample_conv:
    winograd`) makes each ResBlock's 3x3x3 convolutions and each Upsample's
    convolution WinogradConv3d (f32 weight, the transformed weight made
    once in dtype) and turns the shape denoiser's upsamples back to
    interpolate + conv; int8 takes precedence (blocks.py:288-295).  The
    int8 twin also rounds around its quantized convolutions where JAX's
    bf16 ops round (`nn.quant.jax_rounding_`).

    For a module sharded by `parallel.tp.shard_module_`, each tensor-parallel
    ResBlock's `out_layers.3` becomes the row-split form of its int8 /
    Winograd convolution (parallel/tp.py); the int8 twin's weight scales
    are then a MAX over the model group, so every rank of the group must
    build the twin, as every rank samples."""
    twin = copy.deepcopy(module).eval()
    sd = getattr(twin, "shape_denoiser", None)
    for name in ("shape_denoiser", "vqvae"):
        for m in getattr(twin, name, torch.nn.Module()).modules():
            if isinstance(m, (Upsample, Upsample3D)):
                m.factored = True
                if isinstance(m, Upsample) and winograd:
                    m.winograd = m.dims == 3
    cfg = getattr(twin, "cfg", None)
    if cfg is not None:
        cfg.shape_branch.denoiser.factored_upsample = True
        cfg.shape_branch.vqvae.factored_upsample = True
        cfg.shape_branch.denoiser.winograd |= winograd
    keep = set()
    if sd is not None and int8:
        with trace.span("twin_int8"):
            keep = _convert_torso_convs(sd, dtype, int8, winograd)
            keep |= jax_rounding_(sd)
    elif sd is not None and winograd:
        keep = _convert_torso_convs(sd, dtype, int8, winograd)
    keep |= {id(m.conv.bias) for m in twin.modules()
             if isinstance(m, (Upsample, Upsample3D)) and m.factored
             and m.conv.bias is not None}
    for p in twin.parameters():
        if id(p) not in keep:
            p.data = p.data.to(dtype)
        p.requires_grad_(False)
    return twin


def _convert_torso_convs(sd: torch.nn.Module, dtype: torch.dtype,
                         int8: bool, winograd: bool) -> set:
    """Swap the shape denoiser's torso convolutions for the int8 / Winograd
    forms in place; returns the ids of their parameters, which stay f32."""
    sites = []   # (parent, child name, conv, role)
    sites.append((sd.input_blocks[0], "0", sd.input_blocks[0][0], "edge"))
    sites.append((sd.out, "2", sd.out[2], "edge"))
    row_splits = {}   # id(conv) -> the tensor-parallel plan of its block
    for m in sd.modules():
        if isinstance(m, ResBlock):
            sites.append((m.in_layers, "2", m.in_layers[2], "3x3"))
            sites.append((m.out_layers, "3", m.out_layers[3], "3x3"))
            if getattr(m, "tp", None) is not None:
                row_splits[id(m.out_layers[3])] = m.tp
            if isinstance(m.skip_connection, torch.nn.Conv3d):
                sites.append((m, "skip_connection", m.skip_connection,
                              "edge"))
        elif isinstance(m, Downsample) and isinstance(m.op, torch.nn.Conv3d):
            sites.append((m, "op", m.op, "edge"))
        elif isinstance(m, Upsample) and m.dims == 3:
            sites.append((m, "conv", m.conv, "up"))
    keep = set()
    for parent, key, conv, role in sites:
        if int8:
            up = (1, 2) if role == "up" and parent.factored and not \
                parent.winograd else None
            new = Int8Conv3d(conv, up_axes=up,
                             row_split=row_splits.get(id(conv)))
        elif role in ("3x3", "up"):
            if not isinstance(conv, WinogradConv3d):
                conv = WinogradConv3d.from_conv(conv)
            new = conv.prepare_(dtype)
        else:
            continue
        setattr(parent, key, new)
        keep |= {id(p) for p in new.parameters()}
    return keep


def lr_schedule(cfg: EchoSceneConfig) -> Callable[[int], float]:
    """Piecewise-constant lr of the optimizer-step count (EchoScene.lr_lambda
    :117-128), as optax.piecewise_constant_schedule: lr_init times the ratio
    of each later lr whose boundary the count has reached (count >=
    boundary)."""
    lrs = [cfg.lr_init] + list(cfg.lr_evo)
    scales = sorted({int(b): lrs[i + 1] / lrs[i]
                     for i, b in enumerate(cfg.lr_step)}.items())

    def schedule(count: int) -> float:
        lr = cfg.lr_init
        for boundary, scale in scales:
            if count >= boundary:
                lr *= scale
        return lr

    return schedule


def trainable_parameters(module: torch.nn.Module
                         ) -> List[Tuple[str, torch.nn.Parameter]]:
    """Every parameter but the frozen VQ-VAE's (JAX labels those "frozen"
    and gives them `set_to_zero`)."""
    return [(n, p) for n, p in module.named_parameters()
            if not n.startswith("vqvae.")]


def make_optimizer(module: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW with optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8, weight
    decay 1e-4) over the trainable parameters; the VQ-VAE's stop requiring
    gradients.  The lr is set before every step from `lr_schedule`."""
    for n, p in module.named_parameters():
        p.requires_grad_(not n.startswith("vqvae."))
    return torch.optim.AdamW([p for _, p in trainable_parameters(module)],
                             lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


@torch.no_grad()
def clip_and_sanitize_grads(names: Sequence[str],
                            grads: Sequence[torch.Tensor],
                            max_norm: float = 5.0,
                            norm: Optional[Callable] = None) -> None:
    """In place: the shape denoiser's gradients scaled by min(1, max_norm /
    max(norm, 1e-6)) of their global norm, then NaN -> 0 on every gradient
    (train_3dfront.py:253-259, JAX's formula, not clip_grad_norm_'s).  A
    NaN norm makes the scale NaN, so the whole shape subtree is zeroed.
    `norm(names, tensors)` computes the global norm (`global_norm` of the
    tensors by default; tensor parallelism passes the norm of the logical,
    unsharded tensors)."""
    named = [(n, g) for n, g in zip(names, grads)
             if n.startswith("shape_denoiser.")]
    shape = [g for _, g in named]
    if shape:
        norm = (global_norm(shape) if norm is None
                else norm([n for n, _ in named], shape))
        scale = torch.minimum(torch.ones_like(norm), max_norm / torch.maximum(
            norm, torch.full_like(norm, 1e-6)))
        torch._foreach_mul_(shape, scale)
    for g in grads:
        torch.nan_to_num_(g, nan=0.0)


@dataclasses.dataclass
class TrainState:
    """What JAX's TrainState holds beside params and batch stats (which
    live in the module): the step count (train_step calls), the epoch, the
    AdamW optimizer (its per-parameter step is optax's count; under ZeRO-1
    a `parallel.zero.Zero1State` in its place, as JAX swaps opt_state), and
    the running mean of the micro-batch gradients under accumulation
    (optax.MultiSteps' acc_grads; None between optimizer steps)."""
    optimizer: torch.optim.AdamW
    step: int = 0
    epoch: int = 0
    accum: Optional[List[torch.Tensor]] = None


def compact_graph(batch: SceneBatch, m: int):
    """(triples, obj_mask, triple_mask) of the decoder graph restricted to
    the first m node slots: endpoints clipped into [0, m), edges touching a
    dropped slot masked (exact, since real triples only reference real
    nodes, which are a prefix)."""
    triples, tri_mask = batch.dec.triples, batch.dec.triple_mask
    if m < batch.num_nodes:
        s, o = triples[:, 0], triples[:, 2]
        tri_mask = tri_mask * (s < m).float() * (o < m).float()
        triples = torch.stack([s.clamp(max=m - 1), triples[:, 1],
                               o.clamp(max=m - 1)], dim=1)
    return triples, batch.dec.obj_mask[:m], tri_mask


class SGDiff:
    """Owns the module (f32 master parameters) and the diffusion tables."""

    def __init__(self, cfg: EchoSceneConfig, num_objs: int, num_preds: int,
                 device="cuda", iou_stats: Optional[np.ndarray] = None):
        set_precision()
        if cfg.sample_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"sample_dtype {cfg.sample_dtype}")
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(f"compute_dtype {cfg.compute_dtype}")
        if cfg.sample_conv not in ("direct", "winograd"):
            raise ValueError(f"sample_conv {cfg.sample_conv!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.module = EchoSceneModule(cfg, num_objs, num_preds).to(
            self.device).eval()
        lc = cfg.layout_diffusion
        self.layout_diff = LayoutDiffusion(
            S.make_diffusion_tables(S.get_betas(
                lc.schedule_type, lc.beta_start, lc.beta_end, lc.time_num)),
            model_mean_type=lc.model_mean_type,
            model_var_type=lc.model_var_type, loss_iou=lc.loss_iou,
            iou_type=lc.iou_type, iou_stats=iou_stats)
        self.is_echoscene = cfg.network_type == "echoscene"
        # both fast layout tables are built (tiny (S,) arrays): sample_fn
        # dispatches on the live cfg.layout_diffusion.sampler, as JAX does
        self.layout_fast_tables = {
            "ddim": self.layout_diff.make_ddim_tables(lc.sample_steps),
            "dpmpp": self.layout_diff.make_dpmpp_tables(lc.sample_steps)}
        if self.is_echoscene:
            sb = cfg.shape_branch
            sd = sb.denoiser
            self.shape_diff = ShapeDiffusion(S.make_diffusion_tables(
                S.ldm_linear_betas(sd.linear_start, sd.linear_end,
                                   sd.timesteps)))
            if sb.sampler == "dpmpp":
                self.ddim_tables = self.shape_diff.make_dpmpp_tables(
                    sb.ddim_steps)
            else:
                self.ddim_tables = self.shape_diff.make_ddim_tables(
                    sb.ddim_steps, sb.ddim_eta)

    @trace.spanned("twin_build")
    def inference_module(self, device=None) -> EchoSceneModule:
        """The module sampling runs (batch norms on their running
        statistics): the bf16 twin with the factored upsamples (its shape
        denoiser's torso convolutions in int8 under `sample_dtype: int8`,
        its 3x3x3 ones by Winograd under `sample_conv: winograd`), or the
        f32 module as it is configured (JAX's module_infer); on `device`
        (the module's by default; elsewhere a copy)."""
        dev = self.device if device is None else torch.device(device)
        cfg = self.cfg
        if cfg.sample_dtype in ("bfloat16", "int8"):
            return inference_twin(
                self.module, torch.bfloat16,
                int8=cfg.sample_dtype == "int8",
                winograd=(cfg.sample_conv == "winograd"
                          or cfg.shape_branch.denoiser.winograd)).to(dev)
        if dev == self.device:
            return self.module.eval()
        return copy.deepcopy(self.module).to(dev).eval()

    # ------------------------------------------------------------------
    def init_train_state(self) -> TrainState:
        return TrainState(optimizer=make_optimizer(self.module))

    def _train_forward(self, *args, **kwargs) -> Dict[str, torch.Tensor]:
        """The module's joint forward in training mode (the VQ-VAE frozen in
        eval mode), on bf16 casts of the f32 masters when compute_dtype is
        bfloat16."""
        module = self.module.train()
        if self.is_echoscene:
            module.vqvae.eval()
        if self.cfg.compute_dtype == "float32":
            return module(*args, **kwargs)
        with trace.span("cast"):
            cast = {n: p.to(torch.bfloat16)
                    for n, p in module.named_parameters()}
        return torch.func.functional_call(module, cast, args, kwargs)

    def loss_fn(self, batch: SceneBatch,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Both branches' losses on one batch (JAX's loss_fn, sgdiff.py:
        212-281; EchoScene.py:328-386 with diffusion_loss and the shape
        p_losses).  Updates the batch-norm running statistics.

        draws: optional injected random draws, each used in place of the
        generator (JAX splits one key into these five streams):
          "change"      (N, embedding_dim) change code,
          "t_scene"     (num_scenes + 1,) layout timesteps, one per scene,
          "noise_box"   (N, 8) layout noise,
          "t_shape"     (M,) shape timesteps, one per sub-batch row,
          "noise_shape" (M, r, r, r, z) latent noise.
        Returns (total loss, metrics), JAX's metric names."""
        cfg, ld, dev = self.cfg, self.layout_diff, self.device
        draws = draws or {}

        def draw(name, fn):
            x = draws.get(name)
            return fn() if x is None else x.to(dev)

        n = batch.num_nodes
        change = draw("change", lambda: torch.randn(
            (n, cfg.embedding_dim), generator=generator, device=dev))
        t_box = ld.scene_shared_timesteps(batch.obj_to_scene,
                                          batch.num_scenes, generator,
                                          draws.get("t_scene"))
        x0 = box_vec_from_boxes(batch.boxes)
        noise_box = draw("noise_box", lambda: torch.randn(
            x0.shape, generator=generator, device=dev))
        box_xt = ld.q_sample(x0, t_box, noise_box)
        kwargs = {}
        if self.is_echoscene:
            sd = self.shape_diff
            m = batch.shapes.capacity
            r = cfg.shape_branch.denoiser.image_size
            zc = cfg.shape_branch.vqvae.embed_dim
            t_shape = draw("t_shape", lambda: torch.randint(
                0, sd.num_timesteps, (m,), generator=generator, device=dev))
            noise_shape = draw("noise_shape", lambda: torch.randn(
                (m, r, r, r, zc), generator=generator, device=dev))
            kwargs = dict(shape_noise=noise_shape, t_shape=t_shape,
                          sqrt_ac=sd.coef("sqrt_alphas_cumprod", t_shape),
                          sqrt_1m_ac=sd.coef("sqrt_one_minus_alphas_cumprod",
                                             t_shape))
        outs = self._train_forward(batch, change, box_xt, t_box, **kwargs)

        # layout loss (diffusion_loss :451-477), target = noise
        eps_box = outs["eps_box"].float()
        om = batch.dec.obj_mask
        metrics = ld.mse_terms((noise_box - eps_box) ** 2, om)
        layout_loss = metrics["loss.bbox"]
        zero = layout_loss.new_zeros(())
        liou, biou = zero, zero
        if ld.loss_iou:
            liou, biou = ld.iou_loss(box_xt, t_box, eps_box,
                                     batch.same_scene_matrix(), om)
            layout_loss = layout_loss + liou
        metrics.update({"loss.liou": liou, "loss.bbox_iou": biou})
        shape_loss = zero
        if self.is_echoscene:
            # l_simple weight 1, elbo weight 0 (the VLB only logged)
            shape_loss, shape_diag = self.shape_diff.loss_terms(
                outs["eps_shape"].float(), noise_shape, t_shape,
                outs["shape_mask"])
            metrics.update(shape_diag)
        metrics.update({"layout_loss": layout_loss, "shape_loss": shape_loss})
        return layout_loss + shape_loss, metrics

    def loss_and_grads(self, batch: SceneBatch,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                  List[torch.Tensor]]:
        """The gradient half of `train_step`: (loss, metrics, gradients
        aligned with `trainable_parameters`), the parameters' .grad left
        None.  The data-parallel steps (parallel/dp.py, parallel/zero.py)
        reduce these gradients across ranks before their optimizer."""
        params = trainable_parameters(self.module)
        for _, p in params:
            p.grad = None
        with trace.span("forward"):
            loss, metrics = self.loss_fn(batch, generator, draws)
        with trace.span("backward"):
            loss.backward()
        # parameters the forward never reads (to_q / to_k of a one-token
        # cross-attention) get JAX's zero gradients, so AdamW still decays
        # them and their moments
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in params]
        for _, p in params:
            p.grad = None
        return loss.detach(), metrics, grads

    @trace.spanned("train_step")
    def train_step(self, state: TrainState, batch: SceneBatch,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One call of JAX's train_step: loss and gradients on `batch`, then
        the optimizer (every `grad_accum` calls, on the running mean of the
        micro-batch gradients).  Returns the metrics (device tensors),
        with the loss and the global pre-clip gradient norm."""
        loss, metrics, grads = self.loss_and_grads(batch, generator, draws)
        metrics["loss"] = loss
        with trace.span("grad_norm"):
            metrics["grad_norm"] = global_norm(grads)
        self.apply_gradients(state, grads)
        return {k: v.detach() for k, v in metrics.items()}

    def apply_gradients(self, state: TrainState,
                        grads: List[torch.Tensor],
                        norm: Optional[Callable] = None) -> None:
        """The optimizer chain on one call's gradients (aligned with
        `trainable_parameters`), optax.MultiSteps(clip_and_sanitize ->
        adamw) when grad_accum > 1; advances state.step.  `norm` is the
        clip's global norm (see `clip_and_sanitize_grads`)."""
        k = max(1, int(self.cfg.grad_accum or 1))
        mini = state.step % k
        if k > 1:
            if state.accum is None:
                state.accum = [torch.zeros_like(g) for g in grads]
            with torch.no_grad():
                for acc, g in zip(state.accum, grads):
                    acc.add_((g - acc) / (mini + 1))
            grads = state.accum
        if mini == k - 1:
            names = [n for n, _ in trainable_parameters(self.module)]
            with trace.span("clip"):
                clip_and_sanitize_grads(names, grads, norm=norm)
            opt = state.optimizer
            lr = lr_schedule(self.cfg)(state.step // k)
            with trace.span("adamw"):
                for group in opt.param_groups:
                    group["lr"] = lr
                    for p, g in zip(group["params"], grads):
                        p.grad = g
                opt.step()
                for group in opt.param_groups:
                    for p in group["params"]:
                        p.grad = None
            state.accum = None
        state.step += 1

    @torch.no_grad()
    @trace.spanned("sample_fn")
    def sample_fn(self, batch: SceneBatch,
                  generator: Optional[torch.Generator] = None,
                  gen_shape: bool = True, with_manipulation: bool = False,
                  decode_chunk: int = 8, shape_rows: Optional[int] = None,
                  noise: Optional[Dict[str, torch.Tensor]] = None,
                  model: Optional[EchoSceneModule] = None,
                  device=None) -> Dict[str, torch.Tensor]:
        """Generate layouts (the configured layout chain) and shapes (DDIM
        or DPM-Solver++, then the VQ decode).

        shape_rows: row count of both chains (>= the real-node count, see
        `shape_row_capacity`); nodes are scene-major with padding at the
        tail, so the chains run over that prefix with triples clipped into
        it, and outputs for later rows are zeros.
        noise: optional injected draws, each used in place of the generator:
          "change"     (N, embedding_dim) manipulation change code,
          "box_x_T"    (N, 8) initial layout state (every sampler; the
                       chains take its first rows),
          "box_steps"  (T, N, 8) per-step layout noise of the DDPM chain,
                       chain order,
          "shape_x_T"  one latent grid broadcast over the rows.
        model / device: the inference module to run and its device, in
        place of a fresh `inference_module()` on `self.device` (the
        data-parallel sampler keeps one such module per device).
        Returns sizes / translations / angles / keep and, with gen_shape,
        shapes (N, 64, 64, 64, 1), the JAX output dict.
        """
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        noise = noise or {}
        if model is None:
            model = self.inference_module()
        n = batch.num_nodes
        if with_manipulation:
            change = noise.get("change")
            if change is None:
                change = torch.randn((n, cfg.embedding_dim),
                                     generator=generator, device=dev)
            splice = not cfg.replace_latent
        else:
            change = torch.zeros((n, cfg.embedding_dim), device=dev)
            splice = False
        ctx = model.encode_context(batch, change.to(dev), splice)

        m = n if shape_rows is None else min(int(shape_rows), n)
        triples, obj_mask, tri_mask = compact_graph(batch, m)
        obj_embed = ctx["obj_embed"][:m]

        def box_denoise(x, t):
            return model.layout_eps(x, t, obj_embed, triples, obj_mask,
                                    tri_mask)

        box_shape = (m, cfg.layout_denoiser.in_channels)
        lc = cfg.layout_diffusion
        # the denoiser's steps replay a CUDA graph on the card
        with trace.span("layout_chain"), model.layout_graphs():
            if lc.sampler == "ddpm":
                vec8 = self.layout_diff.sample_chain(
                    box_denoise, box_shape, clip_denoised=False,
                    noise_rows=n, x_T=noise.get("box_x_T"),
                    step_noise=noise.get("box_steps"),
                    generator=generator, device=dev)
            else:
                # drawn at n rows and sliced, as JAX draws its x_T
                x_T = noise.get("box_x_T")
                if x_T is None:
                    x_T = torch.randn((n, box_shape[1]),
                                      generator=generator, device=dev)
                vec8 = self.layout_diff.sample_chain_fast(
                    box_denoise, box_shape,
                    self.layout_fast_tables[lc.sampler],
                    method=lc.sampler, x_T=x_T.to(dev)[:m],
                    generator=generator, device=dev)
        if m < n:
            vec8 = torch.cat([vec8, vec8.new_zeros((n - m, vec8.shape[1]))], 0)
        out = dict(self.layout_diff.split_sample(vec8))
        out["keep"] = 1.0 - batch.change_flags

        if gen_shape and self.is_echoscene:
            sb = cfg.shape_branch
            r, zc = sb.denoiser.image_size, sb.vqvae.embed_dim
            uc_s = ctx["uc_s"][:m, None, :]
            chain = (self.shape_diff.dpmpp_sample_chain
                     if sb.sampler == "dpmpp"
                     else self.shape_diff.ddim_sample_chain)
            with trace.span("shape_chain"):
                x_T = self.shape_diff.shared_noise(
                    m, (r, r, r, zc), generator=generator, device=dev,
                    single=noise.get("shape_x_T"))
                z0 = chain(
                    lambda z, t: model.shape_eps(z, t, uc_s, triples,
                                                 obj_mask, tri_mask),
                    (m, r, r, r, zc), self.ddim_tables, x_T=x_T,
                    generator=generator, device=dev)
            # chunked decode over rows zero-padded to a chunk multiple
            with trace.span("decode"):
                mp = -(-m // decode_chunk) * decode_chunk
                if mp > m:
                    z0 = torch.cat(
                        [z0, z0.new_zeros((mp - m,) + z0.shape[1:])], 0)
                sdf = torch.cat(
                    [model.decode_latent(z0[i:i + decode_chunk])
                     for i in range(0, mp, decode_chunk)], 0)[:m]
            if m < n:
                sdf = torch.cat(
                    [sdf, sdf.new_zeros((n - m,) + sdf.shape[1:])], 0)
            out["shapes"] = sdf
        return out

    def sample(self, batch: SceneBatch,
               generator: Optional[torch.Generator] = None,
               gen_shape: bool = True, with_manipulation: bool = False,
               compact: bool = True) -> Dict[str, torch.Tensor]:
        rows = shape_row_capacity(batch) if compact else None
        return self.sample_fn(batch, generator, gen_shape=gen_shape,
                              with_manipulation=with_manipulation,
                              shape_rows=rows)
