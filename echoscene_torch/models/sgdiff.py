"""SGDiff facade: builds the model and the diffusion tables, and samples.

Port of the sampling half of echoscene_tpu/models/sgdiff.py (reference
model/SGDiff.py sample_box_and_shape, Sg2ScDiffModel.sample :388-420):
`sample_fn` runs the graph context, the 1000-step layout DDPM chain and the
100-step shape DDIM chain (each with the echo GCN inside every step) and the
chunked VQ decode.  Training comes with the training slice.

Precision: with cfg.sample_dtype == "bfloat16" (the default) each sampling
call runs a bf16 inference twin: a copy of the module whose parameters are
cast to bf16 once per call (buffers, i.e. batch-norm running statistics,
stay f32, as JAX casts only `params`); norms keep f32 statistics and chain
math is f32.  TF32 is switched off for f32 matmuls and convolutions
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`), so f32 work stays f32.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from ..core import schedules as S
from ..core.graphbatch import SceneBatch
from ..diffusion.ddpm import LayoutDiffusion
from ..diffusion.ldm import ShapeDiffusion
from .config import EchoSceneConfig
from .echo_scene import EchoSceneModule


def shape_row_capacity(batch: SceneBatch, multiple: int = 4) -> int:
    """Row count for the compacted sampling chains: the real nodes (a
    scene-major prefix) rounded up to `multiple`."""
    real = int(batch.dec.obj_mask.sum().item())
    rounded = -(-max(real, 1) // multiple) * multiple
    return min(batch.num_nodes, rounded)


def set_precision() -> None:
    """The port's stated matmul precision: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def inference_twin(module: torch.nn.Module, dtype: torch.dtype
                   ) -> torch.nn.Module:
    """A copy of `module` with its parameters (not buffers) cast to dtype."""
    twin = copy.deepcopy(module).eval()
    for p in twin.parameters():
        p.data = p.data.to(dtype)
        p.requires_grad_(False)
    return twin


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
                 device="cuda"):
        set_precision()
        if cfg.sample_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(f"sample_dtype {cfg.sample_dtype}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.module = EchoSceneModule(cfg, num_objs, num_preds).to(
            self.device).eval()
        lc = cfg.layout_diffusion
        if lc.sampler != "ddpm":
            raise NotImplementedError(f"layout sampler {lc.sampler}")
        self.layout_diff = LayoutDiffusion(
            S.make_diffusion_tables(S.get_betas(
                lc.schedule_type, lc.beta_start, lc.beta_end, lc.time_num)),
            model_mean_type=lc.model_mean_type,
            model_var_type=lc.model_var_type)
        self.is_echoscene = cfg.network_type == "echoscene"
        if self.is_echoscene:
            sb = cfg.shape_branch
            if sb.sampler != "ddim":
                raise NotImplementedError(f"shape sampler {sb.sampler}")
            sd = sb.denoiser
            self.shape_diff = ShapeDiffusion(S.make_diffusion_tables(
                S.ldm_linear_betas(sd.linear_start, sd.linear_end,
                                   sd.timesteps)))
            self.ddim_tables = self.shape_diff.make_ddim_tables(
                sb.ddim_steps, sb.ddim_eta)

    def inference_module(self) -> EchoSceneModule:
        """The module sampling runs: the bf16 twin, or the f32 module."""
        if self.cfg.sample_dtype == "bfloat16":
            return inference_twin(self.module, torch.bfloat16)
        return self.module

    @torch.no_grad()
    def sample_fn(self, batch: SceneBatch,
                  generator: Optional[torch.Generator] = None,
                  gen_shape: bool = True, with_manipulation: bool = False,
                  decode_chunk: int = 8, shape_rows: Optional[int] = None,
                  noise: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
        """Generate layouts (full DDPM chain) and shapes (DDIM + VQ decode).

        shape_rows: row count of both chains (>= the real-node count, see
        `shape_row_capacity`); nodes are scene-major with padding at the
        tail, so the chains run over that prefix with triples clipped into
        it, and outputs for later rows are zeros.
        noise: optional injected draws, each used in place of the generator:
          "change"     (N, embedding_dim) manipulation change code,
          "box_x_T"    (N, 8) initial layout state,
          "box_steps"  (T, N, 8) per-step layout noise, chain order,
          "shape_x_T"  one latent grid broadcast over the rows.
        Returns sizes / translations / angles / keep and, with gen_shape,
        shapes (N, 64, 64, 64, 1), the JAX output dict.
        """
        cfg = self.cfg
        dev = self.device
        noise = noise or {}
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
        vec8 = self.layout_diff.sample_chain(
            lambda x, t: model.layout_eps(x, t, obj_embed, triples, obj_mask,
                                          tri_mask),
            (m, cfg.layout_denoiser.in_channels), clip_denoised=False,
            noise_rows=n, x_T=noise.get("box_x_T"),
            step_noise=noise.get("box_steps"), generator=generator,
            device=dev)
        if m < n:
            vec8 = torch.cat([vec8, vec8.new_zeros((n - m, vec8.shape[1]))], 0)
        out = dict(self.layout_diff.split_sample(vec8))
        out["keep"] = 1.0 - batch.change_flags

        if gen_shape and self.is_echoscene:
            sb = cfg.shape_branch
            r, zc = sb.denoiser.image_size, sb.vqvae.embed_dim
            uc_s = ctx["uc_s"][:m, None, :]
            x_T = self.shape_diff.shared_noise(
                m, (r, r, r, zc), generator=generator, device=dev,
                single=noise.get("shape_x_T"))
            z0 = self.shape_diff.ddim_sample_chain(
                lambda z, t: model.shape_eps(z, t, uc_s, triples, obj_mask,
                                             tri_mask),
                (m, r, r, r, zc), self.ddim_tables, x_T=x_T,
                generator=generator, device=dev)
            # chunked decode over rows zero-padded to a chunk multiple
            mp = -(-m // decode_chunk) * decode_chunk
            if mp > m:
                z0 = torch.cat([z0, z0.new_zeros((mp - m,) + z0.shape[1:])], 0)
            sdf = torch.cat([model.decode_latent(z0[i:i + decode_chunk])
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
