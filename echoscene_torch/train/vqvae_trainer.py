"""Standalone VQ-VAE training.

Port of echoscene_tpu/train/vqvae_trainer.py (the reference downloads its
VQ-VAE, and its own trainer is broken legacy):
  * loss: L1 reconstruction + codebook_weight x the codebook loss (VQLoss,
    model/losses.py:63-82), with JAX's log keys;
  * optimizer: Adam as `optax.adam(lr)` (b1 0.9, b2 0.999, eps 1e-8, no
    weight decay, no clipping, a constant lr); `torch.optim.Adam` with
    those arguments computes the same update;
  * eval metric: occupancy IoU at SDF threshold 0 between input and
    reconstruction (model/diff_utils/util.py:111-131), the best kept by the
    CLI (vqvae_model.py:158-168).

Precision: the module holds f32 master parameters and Adam's state is f32.
compute_dtype None (the default, JAX's) trains in f32, so on CUDA the
4096-token mid attention of the encoder and of the decoder launches the f32
K2 kernel (`kernels/flash_attention.py`), differentiable through
`KernelAttention`.  compute_dtype "bfloat16" runs the forward on bf16 casts
of the convolutions' weights and biases, made once per step with autograd
(`torch.func.functional_call`), as JAX's `dtype=bfloat16` casts only
`nn.Conv`: the norms keep f32 parameters and statistics, the codebook stays
f32 and its distances and loss are f32.  TF32 is off (`set_precision`).

The trained module's state_dict slots into the joint model's `vqvae`
(`train/checkpoint.py` `load_vqvae_params`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..models.config import VQVAEConfig
from ..models.sgdiff import set_precision
from ..nn.layers import Conv3d
from ..nn.vqvae import VQVAE

COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class VQTrainState:
    """JAX's VQTrainState: the module (its parameters are JAX's `params`),
    the Adam optimizer (JAX's `opt_state`) and the step count."""
    module: VQVAE
    optimizer: torch.optim.Adam
    step: int = 0


def voxel_iou(x_gt: torch.Tensor, x_rec: torch.Tensor,
              thres: float = 0.0) -> torch.Tensor:
    """Occupied-space IoU per item; occupancy = sdf <= thres
    (diff_utils/util.py:111-131)."""
    gt = x_gt <= 0.0
    rec = x_rec <= thres
    dims = tuple(range(1, x_gt.dim()))
    inter = torch.logical_and(gt, rec).sum(dims)
    union = torch.logical_or(gt, rec).sum(dims)
    return inter / (union + 1e-12)


def build_vqvae(cfg: VQVAEConfig) -> VQVAE:
    return VQVAE(n_embed=cfg.n_embed, embed_dim=cfg.embed_dim, ch=cfg.ch,
                 ch_mult=tuple(cfg.ch_mult),
                 num_res_blocks=cfg.num_res_blocks,
                 attn_resolutions=tuple(cfg.attn_resolutions),
                 in_channels=cfg.in_channels, out_ch=cfg.out_ch,
                 z_channels=cfg.z_channels, resolution=cfg.resolution)


@torch.no_grad()
def init_vqvae_(module: VQVAE, generator: torch.Generator) -> None:
    """Draw every parameter from `generator`, on the module's device, with
    torch's default initialisation: convolution weights and biases uniform
    in +-1/sqrt(fan_in), norms at scale 1 and bias 0, and the codebook
    uniform in +-1/n_embed (quantizer.py:27)."""
    for m in module.modules():
        if isinstance(m, Conv3d):
            bound = 1.0 / float(np.sqrt(m.weight[0].numel()))
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, torch.nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    book = module.quantize.embedding.weight
    lim = 1.0 / book.shape[0]
    book.uniform_(-lim, lim, generator=generator)


def cast_parameters(module: VQVAE, dtype: Optional[torch.dtype]
                    ) -> Dict[str, torch.Tensor]:
    """The parameters the forward runs on: with a dtype, the convolutions'
    weights and biases cast to it (with autograd), the rest as they are."""
    params = dict(module.named_parameters())
    if dtype is not None:
        for prefix, m in module.named_modules():
            if isinstance(m, Conv3d):
                for n in ("weight", "bias"):
                    params[f"{prefix}.{n}"] = params[f"{prefix}.{n}"].to(dtype)
    return params


class VQVAETrainer:
    def __init__(self, cfg: VQVAEConfig, lr: float = 1e-4,
                 codebook_weight: float = 1.0,
                 compute_dtype: Optional[str] = None, device="cuda"):
        if compute_dtype not in COMPUTE_DTYPES:
            raise NotImplementedError(f"compute_dtype {compute_dtype}")
        set_precision()
        self.cfg = cfg
        self.lr = lr
        self.codebook_weight = codebook_weight
        self.dtype = COMPUTE_DTYPES[compute_dtype]
        self.device = torch.device(device)
        self.best_iou = -1.0

    def init(self, generator: torch.Generator) -> VQTrainState:
        """A fresh state on the trainer's device, its weights drawn from
        `generator` (a generator of that device)."""
        module = build_vqvae(self.cfg).to(self.device)
        init_vqvae_(module, generator)
        return VQTrainState(module=module, optimizer=torch.optim.Adam(
            module.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=0.0))

    def apply(self, module: VQVAE, x: torch.Tensor, **kwargs):
        """module(x, **kwargs) in the compute dtype."""
        if self.dtype is None:
            return module(x, **kwargs)
        return torch.func.functional_call(
            module, cast_parameters(module, self.dtype), (x.to(self.dtype),),
            kwargs)

    def loss_fn(self, module: VQVAE, batch: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        rec, codebook_loss = self.apply(module, batch)
        rec_loss = torch.mean(torch.abs(batch - rec.float()))
        loss = rec_loss + self.codebook_weight * codebook_loss
        return loss, {"loss_total": loss, "loss_rec": rec_loss,
                      "loss_codebook": codebook_loss}

    def train_step(self, state: VQTrainState, batch: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """One Adam step on `batch` (B, R, R, R, 1); advances state.step and
        returns the logs (detached device tensors)."""
        module, opt = state.module, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss, logs = self.loss_fn(module, batch.to(self.device))
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        state.step += 1
        return {k: v.detach() for k, v in logs.items()}

    @torch.no_grad()
    def eval_iou(self, state: VQTrainState, batches: Iterable,
                 thres: float = 0.0) -> Tuple[float, float]:
        """Mean / std (numpy's, ddof 0) reconstruction IoU over an eval set
        (vqvae_model.py:138-156)."""
        ious = []
        for b in batches:
            b = torch.as_tensor(b).to(self.device)
            rec, _ = self.apply(state.module, b)
            ious.append(voxel_iou(b, rec.float(), thres).cpu().numpy())
        allv = np.concatenate(ious)
        return float(allv.mean()), float(allv.std())

    @torch.no_grad()
    def encode(self, state: VQTrainState, sdf: torch.Tensor) -> torch.Tensor:
        """The pre-quantisation latent (B, 16, 16, 16, 3) of SDF grids
        (encode_no_quant), in the compute dtype."""
        return self.apply(state.module, torch.as_tensor(sdf).to(self.device),
                          forward_no_quant=True, encode_only=True)
