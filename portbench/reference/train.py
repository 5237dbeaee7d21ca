"""The published training step in plain float32 PyTorch: the benchmark's
reference for training cells.

One step on a batch (EchoScene.py:328-386 with the layout branch's eps loss
and the shape branch's latent-diffusion eps loss, train_3dfront.py:249-261):

  * the graph context with batch-norm statistics over the real rows, the
    layout denoiser on the boxes noised at one timestep a scene, the frozen
    VQ-VAE's pre-quantisation encoding of the shape sub-batch's SDFs
    (the greedy prefix of whole scenes), noised at one timestep a row, and
    the shape denoiser on it, conditioned on rel_s_mlp of the node stream;
  * loss = masked mean over objects of the box eps error + masked mean over
    the shape rows of the latent eps error (l_simple weight 1);
  * gradients of every parameter but the VQ-VAE's (a parameter the step
    never reads gets a zero gradient), the shape denoiser's scaled to
    global norm <= 5, NaN set to 0;
  * AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4, decoupled) at
    the piecewise-constant learning rate of the step count.

The noise is handed in (`draws`), so the reference takes the same draws as
the program.  Recompute (torch.utils.checkpoint) keeps a float32 step in
memory, as the published `use_checkpoint` does.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .model import EchoScene

BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 1e-4
CLIP = 5.0


def _tables(betas: np.ndarray, device):
    ac = np.cumprod(1.0 - betas)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return f32(np.sqrt(ac)), f32(np.sqrt(1.0 - ac))


class Tables:
    """sqrt(alpha_bar) and sqrt(1 - alpha_bar) of both branches."""

    def __init__(self, cfg: Dict, device):
        d = cfg["layout_branch"]["diffusion_kwargs"]
        self.layout = _tables(np.linspace(d["beta_start"], d["beta_end"],
                                          d["time_num"], dtype=np.float64),
                              device)
        m = cfg["shape_branch"]["model"]
        self.shape = _tables(np.linspace(m["linear_start"] ** 0.5,
                                         m["linear_end"] ** 0.5,
                                         m["timesteps"],
                                         dtype=np.float64) ** 2, device)


def learning_rate(cfg: Dict, count: int) -> float:
    h = cfg["hyper"]
    lrs = [h["lr_init"]] + list(h["lr_evo"])
    lr = h["lr_init"]
    for i, boundary in enumerate(h["lr_step"]):
        if count >= boundary:
            lr *= lrs[i + 1] / lrs[i]
    return lr


def masked_mean(x, mask):
    return (x * mask).sum() / mask.sum().clamp_min(1.0)


def trainable(model: EchoScene):
    return [(n, p) for n, p in model.named_parameters()
            if not n.startswith("vqvae.")]


def loss(model: EchoScene, tables: Tables, g: Dict, sdf: torch.Tensor,
         valid: int, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The step's total loss on graph batch `g` with its shape sub-batch
    (`sdf`, of which the first `valid` rows are real)."""
    sq, s1 = tables.layout
    t_box = draws["t_scene"][g["obj_to_scene"]]
    b = g["boxes"]
    x0 = torch.cat([b[:, :6], torch.sin(b[:, 6:7]), torch.cos(b[:, 6:7])], 1)
    x_t = sq[t_box][:, None] * x0 + s1[t_box][:, None] * draws["noise_box"]
    ctx = model.encode_context(g, draws["change"])
    eps_box = model.layout_eps(x_t, t_box, ctx["obj_embed"], g["triples"],
                               g["obj_mask"], g["triple_mask"])
    layout = masked_mean(((draws["noise_box"] - eps_box) ** 2).mean(-1),
                         g["obj_mask"])
    rows = sdf.shape[0]
    with torch.no_grad():
        z0 = torch.cat([model.vqvae.encode_no_quant(sdf[i:i + 8])
                        for i in range(0, rows, 8)])
    sq, s1 = tables.shape
    t = draws["t_shape"]
    bc = (slice(None),) + (None,) * 4
    z_t = sq[t][bc] * z0 + s1[t][bc] * draws["noise_shape"]
    s, o = g["triples"][:, 0], g["triples"][:, 2]
    tri_mask = g["triple_mask"] * (s < valid).float() * (o < valid).float()
    triples = torch.stack([s.clamp(max=rows - 1), g["triples"][:, 1],
                           o.clamp(max=rows - 1)], 1)
    mask = (torch.arange(rows, device=sdf.device) < valid).float()
    eps = model.shape_eps(z_t, t, ctx["uc_s"][:rows, None, :], triples,
                          mask, tri_mask)
    shape = masked_mean(((eps - draws["noise_shape"]) ** 2).mean(
        dim=(1, 2, 3, 4)), mask)
    return layout + shape


class AdamW:
    """torch.optim.AdamW's arithmetic written out, on a list of tensors."""

    def __init__(self, params: List[torch.Tensor]):
        self.params = params
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        self.count += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - lr * WEIGHT_DECAY)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, v.sqrt() / c2 ** 0.5 + EPS, value=-lr / c1)


def gradients(model: EchoScene, total: torch.Tensor) -> List[torch.Tensor]:
    """The gradients of every trainable parameter (zeros where the step
    never reads one), before the clip."""
    named = trainable(model)
    grads = torch.autograd.grad(total, [p for _, p in named],
                                allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for (_, p), g in zip(named, grads)]


@torch.no_grad()
def clip_(model: EchoScene, grads: List[torch.Tensor]) -> None:
    """In place: the shape denoiser's gradients scaled to global norm <=
    CLIP, then NaN set to 0."""
    shape = [g for (n, _), g in zip(trainable(model), grads)
             if n.startswith("shape_denoiser.")]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in shape]))
    scale = torch.clamp(CLIP / torch.clamp_min(norm, 1e-6), max=1.0)
    for g in shape:
        g.mul_(scale)
    for g in grads:
        torch.nan_to_num_(g, nan=0.0)
