"""SDFusion's 3D VQ-VAE and its training step in plain float32 PyTorch: the
benchmark's reference for `vqvae_train` cells.

The model is the VQ-VAE of SDFusion (Cheng et al., CVPR 2023;
`vqvae_networks/network.py`, `vqvae_modules.py`, `quantizer.py`) that
EchoScene trains as its stage 1 (`vqvae_snet.yaml`): `Encoder3D` and
`Decoder3D` as `reference/model.py` states them, a 1x1x1 `quant_conv` and
`post_quant_conv`, and here

  * the vector quantizer: the squared distance of every latent to every
    code, the nearest code, the straight-through estimator, and the
    non-legacy loss with beta on the commitment,
    beta * mean((sg[e] - z)^2) + mean((e - sg[z])^2) (network.py builds it
    with beta 1.0 and legacy False);
  * the loss: mean |x - rec| + codebook_weight x the codebook loss (the L1
    reconstruction and codebook terms of SDFusion's VQ loss);
  * Adam from its equations (b1 0.9, b2 0.999, eps 1e-8, no weight decay,
    a constant learning rate), the optimizer the repository's VQ-VAE
    trainer states.

Departures from the published description:

  * the encoder's and decoder's `attn_resolutions` must be empty, as they
    are in `vqvae_snet.yaml`: `reference/model.py`'s levels hold no
    attention (the middle block's attention is always there);
  * `double_z` (false in the yaml) and `dropout` (0.0) are not read: with
    those values they change nothing.

Everything runs in float32 with TF32 off (`check.plain_f32`): attention is
softmax(q k^T / sqrt(d)) v written out, convolutions are `F.conv3d`.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from .model import Conv, Decoder3D, Encoder3D, Numerics

BETAS = (0.9, 0.999)
EPS = 1e-8


def model_dict(cfg: Dict) -> Dict:
    """The widths `Encoder3D` / `Decoder3D` read, from a configuration
    file's `model.params` tree."""
    p = cfg["model"]["params"]
    v = dict(p["ddconfig"], n_embed=p["n_embed"], embed_dim=p["embed_dim"])
    if v.get("attn_resolutions"):
        raise ValueError("the reference's levels hold no attention: "
                         f"attn_resolutions {v['attn_resolutions']}")
    return v


class Quantizer(nn.Module):
    """Nearest code by full squared distances, straight-through gradients,
    beta on the commitment."""

    def __init__(self, n_embed: int, dim: int, beta: float = 1.0):
        super().__init__()
        self.beta = beta
        self.embedding = nn.Embedding(n_embed, dim)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z (..., dim), channel-last -> (straight-through z_q, loss)."""
        book = self.embedding.weight
        flat = z.reshape(-1, book.shape[1])
        d = ((flat ** 2).sum(1, keepdim=True) + (book ** 2).sum(1)[None]
             - 2.0 * flat @ book.t())
        z_q = book[torch.argmin(d, 1)].reshape(z.shape)
        loss = (self.beta * torch.mean((z_q.detach() - z) ** 2)
                + torch.mean((z_q - z.detach()) ** 2))
        return z + (z_q - z).detach(), loss


class VQVAE(nn.Module):
    """Parameter names as the published module's (encoder.*, decoder.*,
    quantize.embedding.weight, quant_conv.*, post_quant_conv.*)."""

    def __init__(self, v: Dict, num: Numerics = None):
        super().__init__()
        self.encoder = Encoder3D(v)
        self.decoder = Decoder3D(v)
        self.quantize = Quantizer(v["n_embed"], v["embed_dim"])
        self.quant_conv = Conv(3, v["z_channels"], v["embed_dim"], 1)
        self.post_quant_conv = Conv(3, v["embed_dim"], v["z_channels"], 1)
        num = num or Numerics()
        for m in self.modules():
            m.num = num

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, R, R, R, 1) grids -> (reconstruction, codebook loss)."""
        z = self.quant_conv(self.encoder(x.permute(0, 4, 1, 2, 3)))
        z_q, loss = self.quantize(z.permute(0, 2, 3, 4, 1))
        rec = self.decoder(self.post_quant_conv(z_q.permute(0, 4, 1, 2, 3)))
        return rec.permute(0, 2, 3, 4, 1), loss


def loss(model: VQVAE, x: torch.Tensor, codebook_weight: float
         ) -> torch.Tensor:
    rec, codebook = model(x)
    return torch.mean(torch.abs(x - rec)) + codebook_weight * codebook


class Adam:
    """torch.optim.Adam's arithmetic without weight decay, written out."""

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params, self.lr = params, lr
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.count += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, v.sqrt() / c2 ** 0.5 + EPS, value=-self.lr / c1)


def train_steps(model: VQVAE, batches, lr: float,
                codebook_weight: float) -> Dict:
    """Adam steps of `model` on each batch in turn: every step's loss, the
    first gradient's norm and the change after the last step, per
    parameter (a parameter the step never reads gets a zero gradient)."""
    named = list(model.named_parameters())
    p0 = [p.detach().clone() for _, p in named]
    opt = Adam([p for _, p in named], lr)
    losses, first = [], None
    for x in batches:
        total = loss(model, x, codebook_weight)
        grads = torch.autograd.grad(total, [p for _, p in named],
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for (_, p), g in zip(named, grads)]
        losses.append(float(total.detach()))
        if first is None:
            first = {n: float(g.norm()) for (n, _), g in zip(named, grads)}
        opt.step(grads)
        del total, grads
    change = {n: float((p.detach() - q).norm())
              for (n, p), q in zip(named, p0)}
    return {"losses": losses, "first_grad": first, "change": change}
