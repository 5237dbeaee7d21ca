"""Seeded weights for the benchmark's model, drawn on the device.

The rule of `echoscene_torch/benchmarks.py` `seeded_weights_`, made
independent of how a module initialises itself: every parameter with two or
more dimensions (linear and convolution weights, embeddings) is uniform in
+-1 / sqrt(fan_in), a norm's scale is 1, and every other vector (biases,
norm shifts) is N(0, 0.02), so that zero-initialised heads still reach the
outputs.  Parameters are taken in the order of their sorted names and drawn
in two calls, one uniform and one normal stream over all of them, from a
`torch.Generator` on the device: the same seed gives the same weights on
either side, whatever module holds them.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

HEAD_STD = 0.02

Spec = List[Tuple[str, Tuple[int, ...], str]]


def spec_of(model: torch.nn.Module, norm_scales: Iterable[str]) -> Spec:
    """[(name, shape, kind)] of `model`'s parameters in sorted order; kind
    is "matrix", "scale" (a norm's scale) or "vector"."""
    scales = set(norm_scales)
    out = []
    for name, p in sorted(model.named_parameters()):
        kind = ("matrix" if p.dim() >= 2 else
                "scale" if name in scales else "vector")
        out.append((name, tuple(p.shape), kind))
    return out


@torch.no_grad()
def draw_(params: Dict[str, torch.Tensor], spec: Spec, seed: int,
          device) -> None:
    """Fill `params` (name -> tensor, the names and shapes of `spec`) from
    `seed`, in place."""
    names = {n for n, _, _ in spec}
    if set(params) != names:
        missing = sorted(names - set(params))[:5]
        extra = sorted(set(params) - names)[:5]
        raise ValueError(f"parameters differ from the weight spec: missing "
                         f"{missing}, unexpected {extra}")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_mat = sum(math.prod(s) for _, s, k in spec if k == "matrix")
    n_vec = sum(math.prod(s) for _, s, k in spec if k == "vector")
    uni = torch.empty(n_mat, device=device).uniform_(-1.0, 1.0,
                                                     generator=gen)
    nrm = torch.empty(n_vec, device=device).normal_(0.0, HEAD_STD,
                                                    generator=gen)
    i = j = 0
    for name, shape, kind in spec:
        p = params[name]
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)}, spec {shape}")
        n = math.prod(shape)
        if kind == "matrix":
            bound = 1.0 / math.sqrt(n // shape[0])
            p.copy_(uni[i:i + n].view(shape) * bound)
            i += n
        elif kind == "scale":
            p.fill_(1.0)
        else:
            p.copy_(nrm[j:j + n].view(shape))
            j += n
