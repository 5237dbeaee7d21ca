"""Linear / convolution layers that compute in their weight's dtype.

The JAX modules name a compute dtype per layer (flax `dtype=`), so an f32
input to a bf16 layer is cast on entry.  These subclasses do the same: the
inference twin casts its parameters to bf16 once, and inputs that arrive in
f32 (diffusion state, CLIP features, timestep embeddings) are cast at the
first layer that reads them.  Parameter names and shapes are torch's, so the
reference state_dict layout is unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class Linear(nn.Linear):
    # set by the int8 sampling twin (nn.quant.jax_rounding_): the product
    # rounded to the weight's dtype before the bias is added, as flax's
    # Dense does in a reduced dtype
    round_before_bias = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        if self.round_before_bias and self.bias is not None:
            return F.linear(x, self.weight) + self.bias.to(x.dtype)
        return super().forward(x)


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class Conv3d(nn.Conv3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


def pointwise(conv: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """A 1x1 convolution applied as a linear map to channel-last tokens
    (..., C_in) -> (..., C_out), in the weight's dtype."""
    w = conv.weight
    return F.linear(tokens.to(w.dtype), w.reshape(w.shape[0], w.shape[1]),
                    conv.bias)


def conv_nd(dims: int, *args, **kwargs) -> nn.Module:
    """Conv1d or Conv3d (the two spatial ranks the UNets use)."""
    return {1: Conv1d, 3: Conv3d}[dims](*args, **kwargs)


def remat(module: nn.Module, *args):
    """module(*args), rematerialised in the backward pass where autograd
    records (JAX's `nn.remat`; `torch.utils.checkpoint`, non-reentrant).
    The recompute runs on the tensors the module holds now: under
    `torch.func.functional_call` those are the caller's cast copies, which
    have left the module by the time the backward pass recomputes."""
    if not torch.is_grad_enabled():
        return module(*args)
    state = dict(module.named_parameters(remove_duplicate=False))
    return checkpoint(
        lambda s, *a: torch.func.functional_call(module, s, a), state, *args,
        use_reentrant=False)
