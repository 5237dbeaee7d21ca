"""FID-InceptionV3 feature network as a PyTorch module.

Port of echoscene_tpu/eval/inception_fid.py: the pytorch-fid / clean-fid
feature extractor (the TF-Inception weights shipped as
`pt_inception-2015-12-05.pt`, which the reference's FID protocol uses via
clean-fid, scripts/compute_fid_scores_3dfront.py:132-161).  torchvision's
InceptionV3 with the FID changes: every average pool has
count_include_pad=False, and the last InceptionE block pools with MAX
(pytorch-fid inception.py FIDInceptionA/C/E_1/E_2).  Each BasicConv2d is a
bias-free convolution, eval-mode BatchNorm (eps 1e-3) folded into a
per-channel scale and bias as JAX folds it, and a ReLU.

Weights load from what JAX's `load_params` takes: the TorchScript file
(its keys matched by suffix), a `.pth` state dict, or JAX's converted
`.npz` (HWIO kernels, scale, bias), including the `<path>.fidjax.npz` cache
JAX writes beside a converted file, so a file converted for JAX serves the
port too.

Contract (as eval/fid.torchscript_extractor): uint8 (N, H, W, 3) -> /255 ->
bilinear resize to 299 (anti-aliased when it shrinks, as jax.image.resize)
-> [-1, 1] -> NCHW -> (N, 2048) pool3 features, computed in f32 with TF32
off so that the card and the CPU agree.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3


# --- architecture table (a copy of JAX's conv_specs) ------------------------
def _bc(name, cin, cout, k, stride=1, pad=0):
    """BasicConv2d spec: conv(no bias) + BN(eps 1e-3) + relu."""
    if isinstance(k, int):
        k = (k, k)
    if isinstance(pad, int):
        pad = (pad, pad)
    return dict(name=name, cin=cin, cout=cout, k=k, stride=stride, pad=pad)


def conv_specs():
    """Every BasicConv2d in FID-InceptionV3, in state-dict order."""
    s = []
    s += [_bc("Conv2d_1a_3x3", 3, 32, 3, 2), _bc("Conv2d_2a_3x3", 32, 32, 3),
          _bc("Conv2d_2b_3x3", 32, 64, 3, 1, 1),
          _bc("Conv2d_3b_1x1", 64, 80, 1), _bc("Conv2d_4a_3x3", 80, 192, 3)]
    # InceptionA(in, pool_features)
    for name, cin, pf in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64),
                          ("Mixed_5d", 288, 64)):
        s += [_bc(f"{name}.branch1x1", cin, 64, 1),
              _bc(f"{name}.branch5x5_1", cin, 48, 1),
              _bc(f"{name}.branch5x5_2", 48, 64, 5, 1, 2),
              _bc(f"{name}.branch3x3dbl_1", cin, 64, 1),
              _bc(f"{name}.branch3x3dbl_2", 64, 96, 3, 1, 1),
              _bc(f"{name}.branch3x3dbl_3", 96, 96, 3, 1, 1),
              _bc(f"{name}.branch_pool", cin, pf, 1)]
    # InceptionB(288)
    s += [_bc("Mixed_6a.branch3x3", 288, 384, 3, 2),
          _bc("Mixed_6a.branch3x3dbl_1", 288, 64, 1),
          _bc("Mixed_6a.branch3x3dbl_2", 64, 96, 3, 1, 1),
          _bc("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 2)]
    # InceptionC(768, c7)
    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                     ("Mixed_6e", 192)):
        s += [_bc(f"{name}.branch1x1", 768, 192, 1),
              _bc(f"{name}.branch7x7_1", 768, c7, 1),
              _bc(f"{name}.branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
              _bc(f"{name}.branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
              _bc(f"{name}.branch7x7dbl_1", 768, c7, 1),
              _bc(f"{name}.branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
              _bc(f"{name}.branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
              _bc(f"{name}.branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
              _bc(f"{name}.branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
              _bc(f"{name}.branch_pool", 768, 192, 1)]
    # InceptionD(768)
    s += [_bc("Mixed_7a.branch3x3_1", 768, 192, 1),
          _bc("Mixed_7a.branch3x3_2", 192, 320, 3, 2),
          _bc("Mixed_7a.branch7x7x3_1", 768, 192, 1),
          _bc("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
          _bc("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
          _bc("Mixed_7a.branch7x7x3_4", 192, 192, 3, 2)]
    # InceptionE(1280) / InceptionE(2048)
    for name, cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        s += [_bc(f"{name}.branch1x1", cin, 320, 1),
              _bc(f"{name}.branch3x3_1", cin, 384, 1),
              _bc(f"{name}.branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
              _bc(f"{name}.branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
              _bc(f"{name}.branch3x3dbl_1", cin, 448, 1),
              _bc(f"{name}.branch3x3dbl_2", 448, 384, 3, 1, 1),
              _bc(f"{name}.branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
              _bc(f"{name}.branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
              _bc(f"{name}.branch_pool", cin, 192, 1)]
    return s


def conv_flops(size: int = 299) -> int:
    """2 x the multiply-adds of every convolution for one size x size image
    (pools and the folded BatchNorm left out), from the output shapes of a
    forward on the meta device."""
    with torch.device("meta"):
        net = FIDInceptionV3()
    total = []
    hooks = [m.register_forward_hook(
        lambda m, i, out: total.append(2 * out.numel() * m.weight[0].numel()))
        for m in net.convs.values()]
    net(torch.zeros(1, 3, size, size, device="meta"))
    for h in hooks:
        h.remove()
    return sum(total)


# --- weight conversion -------------------------------------------------------
def convert_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """pytorch-fid state_dict -> JAX's flat params: per BasicConv2d a
    kernel (HWIO) and BN folded into (scale, bias), in f32 as JAX folds."""
    params: Dict[str, np.ndarray] = {}
    for spec in conv_specs():
        n = spec["name"]

        # the TorchScript module nests blocks under `blocks.N.M.`: accept
        # flat pytorch-fid names and any prefix ending with the name
        def get(suffix):
            key = f"{n}.{suffix}"
            if key in sd:
                return np.asarray(sd[key], np.float32)
            for k in sd:
                if k.endswith(key):
                    return np.asarray(sd[k], np.float32)
            raise KeyError(key)
        w = get("conv.weight")                      # (O, I, H, W)
        bw, bb = get("bn.weight"), get("bn.bias")
        rm, rv = get("bn.running_mean"), get("bn.running_var")
        scale = bw / np.sqrt(rv + BN_EPS)
        params[f"{n}.kernel"] = w.transpose(2, 3, 1, 0)   # HWIO
        params[f"{n}.scale"] = scale
        params[f"{n}.bias"] = bb - rm * scale
    return params


def load_params(path: str) -> Dict[str, np.ndarray]:
    """JAX's flat params from an .npz, from JAX's `<path>.fidjax.npz`
    conversion cache when it exists, else converted from a TorchScript file
    or a .pth state dict."""
    if path.endswith(".npz"):
        with np.load(path) as d:
            return {k: d[k] for k in d.files}
    cache = path + ".fidjax.npz"
    if os.path.exists(cache):
        return load_params(cache)
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:   # not TorchScript: a pickled state dict / module
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return convert_state_dict({k: v.detach().cpu().numpy()
                               for k, v in sd.items()})


# --- the network -------------------------------------------------------------
class BasicConv2d(torch.nn.Module):
    """conv (no bias) -> y * scale + bias (eval BN folded) -> ReLU."""

    def __init__(self, spec):
        super().__init__()
        kh, kw = spec["k"]
        self.stride, self.pad = spec["stride"], spec["pad"]
        self.weight = torch.nn.Parameter(
            torch.zeros(spec["cout"], spec["cin"], kh, kw))
        self.scale = torch.nn.Parameter(torch.ones(spec["cout"]))
        self.bias = torch.nn.Parameter(torch.zeros(spec["cout"]))

    def forward(self, x):
        y = F.conv2d(x, self.weight, stride=self.stride, padding=self.pad)
        return torch.relu(y * self.scale[:, None, None]
                          + self.bias[:, None, None])


def _avg_pool(x):
    """3x3 stride-1 pad-1 average with count_include_pad=False: the mean
    of the valid taps (the FID-Inception change)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class FIDInceptionV3(torch.nn.Module):
    """x (N, 3, H, W) in [-1, 1] -> (N, 2048), the forward of JAX's
    `_forward` (echoscene_tpu/eval/inception_fid.py:182-238)."""

    def __init__(self):
        super().__init__()
        # module names may not hold dots: Mixed_5b.branch1x1 -> Mixed_5b__...
        self.convs = torch.nn.ModuleDict(
            {s["name"].replace(".", "__"): BasicConv2d(s)
             for s in conv_specs()})

    def load_params(self, params: Dict[str, np.ndarray]) -> "FIDInceptionV3":
        """Take JAX's flat params (HWIO kernel, scale, bias per conv)."""
        with torch.no_grad():
            for s in conv_specs():
                m = self.convs[s["name"].replace(".", "__")]
                k = np.asarray(params[f"{s['name']}.kernel"], np.float32)
                m.weight.copy_(torch.from_numpy(
                    np.ascontiguousarray(k.transpose(3, 2, 0, 1))))
                m.scale.copy_(torch.from_numpy(np.asarray(
                    params[f"{s['name']}.scale"], np.float32)))
                m.bias.copy_(torch.from_numpy(np.asarray(
                    params[f"{s['name']}.bias"], np.float32)))
        return self

    def c(self, name, x):
        return self.convs[name.replace(".", "__")](x)

    def forward(self, x):
        c = self.c
        x = c("Conv2d_1a_3x3", x)
        x = c("Conv2d_2a_3x3", x)
        x = c("Conv2d_2b_3x3", x)
        x = F.max_pool2d(x, 3, 2)
        x = c("Conv2d_3b_1x1", x)
        x = c("Conv2d_4a_3x3", x)
        x = F.max_pool2d(x, 3, 2)

        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):     # InceptionA
            b1 = c(f"{name}.branch1x1", x)
            b5 = c(f"{name}.branch5x5_2", c(f"{name}.branch5x5_1", x))
            b3 = c(f"{name}.branch3x3dbl_3",
                   c(f"{name}.branch3x3dbl_2", c(f"{name}.branch3x3dbl_1", x)))
            bp = c(f"{name}.branch_pool", _avg_pool(x))
            x = torch.cat([b1, b5, b3, bp], 1)

        b3 = c("Mixed_6a.branch3x3", x)                       # InceptionB
        bd = c("Mixed_6a.branch3x3dbl_3",
               c("Mixed_6a.branch3x3dbl_2", c("Mixed_6a.branch3x3dbl_1", x)))
        x = torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)

        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            b1 = c(f"{name}.branch1x1", x)                    # InceptionC
            b7 = c(f"{name}.branch7x7_3",
                   c(f"{name}.branch7x7_2", c(f"{name}.branch7x7_1", x)))
            bd = x
            for i in (1, 2, 3, 4, 5):
                bd = c(f"{name}.branch7x7dbl_{i}", bd)
            bp = c(f"{name}.branch_pool", _avg_pool(x))
            x = torch.cat([b1, b7, bd, bp], 1)

        b3 = c("Mixed_7a.branch3x3_2", c("Mixed_7a.branch3x3_1", x))
        b7 = x                                                # InceptionD
        for i in (1, 2, 3, 4):
            b7 = c(f"Mixed_7a.branch7x7x3_{i}", b7)
        x = torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)

        for name, maxp in (("Mixed_7b", False), ("Mixed_7c", True)):
            b1 = c(f"{name}.branch1x1", x)                    # InceptionE
            b3 = c(f"{name}.branch3x3_1", x)
            b3 = torch.cat([c(f"{name}.branch3x3_2a", b3),
                            c(f"{name}.branch3x3_2b", b3)], 1)
            bd = c(f"{name}.branch3x3dbl_2", c(f"{name}.branch3x3dbl_1", x))
            bd = torch.cat([c(f"{name}.branch3x3dbl_3a", bd),
                            c(f"{name}.branch3x3dbl_3b", bd)], 1)
            pooled = (F.max_pool2d(x, 3, 1, 1) if maxp else _avg_pool(x))
            bp = c(f"{name}.branch_pool", pooled)
            x = torch.cat([b1, b3, bd, bp], 1)

        return x.mean(dim=(2, 3))                             # (N, 2048)


class InceptionExtractor:
    """uint8 (N, H, W, 3) -> (N, 2048) f32 numpy features on `device`: the
    port of JAX's `jax_inception_extractor`, a drop-in for eval.fid's
    extractors."""

    def __init__(self, params: Dict[str, np.ndarray], device="cuda",
                 input_size: int = 299):
        from ..models.sgdiff import set_precision
        set_precision()   # f32 convolutions without TF32: card == CPU
        self.device = torch.device(device)
        self.input_size = input_size
        self.net = FIDInceptionV3().load_params(params).to(self.device).eval()

    def features(self, imgs: torch.Tensor) -> torch.Tensor:
        """uint8 (N, H, W, 3) tensor on the extractor's device -> (N, 2048)."""
        x = imgs.permute(0, 3, 1, 2).float() / 255.0
        if tuple(x.shape[-2:]) != (self.input_size, self.input_size):
            # jax.image.resize's bilinear anti-aliases when it shrinks
            x = F.interpolate(x, size=(self.input_size, self.input_size),
                              mode="bilinear", align_corners=False,
                              antialias=True)
        with torch.no_grad():
            return self.net(x * 2.0 - 1.0)

    def __call__(self, imgs) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device)
        return self.features(t).cpu().numpy()
