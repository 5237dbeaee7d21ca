"""FID / KID between sets of top-down scene renders.

Port of echoscene_tpu/eval/fid.py (reference
scripts/compute_fid_scores_3dfront.py:62-161, which shells out to clean-fid
over two directories of 256^2 PNGs with room-type filename filters).  The
metric math is JAX's, on the host:

  * FID: Frechet distance between Gaussian fits of the image features,
    ||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2));
  * KID: unbiased polynomial-kernel MMD^2, k(x, y) = (x.y/d + 1)^3,
    averaged over subsets drawn by `default_rng(seed)` (clean-fid's KID).

The features come from an extractor on a device: the FID-InceptionV3
module (`inception:<path>`, eval/inception_fid.py), a TorchScript network
(`torchscript:<path>`), or the random-conv proxy (`random`), which is no FID
of the paper: its weights are drawn from a torch.Generator, where JAX draws
them from jax.random, so proxy scores of the two packages differ unless the
weights are handed over (`random_conv_extractor(weights=...)`).
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# --- feature extractors ----------------------------------------------------
def random_conv_weights(feature_dim: int = 768, seed: int = 0
                        ) -> Tuple[np.ndarray, ...]:
    """The proxy's four weights, HWIO convs and a (256, D) projection, as
    JAX scales them, drawn from a torch.Generator seeded by `seed`."""
    gen = torch.Generator().manual_seed(seed)
    shapes = ((5, 5, 3, 32), (5, 5, 32, 64), (3, 3, 64, 128),
              (128 * 2, feature_dim))
    fans = (75, 800, 576, 256)
    return tuple((torch.randn(s, generator=gen) / np.sqrt(f)).numpy()
                 for s, f in zip(shapes, fans))


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: low = total // 2, high = the rest."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def random_conv_extractor(feature_dim: int = 768, seed: int = 0,
                          weights: Optional[Sequence[np.ndarray]] = None,
                          device="cuda") -> Callable:
    """Deterministic random-conv feature net, uint8 (N, H, W, 3) -> (N, D):
    three stride-2 SAME convs, each with ReLU and a 2x2 SAME max pool, then
    the spatial mean and max through a linear map.  `weights` (w1, w2, w3,
    wf; HWIO convs) default to `random_conv_weights(feature_dim, seed)`."""
    from ..models.sgdiff import set_precision
    set_precision()   # f32 convolutions without TF32: card == CPU
    dev = torch.device(device)
    w1, w2, w3, wf = weights or random_conv_weights(feature_dim, seed)
    convs = [torch.from_numpy(np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(3, 2, 0, 1))).to(dev)
        for w in (w1, w2, w3)]
    proj = torch.from_numpy(np.asarray(wf, np.float32)).to(dev)

    def feats(x):
        x = x.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        for w in convs:
            k = w.shape[-1]
            (ht, hb), (wl, wr) = (_same_pad(x.shape[2], k, 2),
                                  _same_pad(x.shape[3], k, 2))
            x = torch.relu(F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=2))
            (ht, hb), (wl, wr) = (_same_pad(x.shape[2], 2, 2),
                                  _same_pad(x.shape[3], 2, 2))
            x = F.max_pool2d(F.pad(x, (wl, wr, ht, hb), value=-np.inf), 2)
        return torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], -1) @ proj

    def run(imgs) -> np.ndarray:
        with torch.no_grad():
            return feats(torch.from_numpy(np.ascontiguousarray(imgs)).to(
                dev)).cpu().numpy()

    return run


def torchscript_extractor(path: str, input_size: int = 299,
                          device="cuda") -> Callable:
    """A TorchScript feature network on `device` (clean-fid / pytorch-fid
    ship the ported TF InceptionV3 as one).  (N, H, W, 3) uint8 -> resized
    to `input_size`, scaled to [-1, 1], NCHW -> its (N, D) output."""
    dev = torch.device(device)
    model = torch.jit.load(path, map_location=dev).eval()

    def run(imgs) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
        x = x.float().permute(0, 3, 1, 2) / 255.0
        if tuple(x.shape[-2:]) != (input_size, input_size):
            x = F.interpolate(x, size=(input_size, input_size),
                              mode="bilinear", align_corners=False)
        with torch.no_grad():
            out = model(x * 2.0 - 1.0)
        if isinstance(out, (list, tuple)):
            out = out[0]
        return out.reshape(out.shape[0], -1).cpu().numpy()

    return run


def get_extractor(spec: str = "random", device="cuda") -> Callable:
    """'inception:<path>' -> the FID-InceptionV3 module (eval/
    inception_fid.py), falling back to the TorchScript runner when the file
    holds no FID-Inception weights; 'torchscript:<path>' forces the
    TorchScript runner; 'auto' -> the installed weights (echoscene_torch.
    weights) when present, else the random-conv proxy with a warning;
    'random' -> the proxy."""
    if spec == "auto":
        from ..weights import inception_weights
        path = inception_weights()
        if path is None:
            print("[fid] no installed Inception weights (python -m "
                  "echoscene_torch.weights --inception ...); scores use the "
                  "random-conv PROXY, not comparable to published FID")
            return random_conv_extractor(device=device)
        spec = f"inception:{path}"
    if spec.startswith("torchscript:"):
        return torchscript_extractor(spec.split(":", 1)[1], device=device)
    if spec.startswith("inception:"):
        from .inception_fid import InceptionExtractor, load_params
        path = spec.split(":", 1)[1]
        try:
            return InceptionExtractor(load_params(path), device)
        except KeyError as e:   # a scripted net that is not FID-Inception
            print(f"[fid] {path} holds no FID-Inception weights (missing "
                  f"{e}); using the TorchScript runner")
            return torchscript_extractor(path, device=device)
    return random_conv_extractor(device=device)


# --- metric math (JAX's, on the host) ----------------------------------------
def frechet_distance(feats1: np.ndarray, feats2: np.ndarray) -> float:
    from scipy import linalg
    mu1, mu2 = feats1.mean(0), feats2.mean(0)
    c1 = np.cov(feats1, rowvar=False)
    c2 = np.cov(feats2, rowvar=False)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(c1 @ c2)  # may be complex for near-singular input
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(c1) + np.trace(c2)
                 - 2 * np.trace(covmean))


def kid_score(feats1: np.ndarray, feats2: np.ndarray,
              num_subsets: int = 100, subset_size: int = 100,
              seed: int = 0) -> float:
    """Unbiased polynomial-kernel MMD^2 averaged over subsets."""
    d = feats1.shape[1]
    n = min(subset_size, len(feats1), len(feats2))
    rng = np.random.default_rng(seed)
    k = lambda a, b: (a @ b.T / d + 1.0) ** 3
    total = 0.0
    for _ in range(num_subsets):
        x = feats1[rng.choice(len(feats1), n, replace=False)]
        y = feats2[rng.choice(len(feats2), n, replace=False)]
        kxx = k(x, x)
        kyy = k(y, y)
        kxy = k(x, y)
        total += ((kxx.sum() - np.trace(kxx)) / (n * (n - 1))
                  + (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
                  - 2 * kxy.mean())
    return float(total / num_subsets)


# --- over directories (compute_fid_scores_3dfront.py analog) --------------
def load_image_dir(path: str, room_filter: Optional[Sequence[str]] = None,
                   size: int = 256) -> np.ndarray:
    """Every .png / .jpg of `path` (sorted, filtered by name) as uint8
    (N, size, size, 3), resized where another size."""
    from PIL import Image
    files = sorted(f for f in os.listdir(path)
                   if f.lower().endswith((".png", ".jpg")))
    if room_filter:
        files = [f for f in files if any(r in f for r in room_filter)]
    imgs = []
    for f in files:
        im = Image.open(os.path.join(path, f)).convert("RGB")
        if im.size != (size, size):
            im = im.resize((size, size))
        imgs.append(np.asarray(im, np.uint8))
    return np.stack(imgs) if imgs else np.zeros((0, size, size, 3), np.uint8)


ROOM_FILTERS = {
    # filename prefixes per room type (compute_fid_scores_3dfront.py:94-121)
    "bedroom": ["MasterBedroom", "SecondBedroom", "Bedroom"],
    "livingroom": ["LivingRoom", "LivingDiningRoom"],
    "diningroom": ["DiningRoom", "LivingDiningRoom"],
    "library": ["Library"],
    "all": None,
}


def compute_fid_kid(real_dir: str, fake_dir: str, room_type: str = "all",
                    extractor="random", batch: int = 64, device="cuda"):
    """FID / KID of the renders in `fake_dir` against those in `real_dir`;
    `extractor` is a spec for `get_extractor` or an extractor itself."""
    ext = (get_extractor(extractor, device) if isinstance(extractor, str)
           else extractor)
    filt = ROOM_FILTERS.get(room_type)
    real = load_image_dir(real_dir, filt)
    fake = load_image_dir(fake_dir, filt)
    if len(real) < 2 or len(fake) < 2:
        raise ValueError(f"FID needs at least 2 images a side, found "
                         f"{len(real)} in {real_dir} and {len(fake)} in "
                         f"{fake_dir}")

    def run(imgs):
        out = [ext(imgs[i:i + batch]) for i in range(0, len(imgs), batch)]
        return np.concatenate(out)

    fr, ff = run(real), run(fake)
    return {
        "fid": frechet_distance(fr, ff),
        "kid": kid_score(fr, ff,
                         subset_size=min(100, len(real), len(fake))),
        "n_real": len(real), "n_fake": len(fake),
    }
