"""Installed-weights registry: the one place real extractor and encoder
weights live, shared with the JAX package.

Port of echoscene_tpu/weights.py.  The published weights are not in the
repository: FID's network (clean-fid's `pt_inception-2015-12-05.pt`,
scripts/compute_fid_scores_3dfront.py:132-161) and OpenAI CLIP ViT-B/32
(dataset/threedfront_dataset.py:157-163).  Every 'auto' backend of the port
resolves through the getters here: `eval.fid.get_extractor('auto')`,
`data.clip_text.ClipTextEncoder('auto')`,
`eval.clip_image.ClipImageEncoder('auto')`.

Layout under `weights_dir()` (`$ECHOSCENE_WEIGHTS_DIR`, default
~/.cache/echoscene_tpu/weights, the JAX package's, so one install serves
both packages):
  inception/pt_inception-2015-12-05.pt   (TorchScript, clean-fid export)
  inception/inception.npz                (the JAX package's converted params)
  clip-vit-base-patch32/                 (HuggingFace snapshot directory)

Installs copy from local paths only; a URL is refused, since nothing is
fetched.  As a program:

    python -m echoscene_torch.weights [--inception PATH] [--clip DIR] \
        [--smoke] [--device cuda]

installs what it is given, prints the status as JSON, and with `--smoke`
runs each installed backend once on `--device`.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, Optional

INCEPTION_PT = "pt_inception-2015-12-05.pt"
INCEPTION_NPZ = "inception.npz"
CLIP_DIRNAME = "clip-vit-base-patch32"


def weights_dir() -> str:
    return os.environ.get(
        "ECHOSCENE_WEIGHTS_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "echoscene_tpu",
                     "weights"))


def inception_weights() -> Optional[str]:
    """Path to installed Inception FID weights (.npz first, else the
    clean-fid TorchScript .pt), or None."""
    d = os.path.join(weights_dir(), "inception")
    for name in (INCEPTION_NPZ, INCEPTION_PT):
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


def clip_text_dir() -> Optional[str]:
    """Path to an installed HuggingFace CLIP snapshot directory (it carries
    a config.json), or None.  The same directory serves the text and the
    vision tower: ViT-B/32 ships both."""
    d = os.path.join(weights_dir(), CLIP_DIRNAME)
    if os.path.isfile(os.path.join(d, "config.json")):
        return d
    return None


def _copy(src: str, dst: str) -> None:
    """Copy a local file or directory to dst; a URL is refused."""
    if "://" in src:
        raise ValueError(
            f"{src!r} is a URL: weights install from a local path only "
            "(nothing is downloaded); copy the file onto this machine first")
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if os.path.isdir(src):
        if os.path.abspath(src) != os.path.abspath(dst):
            shutil.copytree(src, dst, dirs_exist_ok=True)
    elif os.path.isfile(src):
        shutil.copy2(src, dst)
    else:
        raise FileNotFoundError(src)


def install_inception(src: str) -> str:
    """Install FID Inception weights from a local path: the clean-fid
    TorchScript export (pt_inception-2015-12-05.pt) or a converted .npz."""
    name = INCEPTION_NPZ if src.endswith(".npz") else INCEPTION_PT
    dst = os.path.join(weights_dir(), "inception", name)
    _copy(src, dst)
    return dst


def install_clip(src: str) -> str:
    """Install a HuggingFace CLIP ViT-B/32 snapshot directory."""
    if "://" not in src and not os.path.isdir(src):
        raise ValueError(
            f"--clip expects a HuggingFace snapshot DIRECTORY, got {src!r}")
    dst = os.path.join(weights_dir(), CLIP_DIRNAME)
    _copy(src, dst)
    if clip_text_dir() is None:
        raise ValueError(f"{src} does not look like a HF snapshot "
                         "(no config.json)")
    return dst


def status() -> Dict[str, Optional[str]]:
    return {"weights_dir": weights_dir(),
            "inception": inception_weights(),
            "clip": clip_text_dir()}


def smoke(report: dict, device: str = "cuda") -> bool:
    """One forward through each installed backend on `device`; True when
    both are installed and ran."""
    import numpy as np

    ok = True
    if inception_weights():
        from .eval.fid import get_extractor
        feats = get_extractor("auto", device=device)(
            np.random.default_rng(0).integers(
                0, 255, size=(2, 299, 299, 3)).astype(np.uint8))
        if feats.shape != (2, 2048) or not np.isfinite(feats).all():
            raise RuntimeError(f"Inception features {feats.shape} not finite "
                               "or not (2, 2048)")
        report["inception_smoke"] = f"ok {feats.shape}"
    else:
        report["inception_smoke"] = "skipped (not installed)"
        ok = False
    if clip_text_dir():
        from .data.clip_text import ClipTextEncoder
        from .eval.clip_image import ClipImageEncoder
        v = ClipTextEncoder("auto").encode("a bed close by a wardrobe")
        f = ClipImageEncoder("auto", device=device).encode(
            np.zeros((64, 64, 3), np.uint8))
        if not all(x.shape == (512,) and np.isfinite(x).all()
                   for x in (v, f)):
            raise RuntimeError(f"CLIP features {v.shape} / {f.shape} not "
                               "finite or not (512,)")
        report["clip_smoke"] = "ok text+vision (512,)"
    else:
        report["clip_smoke"] = "skipped (not installed)"
        ok = False
    return ok


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--inception", default=None,
                   help="pt_inception-2015-12-05.pt or .npz, a local path")
    p.add_argument("--clip", default=None,
                   help="HuggingFace CLIP ViT-B/32 snapshot directory")
    p.add_argument("--smoke", action="store_true",
                   help="forward-check the installed real backends")
    p.add_argument("--device", default="cuda",
                   help="device of the smoke forwards (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    if args.inception:
        print("installed:", install_inception(args.inception))
    if args.clip:
        print("installed:", install_clip(args.clip))
    report = dict(status())
    if args.smoke:
        smoke(report, args.device)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
