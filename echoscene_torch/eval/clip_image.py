"""CLIP image features for the consistency metric's --clip option.

Port of echoscene_tpu/eval/clip_image.py (reference
scripts/consistency_check.py:63-75: per same-object pair, the L2 distance
between the projected CLIP ViT-B/32 embeddings of the two rendered
objects, averaged per category).  Nothing is fetched, so two backends:

  * 'transformers' - a local HuggingFace CLIP snapshot
    (CLIPVisionModelWithProjection.image_embeds, clip.encode_image's
    projected embedding), on the encoder's device; without the
    transformers package it raises ImportError, it never falls back;
  * 'pixel'        - the hermetic proxy, JAX's to the bit: the image
    area-downsampled to 16x16x3 and L2-normalised, a 768-vector.  Its pair
    distances are not comparable to real-CLIP numbers.

'auto' takes 'transformers' when the weights registry
(echoscene_torch.weights) holds a CLIP snapshot, else 'pixel'.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class ClipImageEncoder:
    def __init__(self, backend: str = "pixel",
                 model_path: Optional[str] = None, device="cuda"):
        if backend == "auto":
            from ..weights import clip_text_dir
            d = clip_text_dir()
            backend, model_path = (("transformers", d) if d
                                   else ("pixel", model_path))
        if backend not in ("pixel", "transformers"):
            raise ValueError(f"unknown CLIP image backend {backend!r}")
        self.backend = backend
        self._hf = None
        if backend == "transformers":
            try:
                from transformers import (CLIPImageProcessor,
                                          CLIPVisionModelWithProjection)
            except ImportError as e:
                raise ImportError(
                    "the 'transformers' CLIP image backend needs the "
                    "transformers package, which is not installed; use "
                    "--clip pixel for the proxy") from e
            import torch
            from ..models.sgdiff import set_precision
            set_precision()   # f32 without TF32: card == CPU
            self.device = torch.device(device)
            path = model_path or "openai/clip-vit-base-patch32"
            self._hf = (
                CLIPImageProcessor.from_pretrained(path,
                                                   local_files_only=True),
                CLIPVisionModelWithProjection.from_pretrained(
                    path, local_files_only=True).to(self.device).eval())

    def encode(self, image: np.ndarray) -> np.ndarray:
        """image: (H, W, 3) uint8 or float in [0, 255] -> feature vector."""
        img = np.asarray(image)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3]
        if self._hf is not None:
            import torch
            proc, model = self._hf
            inputs = proc(images=img.astype(np.uint8), return_tensors="pt")
            with torch.no_grad():
                out = model(pixel_values=inputs["pixel_values"].to(
                    self.device)).image_embeds[0]
            return out.float().cpu().numpy()
        # pixel proxy: area-downsample to 16x16 then L2-normalise
        h, w = img.shape[:2]
        th = tw = 16
        ys = (np.arange(th + 1) * h // th)
        xs = (np.arange(tw + 1) * w // tw)
        small = np.zeros((th, tw, 3), np.float32)
        for i in range(th):
            for j in range(tw):
                patch = img[ys[i]:max(ys[i + 1], ys[i] + 1),
                            xs[j]:max(xs[j + 1], xs[j] + 1)]
                small[i, j] = patch.reshape(-1, 3).mean(0)
        v = small.reshape(-1)
        n = np.linalg.norm(v)
        return (v / n if n > 0 else v).astype(np.float32)


def pair_clip_distance(enc: ClipImageEncoder, img_a: np.ndarray,
                       img_b: np.ndarray) -> float:
    """torch.norm(f_a - f_b) of the pair's features
    (consistency_check.py:72-75)."""
    return float(np.linalg.norm(enc.encode(img_a) - enc.encode(img_b)))
