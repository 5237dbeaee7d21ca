"""CLIP text features per node class name and relation phrase.

Port of echoscene_tpu/data/clip_text.py.  The reference encodes class names
and relation phrases once with ViT-B/32 and caches them per scan
(dataset/threedfront_dataset.py:352-403).  Nothing is fetched, so:

  * 'hash'         - deterministic pseudo-features: each phrase maps to a
                     seeded N(0, 1) 512-vector (identical phrases, identical
                     codes; distinct phrases, near-orthogonal codes), the
                     same vectors as the JAX package's hash backend;
  * 'transformers' - local HuggingFace CLIP weights; raises when they are
                     not on disk (`local_files_only`);
  * 'auto'         - 'transformers' when the weights registry
                     (`echoscene_torch.weights`, shared with the JAX
                     package) holds a `clip-vit-base-patch32` snapshot,
                     else 'hash'.

All backends return float32 (512,) vectors per phrase and memoise them.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np

from ..weights import clip_text_dir

CLIP_DIM = 512


class ClipTextEncoder:
    def __init__(self, backend: str = "hash", model_path: Optional[str] = None):
        if backend == "auto":
            d = clip_text_dir()
            backend, model_path = (("transformers", d) if d
                                   else ("hash", model_path))
        if backend not in ("hash", "transformers"):
            raise ValueError(f"unknown CLIP text backend {backend!r}")
        self.backend = backend
        self._memo: Dict[str, np.ndarray] = {}
        self._hf = None
        if backend == "transformers":
            # the reference conditions on CLIP's projected text embedding
            # (threedfront_dataset.py:387,389,686): text_embeds of
            # CLIPTextModelWithProjection
            from transformers import (CLIPTextModelWithProjection,
                                      CLIPTokenizer)
            path = model_path or "openai/clip-vit-base-patch32"
            self._hf = (
                CLIPTokenizer.from_pretrained(path, local_files_only=True),
                CLIPTextModelWithProjection.from_pretrained(
                    path, local_files_only=True))

    def encode(self, text: str) -> np.ndarray:
        if text in self._memo:
            return self._memo[text]
        if self._hf is not None:
            import torch
            tok, model = self._hf
            with torch.no_grad():
                inputs = tok([text], padding=True, return_tensors="pt")
                feat = model(**inputs).text_embeds[0].numpy().astype(
                    np.float32)
        else:
            seed = int.from_bytes(
                hashlib.sha256(text.encode()).digest()[:8], "little")
            feat = np.random.default_rng(seed).standard_normal(
                CLIP_DIM).astype(np.float32)
        self._memo[text] = feat
        return feat

    def encode_many(self, texts) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts], axis=0)
