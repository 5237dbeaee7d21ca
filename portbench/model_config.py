"""A configuration file (`configs/<name>.json`) read into the two forms the
benchmark needs: the reference's plain dict and the program's
`EchoSceneConfig`.

The file keeps the published tree (hyper / layout_branch / shape_branch
with the shape denoiser's and the VQ-VAE's files resolved into it) plus the
graph encoder's sizes, the vocabulary and the program's precision options.
"""
from __future__ import annotations

import json
import os
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> Dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def reference_model(cfg: Dict) -> Dict:
    """The `model` dict of `reference.model.EchoScene`."""
    g = dict(cfg["graph"])
    enc_out = g["embedding_dim"] * 2 + (g["clip_dim"] if g["with_clip"]
                                        else 0)
    # rel_s_mlp's widths are fixed in the published model (EchoScene.py
    # :97-100, cross-attention conditioning)
    g["rel_s_dims"] = [enc_out, 960, 1280]
    vq = dict(cfg["shape_branch"]["vqvae"]["ddconfig"])
    vq.update(embed_dim=cfg["shape_branch"]["vqvae"]["embed_dim"],
              n_embed=cfg["shape_branch"]["vqvae"]["n_embed"])
    return {"graph": g,
            "layout_denoiser": cfg["layout_branch"]["denoiser_kwargs"],
            "shape_denoiser": cfg["shape_branch"]["unet"],
            "vqvae": vq}


def program_config(cfg: Dict, scenes: int, max_nodes: int,
                   max_triples: int):
    """The program's `EchoSceneConfig` for batches of `scenes` scenes at
    the given node and triple capacities."""
    from echoscene_torch.models.config import (
        EchoSceneConfig, LayoutDenoiserConfig, LayoutDiffusionConfig,
        ShapeBranchConfig, ShapeDenoiserConfig, VQVAEConfig)

    def fill(obj, values):
        for k, v in values.items():
            if not hasattr(obj, k):
                continue
            setattr(obj, k, tuple(v) if isinstance(v, list) else v)
        return obj

    g, lb, sb = cfg["graph"], cfg["layout_branch"], cfg["shape_branch"]
    sd = fill(ShapeDenoiserConfig(), sb["unet"])
    fill(sd, sb["model"])
    vq = fill(VQVAEConfig(), sb["vqvae"]["ddconfig"])
    vq.embed_dim = sb["vqvae"]["embed_dim"]
    vq.n_embed = sb["vqvae"]["n_embed"]
    shape = ShapeBranchConfig(
        sampling=sb["sampling"], sampler=sb["sampler"],
        ddim_steps=sb["ddim_steps"], ddim_eta=sb["ddim_eta"],
        uc_scale=sb["uc_scale"], denoiser=sd, vqvae=vq)
    out = EchoSceneConfig(
        embedding_dim=g["embedding_dim"],
        gconv_pooling=g["gconv_pooling"],
        gconv_num_layers=g["gconv_num_layers"],
        mlp_normalization=g["mlp_normalization"], residual=g["residual"],
        replace_latent=g["replace_latent"], with_clip=g["with_clip"],
        num_objs=g["num_objs"], num_preds=g["num_preds"],
        diffusion_bs=cfg["hyper"]["batch_size"], max_nodes=max_nodes,
        max_triples=max_triples, batch_scenes=scenes,
        layout_denoiser=fill(LayoutDenoiserConfig(), lb["denoiser_kwargs"]),
        layout_diffusion=fill(LayoutDiffusionConfig(),
                              lb["diffusion_kwargs"]),
        shape_branch=shape, lr_init=cfg["hyper"]["lr_init"],
        lr_step=tuple(cfg["hyper"]["lr_step"]),
        lr_evo=tuple(cfg["hyper"]["lr_evo"]),
        compute_dtype=cfg["compute_dtype"],
        sample_dtype=cfg["sample_dtype"], sample_conv=cfg["sample_conv"])
    return out
