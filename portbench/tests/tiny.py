"""A configuration and traffic small enough for the CPU tests: the cells'
files with every width and depth cut down."""
from __future__ import annotations

import copy

from portbench import model_config, scenes


def tiny_config(name: str = "echoscene_bf16", noisy: bool = True) -> dict:
    """`noisy`: a layout noise schedule that ends near pure noise in its 12
    steps, as the published one does in 1000, so that the chain's updates
    matter (generation)."""
    cfg = copy.deepcopy(model_config.load(name))
    cfg["graph"].update(embedding_dim=8, gconv_num_layers=2)
    lb = cfg["layout_branch"]
    lb["denoiser_kwargs"].update(
        model_channels=16, channel_mult=[1, 1], num_res_blocks=1,
        attention_resolutions=[2], num_heads=4, concat_dim=32,
        crossattn_dim=32, use_checkpoint=False, gconv_num_layers=2)
    lb["diffusion_kwargs"].update(time_num=12, sample_steps=3)
    if noisy:
        lb["diffusion_kwargs"].update(beta_start=0.05, beta_end=0.6)
    sb = cfg["shape_branch"]
    sb["ddim_steps"] = 3
    sb["model"]["timesteps"] = 12
    sb["unet"].update(image_size=4, model_channels=8, num_res_blocks=1,
                      attention_resolutions=[2], channel_mult=[1, 2],
                      num_heads=2, context_dim=32, use_checkpoint=False,
                      gconv_num_layers=2)
    sb["vqvae"]["n_embed"] = 16
    sb["vqvae"]["ddconfig"].update(ch=4, resolution=16)
    return cfg


def tiny_mix(name: str = "gen_batch") -> dict:
    mix = copy.deepcopy(scenes.load(name))
    mix.update(scenes=3, objects_min=2, objects_max=4)
    if "shape_rows" in mix:
        mix.update(shape_rows=8, sdf_resolution=16, feed=2)
    return mix
