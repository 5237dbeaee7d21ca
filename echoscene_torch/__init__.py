"""echoscene_torch — the PyTorch / CUDA (H100) port of echoscene_tpu.

Scene-graph-conditioned 3D scene generation: a layout DDPM over 8-d box
vectors and a latent 3D DDIM over VQ-VAE SDF latents, each with the "echo"
triplet-GCN message-passing pass inside every denoising step.  The JAX
package `echoscene_tpu` is the reference; this package imports nothing of it
(nor of jax), keeps its public layouts (channel-last latents, (B, L, H, D)
attention) and the reference torch state_dict key names, and replaces its
Pallas TPU kernels with hand-written CUDA kernels for Hopper (`csrc/`).

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; on CPU tensors every kernel wrapper computes its plain
PyTorch version.
"""

__version__ = "0.1.0"
