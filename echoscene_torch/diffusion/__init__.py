"""Diffusion math of the port (sampling half)."""
