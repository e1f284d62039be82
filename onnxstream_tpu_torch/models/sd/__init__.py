"""Stable Diffusion family: the UNet graph."""
