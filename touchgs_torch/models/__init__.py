"""Gaussian parameters, the splat model, densification and the
depth-supervised NeRF."""
