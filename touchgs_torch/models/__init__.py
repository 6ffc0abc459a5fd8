"""Gaussian parameters, the splat model, densification and the
depth-supervised NeRF."""
from touchgs_torch.models.gaussians import (  # noqa: F401
    GaussianParams,
    init_from_points,
    init_random,
)
from touchgs_torch.models.splatfacto import render, compute_losses  # noqa: F401
from touchgs_torch.models.densify import DensifyState, update_stats, refine  # noqa: F401
