"""Projection, SH, binning, the tile compositing kernels and SSIM."""
from touchgs_torch.ops.sh import eval_sh, num_sh_bases  # noqa: F401
from touchgs_torch.ops.projection import project_gaussians, quat_to_rotmat  # noqa: F401
from touchgs_torch.ops.rasterize_ref import rasterize_dense  # noqa: F401
from touchgs_torch.ops.tiles import bin_gaussians  # noqa: F401
from touchgs_torch.ops.rasterize_tiled import rasterize_tiled  # noqa: F401
from touchgs_torch.ops.ssim import ssim  # noqa: F401
