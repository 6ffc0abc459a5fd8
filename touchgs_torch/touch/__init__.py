"""The touch pipeline (port of ``touchgs_tpu/touch``): vision-depth
uncertainty, two-stage alignment and Bayesian fusion, touch seeding, the
GPIS and the sensor calibration; and the DenseTact sensor stack (its
nets, losses, train steps and the 30 Hz sensor loop)."""
from touchgs_torch.touch.uncertainty import compute_uncertainty_map_with_edges  # noqa: F401
from touchgs_torch.touch.fusion import (  # noqa: F401
    align_vision_depth,
    compute_scale_and_offset,
    create_sparse_depth_map,
    fuse_depth_maps,
    fuse_depth_maps_with_uncertainty,
    fuse_view,
)
from touchgs_torch.touch.pointcloud import backproject_depth, seed_point_cloud  # noqa: F401
from touchgs_torch.touch.gpis import GPIS, fit_gpis, render_depth_var  # noqa: F401
