"""Live training/scene viewer (nerfstudio-viewer analogue; port of
``touchgs_tpu/viewer/``)."""
from touchgs_torch.viewer.server import ViewerServer, orbit_c2w

__all__ = ["ViewerServer", "orbit_c2w"]
