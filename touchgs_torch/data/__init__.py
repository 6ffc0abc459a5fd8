"""Scene containers: pinhole cameras and the in-memory ``Scene``."""
from touchgs_torch.data.cameras import Camera, Cameras  # noqa: F401
from touchgs_torch.data.depth_io import read_depth_mm, write_depth_mm  # noqa: F401
from touchgs_torch.data.splits import linspace_split  # noqa: F401
from touchgs_torch.data.scene import Scene, load_scene  # noqa: F401
