"""The monocular-depth nets (port of ``touchgs_tpu/vision``): DPT,
ZoeDepth, Depth Anything and the compact trunk behind ``VisualPipeline``."""
from touchgs_torch.vision.monodepth import VisualPipeline, DPTDepthModel  # noqa: F401
