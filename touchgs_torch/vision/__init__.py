"""The monocular-depth nets (port of ``touchgs_tpu/vision``): DPT,
ZoeDepth, Depth Anything and the compact trunk behind ``VisualPipeline``."""
