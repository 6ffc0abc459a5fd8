"""touchgs_torch — the PyTorch/CUDA port of ``touchgs_tpu`` for NVIDIA Hopper.

The module layout mirrors ``touchgs_tpu/`` so each port module sits where its
JAX counterpart does.  The package imports ``torch`` and ``numpy`` only; the
three compositing kernels are CUDA C++ under ``touchgs_torch/csrc/``, built
with ``nvcc`` for ``sm_90a`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  On
the CPU every kernel wrapper runs its plain PyTorch version instead.

Subpackages
-----------
- ``touchgs_torch.data``    cameras and the in-memory ``Scene``
- ``touchgs_torch.ops``     projection, SH, binning, compositing kernels,
                            the scan path, SSIM
- ``touchgs_torch.models``  Gaussian parameters, splat model, densification,
                            the depth-supervised NeRF
- ``touchgs_torch.touch``   the touch pipeline and the DenseTact sensor stack
- ``touchgs_torch.vision``  the monocular-depth nets
- ``touchgs_torch.train``   fused Adam and the training loop
- ``touchgs_torch.eval``    PSNR / SSIM / LPIPS, scene evaluation, camera paths
- ``touchgs_torch.tools``   the anatomy tool, the stage profiler, the scale demo
- ``touchgs_torch.utils``   the roofline model, pose transforms
"""

__version__ = "0.1.0"
