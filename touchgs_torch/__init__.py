"""touchgs_torch — the PyTorch/CUDA port of ``touchgs_tpu`` for NVIDIA Hopper.

The module layout mirrors ``touchgs_tpu/`` so each port module sits where its
JAX counterpart does.  The package imports ``torch`` and ``numpy`` only; its
kernels are CUDA C++ under ``touchgs_torch/csrc/``, built with ``nvcc`` for
``sm_90a`` at first use, and its host-side C++ (``native/``) is built with
``make`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  On
the CPU every kernel wrapper runs its plain PyTorch version instead.

Subpackages
-----------
- ``touchgs_torch.data``    cameras, scene IO (``load_scene``, PNG, depth
                            maps, splits, `.ply`), the capture tooling
- ``touchgs_torch.ops``     projection, SH, binning, compositing kernels,
                            the scan path, SSIM
- ``touchgs_torch.models``  Gaussian parameters, splat model, densification,
                            the depth-supervised NeRF
- ``touchgs_torch.touch``   the touch pipeline and the DenseTact sensor stack
- ``touchgs_torch.vision``  the monocular-depth nets
- ``touchgs_torch.train``   fused Adam and the training loop
- ``touchgs_torch.eval``    PSNR / SSIM / LPIPS, scene evaluation, camera paths
- ``touchgs_torch.parallel`` multi-scene training on one card, the sharded
                            step on ``torch.distributed``
- ``touchgs_torch.viewer``  the live browser viewer
- ``touchgs_torch.native``  the C++ layer over ctypes: PNG/JPEG codec,
                            threaded loader, capture tools, compliant arm
- ``touchgs_torch.cli``     the user's entry point, ``python -m touchgs_torch.cli``
- ``touchgs_torch.tools``   the anatomy tool, the stage profiler, the demos
                            and benches, the scene writer
- ``touchgs_torch.utils``   the roofline model, pose transforms
"""

__version__ = "0.1.0"
