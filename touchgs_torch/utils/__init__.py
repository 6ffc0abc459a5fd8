"""Profiling helpers, the training loop's account of itself
(``telemetry``) and pose transforms of the port.

The JAX package's ``utils/cache.py`` (the persistent XLA compile cache) has
no counterpart: nothing here is compiled by XLA.  What the port compiles is
its CUDA kernels, and ``ops/cuda_build.py`` caches those under
``touchgs_torch/csrc/build/<hash>/``, keyed by a hash of the sources and
the nvcc flags, so they are built once for each set of sources."""
from touchgs_torch.utils import transforms  # noqa: F401
