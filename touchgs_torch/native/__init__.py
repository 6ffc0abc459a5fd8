"""The native layer (port of ``touchgs_tpu/native/``): the C++ PNG/JPEG
codec, threaded loader, V4L2 and synchronized capture tools and compliant
arm controller, built with ``make`` into ``native/build/`` at first use and
bound with ``ctypes`` (``loader.py``, ``arm.py``)."""
from touchgs_torch.native.loader import NativeLoader, decode_png, native_available  # noqa: F401
