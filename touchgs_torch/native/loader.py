"""ctypes bindings for the native PNG/JPEG codec and the threaded loader
(``libtouchgs_native.so``; port of ``touchgs_tpu/native/loader.py``).

The C++ sources beside this file build with ``make`` into
``touchgs_torch/native/build/`` at first use, never on import: the library
and the two capture tools ``tgs_capture`` and ``tgs_sync_capture``
(`build`).  Concurrent processes build under an exclusive ``flock`` on
``build/.lock`` and load only after it is released, so none loads a
half-written file.  The ABI is the plain C one of ``dataloader.cpp``
(``tgs_loader_*``, ``tgs_decode_png``, ``tgs_decode_jpeg``,
``tgs_encode_png_u16``, ``tgs_encode_png_u8``) and of ``arm_control.cpp``
(bound by ``arm.py``).

Decoded samples are float32, 8-bit ÷ 255 and 16-bit ÷ 1000 (the uint16-mm
depth contract), as a CPU ``torch.Tensor`` of shape ``(H, W, C)``; gray is
``(H, W, 1)``.  Where the library cannot be built (no ``g++``, ``make``,
zlib or libjpeg), `decode_png` falls back to the port's own codec,
``data/png.py``, with the same division, and `native_available` says which
path is in use; `NativeLoader` then raises.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from touchgs_torch.data.png import read_png

NATIVE_DIR = Path(__file__).parent
BUILD_DIR = NATIVE_DIR / "build"
SO_PATH = BUILD_DIR / "libtouchgs_native.so"
TOOLS = ("tgs_capture", "tgs_sync_capture")
MAX_PIXELS = 64 << 20      # floats in a decode buffer, as the JAX loader's

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None       # why the library is unavailable
# a program for each library the sources use, compiled and linked as the
# Makefile compiles and links
_PROBES = {
    "zlib": ("#include <zlib.h>\nint main() { return !zlibVersion(); }\n",
             "-lz"),
    "libjpeg": ("#include <cstdio>\n#include <jpeglib.h>\nint main() {"
                " jpeg_error_mgr e; return !jpeg_std_error(&e); }\n",
                "-ljpeg"),
}


def missing_prerequisites() -> list[str]:
    """What this machine lacks to build the native layer: ``g++``,
    ``make``, or the zlib or libjpeg headers and libraries (each named with
    the compiler's first error).  Empty when all are present."""
    missing = [tool for tool in ("g++", "make") if shutil.which(tool) is None]
    if "g++" in missing:
        return missing
    with tempfile.TemporaryDirectory() as tmp:
        for name, (code, lib) in _PROBES.items():
            src = Path(tmp) / f"{name}.cpp"
            src.write_text(code)
            r = subprocess.run(["g++", str(src), "-o", str(Path(tmp) / name),
                                lib], capture_output=True, text=True,
                               timeout=120)
            if r.returncode != 0:
                error = next((line for line in r.stderr.splitlines()
                              if "error" in line), r.stderr.strip())
                missing.append(f"{name} (g++: "
                               f"{error.split('error: ', 1)[-1].strip()})")
    return missing


def build(*targets: str) -> None:
    """``make`` the targets (paths under ``build/``; the default the
    library and both tools) under an exclusive lock on ``build/.lock``.
    Raises ``RuntimeError`` with make's output when the build fails."""
    targets = targets or ("all",)
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        r = subprocess.run(["make", "-C", str(NATIVE_DIR), "-j2", *targets],
                           capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"make {' '.join(targets)} failed in {NATIVE_DIR}:"
                           f"\n{(r.stdout + r.stderr)[-2000:]}")


def tool(name: str) -> Path:
    """The path of a capture tool (one of `TOOLS`), built if need be."""
    if name not in TOOLS:
        raise ValueError(f"unknown native tool {name!r}; one of {TOOLS}")
    build(f"build/{name}")
    return BUILD_DIR / name


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, lg = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.tgs_loader_create.restype = vp
    lib.tgs_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), i, i]
    lib.tgs_loader_prefetch.restype = i
    lib.tgs_loader_prefetch.argtypes = [vp, i]
    lib.tgs_loader_get.restype = i
    lib.tgs_loader_get.argtypes = [vp, i, vp, lg, vp]
    lib.tgs_loader_destroy.restype = None
    lib.tgs_loader_destroy.argtypes = [vp]
    lib.tgs_decode_png.restype = i
    lib.tgs_decode_png.argtypes = [ctypes.c_char_p, vp, lg, vp]
    lib.tgs_decode_jpeg.restype = i
    lib.tgs_decode_jpeg.argtypes = [vp, lg, vp, lg, vp]
    lib.tgs_encode_png_u16.restype = i
    lib.tgs_encode_png_u16.argtypes = [ctypes.c_char_p, vp, i, i]
    lib.tgs_encode_png_u8.restype = i
    lib.tgs_encode_png_u8.argtypes = [ctypes.c_char_p, vp, i, i, i]


def _ensure_built() -> Optional[ctypes.CDLL]:
    """The bound library, built and loaded at the first call; None where it
    cannot be (the reason in ``_error``)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                build("build/libtouchgs_native.so")
                lib = ctypes.CDLL(str(SO_PATH))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _error = f"{type(e).__name__}: {e}"
            else:
                _bind(lib)
                _lib = lib
        return _lib


def native_available() -> bool:
    """True where the native library is in use, False where `decode_png`
    falls back to ``data/png.py``."""
    return _ensure_built() is not None


def _samples(buf: torch.Tensor, n: int, shape, what) -> torch.Tensor:
    if n < 0:
        raise IOError(f"native {what} failed ({n})")
    return buf[:n].view(shape[0], shape[1], shape[2]).clone()


def decode_png_plain(path: str | os.PathLike) -> torch.Tensor:
    """`decode_png` through ``data/png.py``: its samples as float32, with
    the native codec's division and shape."""
    px = read_png(path)
    out = (torch.from_numpy(px.astype(np.float32))
           / (255.0 if px.dtype == np.uint8 else 1000.0))
    return out if out.dim() == 3 else out[..., None]


def decode_png(path: str | os.PathLike,
               max_pixels: int = MAX_PIXELS) -> torch.Tensor:
    """Decode a PNG into float32 ``(H, W, C)`` (8-bit ÷ 255, 16-bit ÷
    1000), through the native codec or, without it, `decode_png_plain`."""
    lib = _ensure_built()
    if lib is None:
        return decode_png_plain(path)
    buf = torch.empty(max_pixels, dtype=torch.float32)
    shape = (ctypes.c_int * 3)()
    n = lib.tgs_decode_png(os.fsencode(path), buf.data_ptr(), buf.numel(),
                           shape)
    return _samples(buf, n, shape, f"png decode for {path}")


class NativeLoader:
    """Threaded prefetching loader over a fixed list of PNG files: worker
    threads decode what `prefetch` queues; `get` waits for one file (a
    demand fetch jumps the queue), returns its samples as `decode_png`
    does and drops it from the loader's cache."""

    def __init__(self, paths: Sequence[str | os.PathLike], n_threads: int = 2,
                 max_pixels: int = MAX_PIXELS):
        lib = _ensure_built()
        if lib is None:
            raise RuntimeError(f"native loader unavailable ({_error})")
        self._lib = lib
        self._paths = [os.fsdecode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(
            *[os.fsencode(p) for p in self._paths])
        self._handle = lib.tgs_loader_create(arr, len(self._paths), n_threads)
        # torch.empty leaves the pages untouched until a decode writes them
        self._buf = torch.empty(max_pixels, dtype=torch.float32)

    def prefetch(self, idx: int) -> None:
        self._lib.tgs_loader_prefetch(self._handle, idx)

    def get(self, idx: int) -> torch.Tensor:
        shape = (ctypes.c_int * 3)()
        n = self._lib.tgs_loader_get(self._handle, idx, self._buf.data_ptr(),
                                     self._buf.numel(), shape)
        return _samples(self._buf, n, shape, f"load for {self._paths[idx]}")

    def __len__(self) -> int:
        return len(self._paths)

    def close(self) -> None:
        if self._handle:
            self._lib.tgs_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
