"""uint16-millimetre depth map IO (port of ``touchgs_tpu/data/depth_io.py``).

The whole reference pipeline trades depth as uint16 PNGs in millimetres,
divided by 1000 on read (``utils/read_touch_depths.py:11,52-56``,
``utils/fuse_touch_vision.py:270-275``, depth_unit_scale_factor=1e-3 at
``legacy/dataparser_tactile.py:65``).  This module is that contract, on
the port's own PNG codec (``data/png.py``).
"""
from __future__ import annotations

import os

import numpy as np

from touchgs_torch.data.png import read_png, write_png

MM_PER_M = 1000.0


def read_depth_mm(path: str | os.PathLike) -> np.ndarray:
    """Read a uint16 millimetre PNG → float32 metres."""
    img = read_png(path)
    if img.dtype not in (np.uint16, np.int32, np.uint8):
        raise ValueError(f"expected integer depth png, got {img.dtype} at {path}")
    return img.astype(np.float32) / MM_PER_M


def write_depth_mm(path: str | os.PathLike, depth_m: np.ndarray) -> None:
    """Write float metres → uint16 millimetre PNG (truncating cast, as the
    reference does at ``utils/fuse_touch_vision.py:373-376``)."""
    arr = (np.asarray(depth_m, dtype=np.float64) * MM_PER_M).astype(np.uint16)
    write_png(path, arr)


def read_npy_depth(path: str | os.PathLike, nan_to_zero: bool = True) -> np.ndarray:
    """Read a float .npy depth/variance map in metres (GPIS output contract,
    ``utils/read_touch_depths.py:41-49``: NaN = no information → 0)."""
    arr = np.load(path).astype(np.float32)
    if nan_to_zero:
        arr = np.nan_to_num(arr, nan=0.0)
    return arr
