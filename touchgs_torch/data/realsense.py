"""RealSense depth ingestion (port of ``touchgs_tpu/data/realsense.py``).

Rebuild of ``utils/read_realsense_depth.py``: raw RealSense .npy depth (mm)
is reprojected from the depth camera's intrinsics to the RGB camera's via the
``K_old · K_new⁻¹`` pixel remap (:13-48), then written as uint16-mm PNG to
``realsense_depths/`` (:129-139).  The default intrinsics are the reference's
hardcoded pair (:12).  The remap is torch ops on the image's device.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from touchgs_torch.data.depth_io import write_depth_mm

# reference defaults (read_realsense_depth.py:12)
OLD_INTRINSICS = (360.0, 360.0, 243.0, 137.8)
NEW_INTRINSICS = (1297.0, 1304.0, 620.91, 238.28)
NEW_SIZE = (1280, 720)


def _bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                     ) -> torch.Tensor:
    """cv2.remap(INTER_LINEAR) equivalent: sample img at float coords,
    out-of-range → 0 (BORDER_CONSTANT)."""
    h, w = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = img[torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)]
        return torch.where(inside, v, torch.zeros_like(v))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def convert_intrinsics(
    img: torch.Tensor,
    old_intrinsics: tuple = OLD_INTRINSICS,
    new_intrinsics: tuple = NEW_INTRINSICS,
    new_size: tuple[int, int] = NEW_SIZE,
) -> torch.Tensor:
    """Remap an image between camera intrinsics (reference :13-48), on the
    image's device; float32 (height, width) out."""
    ofx, ofy, ocx, ocy = (torch.tensor(v, dtype=torch.float32,
                                       device=img.device)
                          for v in old_intrinsics)
    nfx, nfy, ncx, ncy = (torch.tensor(v, dtype=torch.float32,
                                       device=img.device)
                          for v in new_intrinsics)
    width, height = new_size
    ys, xs = torch.meshgrid(torch.arange(height, device=img.device),
                            torch.arange(width, device=img.device),
                            indexing="ij")
    # K_old @ K_new^-1 action on homogeneous pixel coords
    map_x = ofx * (xs - ncx) / nfx + ocx
    map_y = ofy * (ys - ncy) / nfy + ocy
    return _bilinear_sample(img.to(torch.float32), map_x, map_y)


def process_realsense_dir(
    root: str | Path,
    in_dir: str = "realsense_depth",
    out_dir: str = "realsense_depths",
    old_intrinsics: tuple = OLD_INTRINSICS,
    new_intrinsics: tuple = NEW_INTRINSICS,
    new_size: tuple[int, int] = NEW_SIZE,
    device: torch.device | str = "cuda",
) -> int:
    """`read_realsense_depth.py` main loop (:108-139): npy mm → remap on
    ``device`` → uint16-mm PNG.  Returns the number of frames written."""
    root = Path(root)
    out = root / out_dir
    out.mkdir(exist_ok=True)
    count = 0
    for f in sorted((root / in_dir).glob("*.npy")):
        depth_m = np.load(f).astype(np.float32) / 1000.0  # :101-106
        remapped = convert_intrinsics(
            torch.as_tensor(depth_m, device=device), old_intrinsics,
            new_intrinsics, new_size)
        write_depth_mm(out / f"{f.stem}.png", remapped.cpu().numpy())
        count += 1
    return count
