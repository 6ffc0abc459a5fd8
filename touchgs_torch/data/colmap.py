"""COLMAP text-format parsing + COLMAP↔Blender scale estimation (port of
``touchgs_tpu/data/colmap.py``; numpy, as there).

Rebuilds the offline preprocessing tooling:
- ``read_colmap_cameras``/``read_colmap_images`` — cameras.txt / images.txt
  parsing with the world-frame inversion ``-Rᵀt``
  (``utils/transforms_utils.py:56-119``,
  ``data_preprocessing/vision/point_cloud/read_point_cloud.py:11-79``)
- ``compute_scale_factor`` — mean pairwise camera-distance ratio
  (``data_preprocessing/vision/colmap/compute_colmap_blender_transform.py:64-84``)
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from touchgs_torch.utils.transforms import quat_to_rotmat_np


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific (SIMPLE_RADIAL: f, cx, cy, k)

    @property
    def intrinsics(self) -> tuple[float, float, float, float]:
        """(fx, fy, cx, cy) for the common models."""
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
            f, cx, cy = self.params[0], self.params[1], self.params[2]
            return float(f), float(f), float(cx), float(cy)
        if self.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE"):
            fx, fy, cx, cy = self.params[:4]
            return float(fx), float(fy), float(cx), float(cy)
        raise ValueError(f"unsupported COLMAP camera model {self.model}")


def read_colmap_cameras(path: str | Path) -> dict[int, ColmapCamera]:
    cams = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam = ColmapCamera(
            camera_id=int(parts[0]), model=parts[1],
            width=int(parts[2]), height=int(parts[3]),
            params=np.array([float(p) for p in parts[4:]]),
        )
        cams[cam.camera_id] = cam
    return cams


def read_colmap_images(
    path: str | Path, return_full_transforms: bool = False
) -> dict:
    """images.txt → {image_stem: camera world position} (or full 4×4 c2w).

    COLMAP stores world→camera (qw qx qy qz, t); camera center = −Rᵀt and
    c2w rotation = Rᵀ (transforms_utils.py:84-96).
    """
    positions, transforms = {}, {}
    lines = [
        l for l in Path(path).read_text().splitlines()
        if l.strip() and not l.startswith("#")
    ]
    for i in range(0, len(lines), 2):  # every other line is 2D points
        parts = lines[i].split()
        if len(parts) < 10:
            continue
        qw, qx, qy, qz = map(float, parts[1:5])
        t = np.array([float(parts[5]), float(parts[6]), float(parts[7])])
        name = parts[9]
        R = quat_to_rotmat_np(np.array([qw, qx, qy, qz]))
        center = -R.T @ t
        T = np.eye(4)
        T[:3, :3] = R.T
        T[:3, 3] = center
        stem = name.split(".")[0]
        positions[stem] = center
        transforms[stem] = T
    return transforms if return_full_transforms else positions


def compute_scale_factor(
    positions_a: dict[str, np.ndarray], positions_b: dict[str, np.ndarray]
) -> float:
    """Mean pairwise-distance ratio a/b over shared camera names
    (compute_colmap_blender_transform.py:64-84)."""
    names = [n for n in positions_a if n in positions_b]
    ratios = []
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            da = np.linalg.norm(positions_a[names[i]] - positions_a[names[j]])
            db = np.linalg.norm(positions_b[names[i]] - positions_b[names[j]])
            if db > 1e-12:
                ratios.append(da / db)
    if not ratios:
        raise ValueError("no shared camera pairs between the two pose sets")
    return float(np.mean(ratios))
