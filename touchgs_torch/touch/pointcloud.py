"""Touch point-cloud seeding (port of ``touchgs_tpu/touch/pointcloud.py``).

Pinhole backprojection through (fx, fy, cx, cy), the OpenGL convention flip
``R @ diag(1, -1, -1)``, the world transform, then random ``percent_take``%
subsampling.  The output matches the ``points_touch.npy`` /
``points_colors.npy`` contract: world xyz float, colors 0-255.
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch


def backproject_depth(
    depth: torch.Tensor,          # (H, W) meters, 0 = invalid
    color: torch.Tensor,          # (H, W, 3)
    intrinsics: Sequence[float],  # (fx, fy, cx, cy)
    c2w: torch.Tensor,            # (4, 4) OpenGL camera-to-world
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All pixels backprojected to world on the depth's device; returns
    (points (H·W, 3), colors (H·W, 3), valid (H·W,)) in row-major pixel
    order."""
    h, w = depth.shape
    dev = depth.device
    fx, fy, cx, cy = intrinsics
    vs, us = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    z = depth
    x = (us - cx) * z / fx
    y = (vs - cy) * z / fy
    pts_cam = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    valid = (depth > 0).reshape(-1)

    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], device=dev))
    R = c2w[:3, :3] @ flip
    t = c2w[:3, 3]
    pts_world = pts_cam @ R.T + t
    cols = color.reshape(-1, 3)
    return pts_world, cols, valid


def seed_point_cloud(
    depths: np.ndarray,           # (V, H, W) touch depths, meters
    colors: np.ndarray,           # (V, H, W, 3) rgb in [0, 1]
    intrinsics: Sequence[float],
    c2ws: np.ndarray,             # (V, 4, 4)
    view_indices: np.ndarray,     # the seeding split
    percent_take: float = 100.0,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Seed Gaussians from touch depth across ``view_indices``, each view
    backprojected on ``device``.  The valid points keep the row-major pixel
    order, view after view, so ``np.random.default_rng(seed)``'s draw
    picks the JAX package's points.  Returns (points (P, 3) float32,
    colors_255 (P, 3) float32)."""
    intr = tuple(float(i) for i in intrinsics)
    all_pts, all_cols = [], []
    for v in view_indices:
        pts, cols, valid = backproject_depth(
            torch.as_tensor(np.asarray(depths[v], np.float32), device=device),
            torch.as_tensor(np.asarray(colors[v], np.float32), device=device),
            intr,
            torch.as_tensor(np.asarray(c2ws[v], np.float32), device=device))
        all_pts.append(pts[valid].cpu().numpy())
        all_cols.append(cols[valid].cpu().numpy())
    pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3), np.float32)
    cols = (np.concatenate(all_cols) if all_cols
            else np.zeros((0, 3), np.float32))

    rng = np.random.default_rng(seed)
    n_take = int(len(pts) * percent_take / 100.0)
    sel = rng.choice(len(pts), n_take, replace=False) if len(pts) else []
    return pts[sel].astype(np.float32), (cols[sel] * 255.0).astype(np.float32)


def save_point_cloud(root_dir: str | Path, points: np.ndarray,
                     colors_255: np.ndarray):
    """Write the scene-root seed files."""
    root = Path(root_dir)
    np.save(root / "points_touch.npy", points)
    np.save(root / "points_colors.npy", colors_255)
