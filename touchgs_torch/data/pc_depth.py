"""Point-cloud → depth-image rendering, z-buffered (port of
``touchgs_tpu/data/pc_depth.py``).

Rebuild of ``data_preprocessing/vision/point_cloud/read_point_cloud.py``:
point projection + z-buffer depth images (:224-302) and normal-based
visibility filtering (:103-135,362-384).  The z-buffer is a scatter-min,
``scatter_reduce(..., "amin")`` into a flat buffer with one spare slot that
takes the points outside the image: deterministic, as JAX's ``at[].min``.
Torch ops on the points' device.
"""
from __future__ import annotations

import numpy as np
import torch

from touchgs_torch.data.cameras import Camera

BIG = 1e10    # the empty z-buffer's depth


def visibility_by_normals(
    points: np.ndarray,      # (P, 3)
    normals: np.ndarray,     # (P, 3)
    cam_origin: np.ndarray,  # (3,)
    max_angle_deg: float = 90.0,
) -> np.ndarray:
    """Front-facing filter: keep points whose normal faces the camera within
    `max_angle_deg` (read_point_cloud.py:103-135 semantics)."""
    view = cam_origin[None, :] - points
    view = view / np.maximum(np.linalg.norm(view, axis=1, keepdims=True), 1e-12)
    n = normals / np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
    cosang = np.einsum("ij,ij->i", view, n)
    return cosang > np.cos(np.deg2rad(max_angle_deg))


def render_pc_depth(
    points: torch.Tensor,  # (P, 3) world
    w2c: torch.Tensor,     # (4, 4) OpenCV (+Z forward)
    fx, fy, cx, cy,
    width: int,
    height: int,
    splat: int = 1,        # point footprint in pixels (square)
) -> torch.Tensor:
    """Z-buffered depth image: nearest point per pixel, 0 where empty."""
    w2c = w2c.to(points)
    p_cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = p_cam[:, 2]
    valid = z > 1e-6
    zs = torch.where(valid, z, torch.ones_like(z))
    ui = torch.floor(fx * p_cam[:, 0] / zs + cx).to(torch.int64)
    vi = torch.floor(fy * p_cam[:, 1] / zs + cy).to(torch.int64)

    zval = torch.where(valid, z, torch.full_like(z, BIG))
    zbuf = torch.full((height * width + 1,), BIG, dtype=points.dtype,
                      device=points.device)
    for dy in range(splat):
        for dx in range(splat):
            uu = ui + dx - splat // 2
            vv = vi + dy - splat // 2
            inside = (valid & (uu >= 0) & (uu < width) & (vv >= 0)
                      & (vv < height))
            flat = torch.where(inside, vv * width + uu,
                               torch.full_like(uu, height * width))
            zbuf.scatter_reduce_(0, flat, zval, "amin")
    depth = zbuf[:-1].reshape(height, width)
    return torch.where(depth < BIG, depth, torch.zeros_like(depth))


def render_pc_depth_for_camera(
    points: np.ndarray,
    camera: Camera,
    normals: np.ndarray | None = None,
    splat: int = 1,
) -> np.ndarray:
    """Host wrapper with optional normal-based visibility filtering; renders
    on the camera's device."""
    pts = np.asarray(points, np.float32)
    if normals is not None:
        keep = visibility_by_normals(
            pts, np.asarray(normals, np.float32),
            camera.c2w[:3, 3].cpu().numpy(),
        )
        pts = pts[keep]
        if len(pts) == 0:
            return np.zeros((camera.height, camera.width), np.float32)
    depth = render_pc_depth(
        torch.as_tensor(pts, device=camera.c2w.device), camera.w2c,
        camera.fx, camera.fy, camera.cx, camera.cy, camera.width,
        camera.height, splat,
    )
    return depth.cpu().numpy()
