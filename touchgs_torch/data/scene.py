"""Scene loading: transforms.json → cameras + image/depth/uncertainty stacks
(port of ``touchgs_tpu/data/scene.py``).

Replaces the reference's filesystem pipeline glue
(``legacy/dataparser_tactile.py`` + ``utils/add_depth_file_path_to_transforms.py``)
with one in-process loader.  Frames may carry ``depth_file_path`` and
``uncertainty_file_path`` (the keys written at
``utils/add_depth_file_path_to_transforms.py:37-53``); both are uint16-mm PNGs.

The loader reproduces the dataparser's pose normalization: auto-orient ("up"),
auto-center ("poses"), auto-scale into the +/-1 box
(``legacy/dataparser_tactile.py:222-235``) — and rescales loaded *metric* depth
maps by the same scene scale so depth supervision lives in normalized scene
units, as nerfstudio does via ``depth_unit_scale_factor * dataparser_scale``.
Images are read by the port's PNG codec (``data/png.py``); the `Scene`
stays host numpy, and the trainer uploads a view at a time.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from touchgs_torch.data.cameras import Cameras
from touchgs_torch.data.depth_io import read_depth_mm
from touchgs_torch.data.png import read_rgb
from touchgs_torch.data.splits import linspace_split
from touchgs_torch.data.undistort import PARAM_KEYS, undistort_image
from touchgs_torch.utils.transforms import (
    auto_orient_and_center_poses,
    auto_scale_poses,
)


@dataclasses.dataclass
class Scene:
    """A fully-materialized scene (host numpy; device transfer is per-batch)."""

    cameras: Cameras                      # all views, pose-normalized
    images: np.ndarray                    # (N, H, W, 3) float32 in [0, 1]
    depths: Optional[np.ndarray]          # (N, H, W) float32, scene units, 0 = invalid
    uncertainties: Optional[np.ndarray]   # (N, H, W) float32 (sigma), scene units
    i_train: np.ndarray
    i_eval: np.ndarray
    seed_points: Optional[np.ndarray]     # (P, 3) world (normalized) points
    seed_colors: Optional[np.ndarray]     # (P, 3) float in [0, 1]
    scale_factor: float                   # dataparser scale applied to poses/depth
    transform: np.ndarray                 # (3, 4) applied orientation transform
    name: str = "scene"

    @property
    def num_views(self) -> int:
        return len(self.cameras)

    def train_cameras(self) -> Cameras:
        return self.cameras.select(self.i_train)

    def eval_cameras(self) -> Cameras:
        return self.cameras.select(self.i_eval)


def _load_image(path: Path) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]: PIL's ``convert("RGB")`` over 255."""
    return np.asarray(read_rgb(path), dtype=np.float32) / 255.0


def load_scene(
    data_dir: str | os.PathLike,
    train_split_fraction: float = 0.9,
    downscale_factor: int = 1,
    load_depth: bool = True,
    load_uncertainty: bool = True,
    load_seed_points: bool = True,
    orientation_method: str = "up",
    center_method: str = "poses",
    auto_scale: bool = True,
    max_views: Optional[int] = None,
) -> Scene:
    """Load a Touch-GS-layout scene directory (see SURVEY.md §2.10).

    Expects ``transforms.json`` with global or per-frame intrinsics, optional
    ``depth_file_path``/``uncertainty_file_path`` per frame, and optional
    ``points_touch.npy``/``points_colors.npy`` seeds in the scene root
    (``utils/create_point_cloud_from_touches.py:243-244``).
    """
    data_dir = Path(data_dir)
    meta = json.loads((data_dir / "transforms.json").read_text())
    frames = meta["frames"]
    # deterministic frame order: nerfstudio keeps json order; Touch-GS writes
    # frames sorted by filename
    if max_views is not None:
        frames = frames[:max_views]

    poses, fx, fy, cx, cy = [], [], [], [], []
    dist_params, fisheyes = [], []
    image_paths, depth_paths, unc_paths = [], [], []
    for frame in frames:
        img_path = data_dir / frame["file_path"]
        if not img_path.exists():
            continue
        poses.append(np.array(frame["transform_matrix"], dtype=np.float64))
        fx.append(float(frame.get("fl_x", meta.get("fl_x", 0.0))))
        fy.append(float(frame.get("fl_y", meta.get("fl_y", 0.0))))
        cx.append(float(frame.get("cx", meta.get("cx", 0.0))))
        cy.append(float(frame.get("cy", meta.get("cy", 0.0))))
        # per-frame (or global) distortion + camera model
        # (legacy/dataparser_tactile.py:92-146; touch cams are
        # OPENCV_FISHEYE per armPose2Nerf.py:143-146)
        dist_params.append(np.array(
            [float(frame.get(k, meta.get(k, 0.0))) for k in PARAM_KEYS],
            np.float64))
        fisheyes.append(
            str(frame.get("camera_model",
                          meta.get("camera_model", "OPENCV"))).upper()
            == "OPENCV_FISHEYE")
        image_paths.append(img_path)
        depth_paths.append(
            data_dir / frame["depth_file_path"] if "depth_file_path" in frame else None
        )
        unc_paths.append(
            data_dir / frame["uncertainty_file_path"]
            if "uncertainty_file_path" in frame
            else None
        )
    if not image_paths:
        raise FileNotFoundError(f"no frames with existing images under {data_dir}")

    poses = np.stack(poses)
    poses, transform = auto_orient_and_center_poses(
        poses, method=orientation_method, center_method=center_method
    )
    scale = 1.0
    if auto_scale:
        poses, scale = auto_scale_poses(poses)

    images = np.stack([_load_image(p) for p in image_paths])
    n, h, w = images.shape[:3]

    depths = None
    if load_depth and all(p is not None and p.exists() for p in depth_paths):
        # depth PNGs are metric millimeters; scale into normalized scene units
        depths = np.stack([read_depth_mm(p) * scale for p in depth_paths])
    uncertainties = None
    if load_uncertainty and all(p is not None and p.exists() for p in unc_paths):
        uncertainties = np.stack([read_depth_mm(p) * scale for p in unc_paths])

    # rectify distorted captures to the ideal pinhole (frames with all-zero
    # params pass through untouched); depth/uncertainty use nearest sampling
    if any(p.any() for p in dist_params):
        for i in range(n):
            if not dist_params[i].any():
                continue
            images[i] = undistort_image(
                images[i], fx[i], fy[i], cx[i], cy[i], dist_params[i],
                fisheyes[i])
            if depths is not None:
                depths[i] = undistort_image(
                    depths[i], fx[i], fy[i], cx[i], cy[i], dist_params[i],
                    fisheyes[i], nearest=True)
            if uncertainties is not None:
                uncertainties[i] = undistort_image(
                    uncertainties[i], fx[i], fy[i], cx[i], cy[i],
                    dist_params[i], fisheyes[i], nearest=True)

    cams = Cameras(
        fx=np.array(fx, np.float32), fy=np.array(fy, np.float32),
        cx=np.array(cx, np.float32), cy=np.array(cy, np.float32),
        c2w=poses.astype(np.float32), width=w, height=h,
    )
    if downscale_factor > 1:
        cams = cams.rescale(1.0 / downscale_factor)
        nh, nw = h // downscale_factor, w // downscale_factor
        # area-average RGB (nerfstudio's PIL resize semantics, antialiased);
        # depth/uncertainty take nearest-sample — averaging across a depth
        # edge would invent surfaces that exist in neither neighbor
        d = downscale_factor
        images = images[:, : nh * d, : nw * d]
        images = images.reshape(n, nh, d, nw, d, 3).mean(axis=(2, 4))
        if depths is not None:
            depths = depths[:, : nh * d : d, : nw * d : d]
        if uncertainties is not None:
            uncertainties = uncertainties[:, : nh * d : d, : nw * d : d]
        cams = Cameras(
            fx=cams.fx, fy=cams.fy, cx=cams.cx, cy=cams.cy, c2w=cams.c2w,
            width=nw, height=nh,
        )

    i_train, i_eval = linspace_split(n, train_split_fraction, variant="dataparser")

    seed_points = seed_colors = None
    pts_path = data_dir / "points_touch.npy"
    col_path = data_dir / "points_colors.npy"
    if load_seed_points and pts_path.exists():
        seed_points = np.load(pts_path).astype(np.float32)
        # seeds were produced in the *raw* world frame; bring them into the
        # normalized frame the trainer works in
        seed_points = (seed_points @ transform[:3, :3].T + transform[:3, 3]) * scale
        if col_path.exists():
            seed_colors = np.load(col_path).astype(np.float32) / 255.0
        else:
            seed_colors = np.full_like(seed_points, 0.5)

    return Scene(
        cameras=cams, images=images, depths=depths, uncertainties=uncertainties,
        i_train=i_train, i_eval=i_eval,
        seed_points=seed_points, seed_colors=seed_colors,
        scale_factor=scale, transform=transform, name=data_dir.name,
    )
