"""Capture-to-dataset converters (robot / Blender captures → transforms.json;
port of ``touchgs_tpu/data/capture_convert.py``, numpy as there, with image
sizes read by the port's PNG codec, ``data/png.py``).

Rebuild of ``legacy/armPose2Nerf.py``: multi-modal capture dirs (color /
depth / touch) become one nerfstudio-style transforms.json —

- focal resolution from fl_* or camera_angle_* (:19-47)
- principal point defaults to the image center (:50-59)
- near/far depth rescale of 8-bit depth captures: d = raw/255·(far−near)+near
  with near mapped to invalid 0 (:124-127)
- the capture-frame pose chain Ry(π/2) / Rx(π) inversion sandwich + unit
  scaling (:129-139)
- camera_model OPENCV for color/depth, OPENCV_FISHEYE for touch (:143-146)
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np

from touchgs_torch.data.png import image_size


def _rx(t):
    return np.array([[1, 0, 0],
                     [0, np.cos(t), -np.sin(t)],
                     [0, np.sin(t), np.cos(t)]])


def _ry(t):
    return np.array([[np.cos(t), 0, np.sin(t)],
                     [0, 1, 0],
                     [-np.sin(t), 0, np.cos(t)]])


def resolve_focal(height: int, width: int, config: dict) -> tuple[float, float]:
    """armPose2Nerf `get_fl` (:19-47)."""
    if "fl_x" in config and "fl_y" in config:
        return config["fl_x"], config["fl_y"]
    if "fl_x" in config:
        return config["fl_x"], config["fl_x"]
    if "fl_y" in config:
        return config["fl_y"], config["fl_y"]
    if "camera_angle_x" in config and "camera_angle_y" in config:
        return (width / (2 * np.tan(config["camera_angle_x"] / 2)),
                height / (2 * np.tan(config["camera_angle_y"] / 2)))
    if "camera_angle_x" in config:
        f = width / (2 * np.tan(config["camera_angle_x"] / 2))
        return f, f
    if "camera_angle_y" in config:
        f = height / (2 * np.tan(config["camera_angle_y"] / 2))
        return f, f
    raise RuntimeError("no focal length information in transforms config")


def convert_capture_pose(pose: np.ndarray, units: float = 1.0) -> np.ndarray:
    """The pose-frame correction chain (:129-139)."""
    pose = np.asarray(pose, np.float64)
    T1 = np.eye(4)
    T1[:3, :3] = _ry(np.pi / 2)
    pose = np.linalg.inv(T1 @ pose)
    T2 = np.eye(4)
    T2[:3, :3] = _rx(np.pi)
    pose = np.linalg.inv(T2 @ pose)
    pose[:3, 3] *= units
    return pose


def rescale_depth_capture(raw: np.ndarray, near: float, far: float) -> np.ndarray:
    """8-bit depth capture → metric depth with near→0 invalid (:124-126)."""
    depth = raw.astype(np.float32) / 255.0 * (far - near) + near
    depth[depth == near] = 0.0
    return depth


def captures_to_transforms(
    root_path: str | Path,
    modes: Sequence[str] = ("color",),
    transform_name: str = "transforms_train.json",
    units: float = 1.0,
    output_path: str | Path | None = None,
) -> dict:
    """Convert capture dirs to one transforms.json (armPose2Nerf `main`)."""
    root = Path(root_path).expanduser()
    frames_out = []
    for mode in modes:
        mode_path = root / mode
        meta = json.loads((mode_path / transform_name).read_text())
        cameras = meta.get("cameras")
        for frame in meta["frames"]:
            fp = mode_path / frame["file_path"]
            if not fp.exists():
                continue
            height, width = image_size(fp)
            cam_cfg = (cameras[frame["camera"]] if cameras else meta)
            fl_x, fl_y = resolve_focal(height, width, cam_cfg)
            cx = cam_cfg.get("cx", width / 2)
            cy = cam_cfg.get("cy", height / 2)

            entry = {
                "camera_model": (
                    "OPENCV_FISHEYE" if mode == "touch" else "OPENCV"
                ),
                "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy,
                "w": width, "h": height,
                "k1": 0.0, "k2": 0.0, "k3": 0.0, "k4": 0.0,
                "p1": 0.0, "p2": 0.0,
                "file_path": str(Path(".") / mode / frame["file_path"]),
                "transform_matrix": convert_capture_pose(
                    np.array(frame["transform_matrix"]), units
                ).tolist(),
            }
            if mode in ("depth", "touch"):
                stem = fp.stem
                entry["depth_file_path"] = str(
                    Path(".") / mode / "train" / f"{stem}_depth.png"
                )
            frames_out.append(entry)

    out = {"frames": frames_out}
    if output_path is not None:
        Path(output_path).write_text(json.dumps(out, indent=4))
    return out
