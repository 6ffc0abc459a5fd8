"""Camera-path rendering (port of ``touchgs_tpu/eval/render_path.py``:
ns-render camera-path, novel-view video from a trained model).

Supports nerfstudio-style camera-path JSON ({"camera_path": [{
"camera_to_world": 16 floats, "fov": deg}, ...], "render_height/width"}),
orbit-path generation, and pose interpolation (slerp + lerp) between
keyframes.  Frames are written as PNGs; an mp4 is assembled when imageio has
an ffmpeg backend available.  Cameras are built on the parameters' device.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from touchgs_torch.config import TrainConfig
from touchgs_torch.data.cameras import Camera
from touchgs_torch.data.png import write_png
from touchgs_torch.models.gaussians import GaussianParams
from touchgs_torch.models.splatfacto import render_lossless
from touchgs_torch.utils.transforms import focal_from_fov, quat_to_rotmat_np


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def _rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w < 1e-8:
        # fallback for 180-degree rotations
        i = int(np.argmax(np.diag(R)))
        q = np.zeros(4)
        q[i + 1] = 1.0
        return q
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def interpolate_poses(
    keyframes: Sequence[np.ndarray], n_frames: int
) -> list[np.ndarray]:
    """Slerp rotations + lerp translations along the keyframe sequence."""
    keyframes = [np.asarray(k, np.float64) for k in keyframes]
    if len(keyframes) == 1:
        return [keyframes[0]] * n_frames
    out = []
    segs = len(keyframes) - 1
    for i in range(n_frames):
        u = i / max(n_frames - 1, 1) * segs
        s = min(int(u), segs - 1)
        t = u - s
        q = _slerp(_rotmat_to_quat(keyframes[s][:3, :3]),
                   _rotmat_to_quat(keyframes[s + 1][:3, :3]), t)
        T = np.eye(4)
        T[:3, :3] = quat_to_rotmat_np(q)
        T[:3, 3] = (1 - t) * keyframes[s][:3, 3] + t * keyframes[s + 1][:3, 3]
        out.append(T)
    return out


def orbit_path(
    radius: float = 2.0, height: float = 0.5, n_frames: int = 60,
    target=(0.0, 0.0, 0.0),
) -> list[np.ndarray]:
    """A circular orbit around the scene center (OpenGL c2w poses)."""
    target = np.asarray(target, np.float64)
    poses = []
    for i in range(n_frames):
        ang = 2 * np.pi * i / n_frames
        eye = target + np.array([radius * np.cos(ang), radius * np.sin(ang),
                                 height])
        fwd = target - eye
        fwd /= np.linalg.norm(fwd)
        up_hint = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up_hint)
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, up, -fwd, eye
        poses.append(T)
    return poses


def load_camera_path_json(path: str | Path
                          ) -> tuple[list[np.ndarray], int, int, float]:
    """nerfstudio camera-path JSON → (c2w list, width, height, fov_deg)."""
    data = json.loads(Path(path).read_text())
    poses = [
        np.array(k["camera_to_world"], np.float64).reshape(4, 4)
        for k in data["camera_path"]
    ]
    w = int(data.get("render_width", 1280))
    h = int(data.get("render_height", 720))
    fov = float(data["camera_path"][0].get("fov", 60.0))
    return poses, w, h, fov


def render_camera_path(
    params: GaussianParams,
    poses: Sequence[np.ndarray],
    cfg: TrainConfig,
    width: int = 640,
    height: int = 480,
    fov_deg: float = 60.0,
    out_dir: Optional[str | Path] = None,
    video_path: Optional[str | Path] = None,
    fps: int = 24,
) -> list[np.ndarray]:
    """Render RGB frames along a pose sequence; optionally write PNGs/mp4."""
    dev = params.means.device
    focal = focal_from_fov(np.deg2rad(fov_deg), width)

    def scalar(v):
        return torch.tensor(np.float32(v), device=dev)

    frames = []
    for pose in poses:
        cam = Camera(
            fx=scalar(focal), fy=scalar(focal),
            cx=scalar(width / 2), cy=scalar(height / 2),
            c2w=torch.as_tensor(np.asarray(pose, np.float32), device=dev),
            width=width, height=height,
        )
        out = render_lossless(params, cam, cfg.model,
                              active_sh_degree=cfg.model.sh_degree)
        frames.append(
            (np.clip(out.rgb.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        )
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(frames):
            write_png(out_dir / f"frame_{i:05d}.png", f)
    if video_path is not None:
        try:
            import imageio.v2 as imageio

            imageio.mimwrite(str(video_path), frames, fps=fps)
        except Exception as e:  # no ffmpeg backend in minimal images
            print(f"video write skipped ({e}); PNG frames are in {out_dir}")
    return frames
