"""SE(3) / pose utilities in numpy (port of
``touchgs_tpu/utils/transforms.py``).

Reproduces the pose-normalization contract of the reference dataparser
(``legacy/dataparser_tactile.py:222-235``): auto-orient with the "up"
method, center with the "poses" method, then auto-scale translations into
the +/-1 box.  All functions here are pure numpy; they run once at dataset
load, never inside a train step.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "rotation_between",
    "auto_orient_and_center_poses",
    "auto_scale_poses",
    "quat_to_rotmat_np",
    "focal_from_fov",
]


def rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector ``a`` to unit vector ``b``.

    Rodrigues construction; robust to the anti-parallel case (falls back to a
    180-degree rotation about an arbitrary orthogonal axis).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-10:
        if c > 0:
            return np.eye(3)
        # anti-parallel: rotate 180 deg around any axis orthogonal to a
        axis = np.cross(a, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0]))
        axis = axis / np.linalg.norm(axis)
        K = np.array(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
        )
        return np.eye(3) + 2.0 * K @ K
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K * (1.0 / (1.0 + c))


def auto_orient_and_center_poses(
    poses: np.ndarray,
    method: str = "up",
    center_method: str = "poses",
) -> tuple[np.ndarray, np.ndarray]:
    """Orient and center a batch of camera-to-world poses.

    Args:
        poses: (N, 4, 4) c2w matrices (OpenGL convention: +X right, +Y up,
            -Z forward — the transforms.json convention).
        method: "up" rotates the mean camera up-vector (column 1) onto +Z;
            "none" leaves orientation.
        center_method: "poses" recenters on the mean camera origin; "none"
            leaves translation.

    Returns:
        (oriented_poses (N,4,4), applied_transform (3,4)) — matching the
        reference dataparser semantics (dataparser_tactile.py:222-227).
    """
    poses = np.asarray(poses, dtype=np.float64)
    origins = poses[:, :3, 3]

    if center_method == "poses":
        translation = origins.mean(axis=0)
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(f"unknown center_method {center_method!r}")

    if method == "up":
        up = poses[:, :3, 1].mean(axis=0)
        up = up / np.linalg.norm(up)
        rotation = rotation_between(up, np.array([0.0, 0.0, 1.0]))
    elif method == "none":
        rotation = np.eye(3)
    else:
        raise ValueError(f"unknown orientation method {method!r}")

    transform = np.concatenate(
        [rotation, rotation @ -translation[:, None]], axis=1
    )  # (3, 4)
    bottom = np.array([[0.0, 0.0, 0.0, 1.0]])
    transform44 = np.concatenate([transform, bottom], axis=0)
    oriented = np.einsum("ij,njk->nik", transform44, poses)
    return oriented.astype(np.float32), transform.astype(np.float32)


def auto_scale_poses(poses: np.ndarray, extra_scale: float = 1.0) -> tuple[np.ndarray, float]:
    """Scale translations so cameras fit in the +/-1 box.

    Matches dataparser_tactile.py:230-235: ``scale = 1/max(|t|) * extra``.
    """
    poses = np.array(poses, dtype=np.float32, copy=True)
    max_abs = float(np.max(np.abs(poses[:, :3, 3])))
    scale = (1.0 / max_abs if max_abs > 0 else 1.0) * extra_scale
    poses[:, :3, 3] *= scale
    return poses, scale


def quat_to_rotmat_np(q: np.ndarray) -> np.ndarray:
    """(..., 4) wxyz quaternion → (..., 3, 3) rotation matrix (numpy)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.stack(
        [
            1 - 2 * (y**2 + z**2), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x**2 + z**2), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x**2 + y**2),
        ],
        axis=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def focal_from_fov(fov_radians: float, size_pixels: int) -> float:
    """Focal length in pixels from a field-of-view angle.

    Contract of ``legacy/armPose2Nerf.py:19-47`` (camera_angle_x → fl_x).
    """
    return 0.5 * size_pixels / np.tan(0.5 * fov_radians)
