"""SO3xR3 camera pose optimizer (port of ``touchgs_tpu/models/pose_opt.py``).

The reference trainer registers ``camera_optimizer mode="SO3xR3"``
(``legacy/config_tactile.py:36-37``): per-camera 6-DoF tangent vectors — 3
translation + 3 so(3) — optimized jointly with the model and applied to
each camera-to-world on the fly.  One ``(n_cameras, 6)`` tensor lives in the
train state; the step takes the active view's row, so its gradient flows
through the rasterizer, and the Adam update is dense over all rows (zero
gradients elsewhere, nerfstudio semantics).
"""
from __future__ import annotations

import dataclasses

import torch

from touchgs_torch.data.cameras import Camera


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (3,) so(3) tangent → (3, 3) rotation.

    Uses the series-safe form around θ→0 (sin θ/θ and (1−cos θ)/θ²)."""
    theta2 = torch.sum(omega * omega)
    wx, wy, wz = omega[0], omega[1], omega[2]
    zero = torch.zeros_like(wx)
    K = torch.stack([
        torch.stack([zero, -wz, wy]),
        torch.stack([wz, zero, -wx]),
        torch.stack([-wy, wx, zero]),
    ])
    # sinθ/θ and (1−cosθ)/θ² with small-angle Taylor guards.  The branch not
    # taken is evaluated at θ² = 1 (double-where): otherwise its 1/θ²-shaped
    # GRADIENT at θ = 0 is NaN through torch.where — the state every pose
    # delta starts in.
    small = theta2 < 1e-12
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    return (torch.eye(3, dtype=omega.dtype, device=omega.device) + a * K
            + b * (K @ K))


def apply_pose_delta(camera: Camera, tau: torch.Tensor) -> Camera:
    """Apply a 6-DoF tangent ``tau = [t(3), ω(3)]`` to the camera-to-world:
    R' = exp(ω)·R (left/world-frame perturbation), t' = t + t_delta.
    Device ops only (the bottom row [0, 0, 0, 1] is the identity's), so
    that the graphed pose step can take it."""
    R = exp_so3(tau[3:6]) @ camera.c2w[:3, :3]
    t = camera.c2w[:3, 3] + tau[0:3]
    bottom = torch.eye(4, dtype=camera.c2w.dtype,
                       device=camera.c2w.device)[3:]
    c2w = torch.cat([torch.cat([R, t[:, None]], dim=1), bottom], dim=0)
    return dataclasses.replace(camera, c2w=c2w)
