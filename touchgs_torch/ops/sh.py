"""Real spherical harmonics colour evaluation, degrees 0..3 (port of
``touchgs_tpu/ops/sh.py``).

``active_degree`` masks higher bands with a multiplier, as the trainer grows
the degree over time (splatfacto's ``sh_degree_interval``).
"""
from __future__ import annotations

import torch

# band constants
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(
    sh: torch.Tensor,           # (..., K, 3) coefficients, K = (deg+1)^2
    dirs: torch.Tensor,         # (..., 3) unit view directions
    degree: int,
    active_degree: int | None = None,
) -> torch.Tensor:
    """Evaluate SH colours; returns (..., 3) before the +0.5 offset, which
    the caller applies (3DGS: colour = clip(eval_sh + 0.5, 0))."""
    K = num_sh_bases(degree)
    if sh.shape[-2] != K:
        raise ValueError(f"sh has {sh.shape[-2]} bases, want {K}")
    if active_degree is None:
        active_degree = degree
    active_degree = int(active_degree)

    result = _C0 * sh[..., 0, :]
    if degree >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        band1 = (-_C1 * y * sh[..., 1, :]
                 + _C1 * z * sh[..., 2, :]
                 - _C1 * x * sh[..., 3, :])
        result = result + band1 * float(active_degree >= 1)
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        band2 = (_C2[0] * xy * sh[..., 4, :]
                 + _C2[1] * yz * sh[..., 5, :]
                 + _C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                 + _C2[3] * xz * sh[..., 7, :]
                 + _C2[4] * (xx - yy) * sh[..., 8, :])
        result = result + band2 * float(active_degree >= 2)
    if degree >= 3:
        band3 = (_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                 + _C3[1] * xy * z * sh[..., 10, :]
                 + _C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                 + _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                 + _C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                 + _C3[5] * z * (xx - yy) * sh[..., 14, :]
                 + _C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
        result = result + band3 * float(active_degree >= 3)
    return result


def rgb_to_sh_dc(rgb):
    """Invert the DC band: colour c → coefficient so eval_sh + 0.5 == c.
    Takes a numpy array or a tensor and returns the same kind."""
    return (rgb - 0.5) / _C0


def sh_dc_to_rgb(dc: torch.Tensor) -> torch.Tensor:
    """The DC band's colour: coefficient → eval_sh + 0.5 at degree 0."""
    return dc * _C0 + 0.5
