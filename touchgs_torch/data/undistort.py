"""Lens-distortion handling for scene loading (port of
``touchgs_tpu/data/undistort.py``).

The reference dataparser reads per-frame distortion parameters
(k1-k4, p1, p2) and a ``camera_model`` of OPENCV or OPENCV_FISHEYE
(``legacy/dataparser_tactile.py:92-146``); touch cameras are fisheye
(``legacy/armPose2Nerf.py:143-146``).  nerfstudio
undistorts images to an ideal pinhole before training; we do the same at
load time: for every *undistorted* output pixel, apply the forward
distortion model to find its source position in the captured image and
bilinear-sample (nearest for depth maps — interpolating across a depth edge
invents surfaces).  Host-side numpy: this runs once per scene load.
"""
from __future__ import annotations

import numpy as np

# distortion parameter order follows nerfstudio/transforms.json keys
PARAM_KEYS = ("k1", "k2", "k3", "k4", "p1", "p2")


def distort_normalized(x: np.ndarray, y: np.ndarray, params: np.ndarray,
                       fisheye: bool) -> tuple[np.ndarray, np.ndarray]:
    """Forward distortion of ideal normalized coords (x, y) = ((u−cx)/fx, …).

    OPENCV (Brown–Conrady): radial k1..k4 + tangential p1, p2.
    OPENCV_FISHEYE: equidistant θ-polynomial (k1..k4), no tangential.
    """
    k1, k2, k3, k4, p1, p2 = [float(p) for p in params]
    r2 = x * x + y * y
    if fisheye:
        r = np.sqrt(np.maximum(r2, 1e-12))
        theta = np.arctan(r)
        t2 = theta * theta
        theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = np.where(r2 > 1e-12, theta_d / r, 1.0)
        return x * scale, y * scale
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def _bilinear(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    u0 = np.clip(np.floor(u).astype(np.int64), 0, w - 1)
    v0 = np.clip(np.floor(v).astype(np.int64), 0, h - 1)
    u1 = np.clip(u0 + 1, 0, w - 1)
    v1 = np.clip(v0 + 1, 0, h - 1)
    fu = np.clip(u - u0, 0.0, 1.0)[..., None]
    fv = np.clip(v - v0, 0.0, 1.0)[..., None]
    im = img if img.ndim == 3 else img[..., None]
    out = (im[v0, u0] * (1 - fu) * (1 - fv) + im[v0, u1] * fu * (1 - fv)
           + im[v1, u0] * (1 - fu) * fv + im[v1, u1] * fu * fv)
    return out if img.ndim == 3 else out[..., 0]


def _nearest(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    ui = np.clip(np.rint(u).astype(np.int64), 0, w - 1)
    vi = np.clip(np.rint(v).astype(np.int64), 0, h - 1)
    return img[vi, ui]


def undistort_image(img: np.ndarray, fx: float, fy: float, cx: float,
                    cy: float, params: np.ndarray, fisheye: bool,
                    nearest: bool = False) -> np.ndarray:
    """Rectify a distorted capture to the ideal pinhole with the SAME
    intrinsics (nerfstudio convention: K is kept, distortion removed)."""
    h, w = img.shape[:2]
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    x = (u + 0.5 - cx) / fx
    y = (v + 0.5 - cy) / fy
    xd, yd = distort_normalized(x, y, params, fisheye)
    us = fx * xd + cx - 0.5
    vs = fy * yd + cy - 0.5
    samp = _nearest if nearest else _bilinear
    return samp(img, us, vs).astype(img.dtype, copy=False)
