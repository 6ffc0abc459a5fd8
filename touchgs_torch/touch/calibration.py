"""DenseTact fisheye calibration: line detection and GP radius↔angle
regression (port of ``touchgs_tpu/touch/calibration.py``).

- ``detect_radial_lines`` finds radial line segments on a printed target
  with OpenCV (imported when called; the rest needs no OpenCV);
- ``fit_radius_angle_gp`` fits an exact RBF-kernel GP from pixel radius to
  outgoing ray angle, and ``build_lookup_table`` evaluates it on a dense
  radius grid, the per-sensor table the rectification path consumes
  (``rectification_indices``).

The 1-D GP is a small exact solve through a Cholesky factor on the given
device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


def detect_radial_lines(
    image: np.ndarray,
    center: Optional[tuple[float, float]] = None,
    min_length: float = 20.0,
    max_center_miss: float = 25.0,
) -> np.ndarray:
    """Detect line segments pointing at the image center.

    Returns a (K, 4) array of segments [x0, y0, x1, y1] whose infinite
    extension passes within ``max_center_miss`` px of the (given or image)
    center.  Uses OpenCV's FastLineDetector where opencv-contrib has it,
    else a Hough detector.
    """
    import cv2

    gray = image
    if gray.ndim == 3:
        gray = cv2.cvtColor(gray, cv2.COLOR_RGB2GRAY)
    gray = np.asarray(gray, np.uint8)
    h, w = gray.shape
    cx, cy = center if center is not None else (w / 2.0, h / 2.0)

    segs = None
    if hasattr(cv2, "ximgproc") and hasattr(cv2.ximgproc,
                                            "createFastLineDetector"):
        fld = cv2.ximgproc.createFastLineDetector(
            length_threshold=int(min_length))
        out = fld.detect(gray)
        if out is not None:
            segs = out.reshape(-1, 4)
    if segs is None:
        edges = cv2.Canny(gray, 50, 150)
        out = cv2.HoughLinesP(
            edges, 1, np.pi / 180, threshold=40,
            minLineLength=int(min_length), maxLineGap=4)
        segs = (out.reshape(-1, 4).astype(np.float32) if out is not None
                else np.zeros((0, 4), np.float32))

    if len(segs) == 0:
        return segs

    # keep segments whose supporting line passes near the center
    x0, y0, x1, y1 = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
    dx, dy = x1 - x0, y1 - y0
    length = np.hypot(dx, dy)
    ok_len = length >= min_length
    dist = np.abs(dy * (cx - x0) - dx * (cy - y0)) / np.maximum(length, 1e-9)
    return segs[ok_len & (dist <= max_center_miss)]


@dataclasses.dataclass(frozen=True)
class RadiusAngleGP:
    """Exact 1-D GP regression pixel radius → ray angle (RBF kernel)."""

    x: torch.Tensor            # (N, 1) training radii (normalized)
    alpha: torch.Tensor        # (N,) K⁻¹ y
    L: torch.Tensor            # (N, N)
    lengthscale: torch.Tensor  # 0-dim
    signal_var: torch.Tensor   # 0-dim
    x_scale: torch.Tensor      # 0-dim normalization constant

    def predict(self, radii) -> tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean and variance at query radii (any shape), on the
        GP's device."""
        r = torch.as_tensor(radii, dtype=torch.float32, device=self.x.device)
        q = r.reshape(-1, 1) / self.x_scale
        d2 = (q - self.x[:, 0][None, :]) ** 2
        ks = self.signal_var * torch.exp(-0.5 * d2 / self.lengthscale ** 2)
        mean = ks @ self.alpha
        v = torch.linalg.solve_triangular(self.L, ks.T, upper=False)
        var = torch.clamp(self.signal_var - torch.sum(v * v, dim=0), min=0.0)
        return mean.reshape(r.shape), var.reshape(r.shape)


def radius_angle_gp_from_numpy(x, alpha, L, lengthscale, signal_var, x_scale,
                               device: torch.device | str = "cuda"
                               ) -> RadiusAngleGP:
    """A GP fitted elsewhere (the JAX package's ``RadiusAngleGP`` leaves,
    as numpy) as the port's, float32 on ``device``."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return RadiusAngleGP(x=t(x), alpha=t(alpha), L=t(L),
                         lengthscale=t(lengthscale),
                         signal_var=t(signal_var), x_scale=t(x_scale))


def fit_radius_angle_gp(
    radii: np.ndarray,
    angles: np.ndarray,
    lengthscale: float = 0.2,
    signal_var: float = 1.0,
    noise: float = 1e-3,
    device: torch.device | str = "cuda",
) -> RadiusAngleGP:
    """Fit the radius→angle GP (RBF kernel, exact) on ``device``."""
    r = np.asarray(radii, np.float32).reshape(-1)
    a = np.asarray(angles, np.float32).reshape(-1)
    x_scale = float(max(np.abs(r).max(), 1e-6))
    x = torch.as_tensor(r[:, None] / x_scale, device=device)
    y = torch.as_tensor(a, device=device)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    d2 = (x - x[:, 0][None, :]) ** 2
    ls, sv = scalar(lengthscale), scalar(signal_var)
    K = sv * torch.exp(-0.5 * d2 / ls ** 2)
    K = K + (noise ** 2 + 1e-6) * torch.eye(len(r), device=device)
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(y[:, None], L, upper=False)[:, 0]
    return RadiusAngleGP(x=x, alpha=alpha, L=L, lengthscale=ls,
                         signal_var=sv, x_scale=scalar(x_scale))


def build_lookup_table(gp: RadiusAngleGP, max_radius: int,
                       n: Optional[int] = None) -> np.ndarray:
    """Dense radius→angle table (what the reference bakes into its calib
    npy files), as numpy."""
    n = n if n is not None else max_radius + 1
    grid = torch.linspace(0.0, float(max_radius), n, device=gp.x.device)
    mean, _ = gp.predict(grid)
    return mean.cpu().numpy()


def rectification_indices(
    lut: np.ndarray,
    image_size: int,
    fov_deg: float = 180.0,
) -> np.ndarray:
    """Equidistant-fisheye rectification index map from a radius→angle
    table (numpy): output pixel (i, j) at target angle θ maps to the
    source radius whose table angle is nearest θ."""
    half = image_size / 2.0
    yy, xx = np.mgrid[0:image_size, 0:image_size]
    r_out = np.hypot(xx - half, yy - half)
    theta = r_out / half * np.deg2rad(fov_deg / 2.0)

    lut_angles = np.asarray(lut)
    # monotonic envelope so searchsorted is valid even with GP wiggle
    lut_mono = np.maximum.accumulate(lut_angles)
    src_r = np.searchsorted(lut_mono, theta.reshape(-1)).clip(
        0, len(lut_mono) - 1).astype(np.float32)

    ang = np.arctan2(yy - half, xx - half).reshape(-1)
    sx = (half + src_r * np.cos(ang)).clip(0, image_size - 1)
    sy = (half + src_r * np.sin(ang)).clip(0, image_size - 1)
    return (sy.round() * image_size + sx.round()).astype(np.int64)


def calibrate_sensor(
    image: np.ndarray,
    known_angles: Callable[[np.ndarray], np.ndarray],
    center: Optional[tuple[float, float]] = None,
    **gp_kwargs,
) -> RadiusAngleGP:
    """Detect radial lines → sample endpoint radii → fit the GP.
    ``known_angles`` maps endpoint radii to target angles (from the printed
    target's geometry); ``gp_kwargs`` go to ``fit_radius_angle_gp``, its
    ``device`` among them."""
    segs = detect_radial_lines(image, center=center)
    if len(segs) == 0:
        raise ValueError("no radial line segments detected")
    h, w = image.shape[:2]
    cx, cy = center if center is not None else (w / 2.0, h / 2.0)
    pts = np.concatenate([segs[:, :2], segs[:, 2:]], axis=0)
    radii = np.hypot(pts[:, 0] - cx, pts[:, 1] - cy)
    angles = known_angles(radii)
    return fit_radius_angle_gp(radii, angles, **gp_kwargs)
