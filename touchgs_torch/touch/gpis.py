"""Gaussian Process Implicit Surface (port of ``touchgs_tpu/touch/gpis.py``).

Touch point clouds → per-view depth (posterior-mean surface, meters, NaN
where the GP has no support) and variance maps, sized like the RGB images
(the ``gpis_depth`` / ``gpis_var`` contract).

Model: an implicit-surface GP f: R³→R with f = 0 on the surface and f > 0 in
free space.  Training points are the contact points (targets 0) plus
off-surface points along the surface normals (targets ±ε).  RBF kernel by
default, Matérn 5/2 available.  Exact inference through a Cholesky factor.

Rendering marches camera rays at ``n_samples`` fixed z-depths, finds the
first armed +→− crossing of the posterior mean, interpolates the crossing
depth linearly, gates it on the posterior variance there and turns that
variance into a depth variance (delta method).

Torch ops on the GP's device.  Squared distances are the sum of the three
squared coordinate differences, in the JAX package's order, as
(queries, points) tensors; ``torch.cdist`` switches to a matmul form above
25 rows, which changes the numerics, and is not used.  An fp32 Cholesky of
a Gram matrix with a condition number of 1e6 differs between the two
packages (ROADMAP.md C14); ``gpis_from_numpy`` carries a fitted GP across.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from touchgs_torch.data.cameras import Camera


def _rbf(d2: torch.Tensor, lengthscale, signal_var) -> torch.Tensor:
    return signal_var * torch.exp(-0.5 * d2 / (lengthscale ** 2))


def _matern52(d2: torch.Tensor, lengthscale, signal_var) -> torch.Tensor:
    d = torch.sqrt(torch.clamp(d2, min=1e-20))
    s = math.sqrt(5.0) * d / lengthscale
    return signal_var * (1.0 + s + s ** 2 / 3.0) * torch.exp(-s)


_KERNELS = {"rbf": _rbf, "matern52": _matern52}


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(A, B) squared distances between (A, 3) and (B, 3) points, summed
    over the coordinates in order, without an (A, B, 3) tensor."""
    d2 = (a[:, None, 0] - b[None, :, 0]) ** 2
    d2 = d2 + (a[:, None, 1] - b[None, :, 1]) ** 2
    return d2 + (a[:, None, 2] - b[None, :, 2]) ** 2


@dataclasses.dataclass(frozen=True)
class GPIS:
    X: torch.Tensor            # (N, 3) training inputs
    alpha: torch.Tensor        # (N,) K⁻¹ y
    L: torch.Tensor            # (N, N) lower Cholesky of K + jitter·I
    lengthscale: torch.Tensor  # 0-dim
    signal_var: torch.Tensor   # 0-dim
    noise: torch.Tensor        # 0-dim
    kernel: str = "rbf"
    # the off-surface target ε: the marcher arms on a mean above 0.25·ε, a
    # real approach to the surface, not prior noise around 0
    off_eps: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.off_eps is None:
            object.__setattr__(self, "off_eps", torch.tensor(
                0.02, dtype=torch.float32, device=self.X.device))

    @property
    def num_points(self) -> int:
        return self.X.shape[0]


def gpis_from_numpy(X, alpha, L, lengthscale, signal_var, noise,
                    kernel: str = "rbf", off_eps=0.02,
                    device: torch.device | str = "cuda") -> GPIS:
    """A GP fitted elsewhere (the JAX package's ``GPIS`` leaves, as numpy)
    as the port's, float32 on ``device``."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return GPIS(X=t(X), alpha=t(alpha), L=t(L), lengthscale=t(lengthscale),
                signal_var=t(signal_var), noise=t(noise), kernel=kernel,
                off_eps=t(off_eps))


def estimate_normals(
    points: np.ndarray, k: int = 8, orient_to: Optional[np.ndarray] = None
) -> np.ndarray:
    """Local-PCA normal estimation (host, numpy), oriented toward
    ``orient_to`` (e.g. the sensor or camera origin) when given."""
    n = len(points)
    normals = np.zeros_like(points)
    chunk = max(1, min(1024, n))
    for s in range(0, n, chunk):
        d2 = ((points[s:s + chunk, None] - points[None]) ** 2).sum(-1)
        idx = np.argpartition(d2, min(k, n - 1), axis=1)[:, : k + 1]
        for i, nb in enumerate(idx):
            nbrs = points[nb]
            cov = np.cov((nbrs - nbrs.mean(0)).T)
            w, v = np.linalg.eigh(cov)
            normals[s + i] = v[:, 0]
    if orient_to is not None:
        flip = np.einsum("ij,ij->i", orient_to - points, normals) < 0
        normals[flip] *= -1
    norms = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(norms, 1e-12)


def fit_gpis(
    surface_points: np.ndarray,            # (P, 3)
    normals: Optional[np.ndarray] = None,  # (P, 3) outward normals
    lengthscale: float = 0.05,
    signal_var: float = 1.0,
    noise: float = 1e-4,
    off_surface_eps: float = 0.02,
    max_points: int = 2048,
    kernel: str = "rbf",
    orient_to: Optional[np.ndarray] = None,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> GPIS:
    """Fit the implicit-surface GP: the training set on the host, the Gram
    matrix and its Cholesky factor on ``device``."""
    pts = np.asarray(surface_points, np.float32)
    if len(pts) > max_points:
        rng = np.random.default_rng(seed)
        sel = rng.choice(len(pts), max_points, replace=False)
        pts = pts[sel]
        normals = normals[sel] if normals is not None else None
    if normals is None:
        normals = estimate_normals(pts, orient_to=orient_to)

    X = np.concatenate([
        pts,
        pts + off_surface_eps * normals,   # outside: f = +ε
        pts - off_surface_eps * normals,   # inside:  f = −ε
    ]).astype(np.float32)
    y = np.concatenate([
        np.zeros(len(pts)),
        np.full(len(pts), off_surface_eps),
        np.full(len(pts), -off_surface_eps),
    ]).astype(np.float32)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    Xd = torch.as_tensor(X, device=device)
    yd = torch.as_tensor(y, device=device)
    ls, sv, nz = scalar(lengthscale), scalar(signal_var), scalar(noise)

    kfn = _KERNELS[kernel]
    # a float32 Cholesky of a dense RBF Gram matrix needs a healthy nugget:
    # near-duplicate touch samples make K numerically rank-deficient
    jitter = nz ** 2 + 1e-4 * sv
    K = kfn(_sq_dist(Xd, Xd), ls, sv) + jitter * torch.eye(
        len(X), device=device)
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(yd[:, None], L, upper=False)[:, 0]
    return GPIS(X=Xd, alpha=alpha, L=L, lengthscale=ls, signal_var=sv,
                noise=nz, kernel=kernel, off_eps=scalar(off_surface_eps))


def posterior(gpis: GPIS, queries: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance at (Q, 3) query points."""
    kfn = _KERNELS[gpis.kernel]
    k_star = kfn(_sq_dist(queries, gpis.X), gpis.lengthscale,
                 gpis.signal_var)
    mean = k_star @ gpis.alpha
    v = torch.linalg.solve_triangular(gpis.L, k_star.T, upper=False)
    var = gpis.signal_var - torch.sum(v * v, dim=0)
    return mean, torch.clamp(var, min=0.0)


def posterior_mean(gpis: GPIS, queries: torch.Tensor) -> torch.Tensor:
    """Posterior mean only: one matvec a query, where the variance needs
    an O(N²) triangular solve.  The marcher needs the mean at every sample
    and the variance only at the crossing."""
    kfn = _KERNELS[gpis.kernel]
    return kfn(_sq_dist(queries, gpis.X), gpis.lengthscale,
               gpis.signal_var) @ gpis.alpha


def _march(gpis: GPIS, origins: torch.Tensor, dirs: torch.Tensor,
           near: float, far: float, n_samples: int, pixel_chunk: int,
           support_var_frac: float = 0.5
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ray march (P, 3) origins and dirs (z-normalised, so t is the
    z-depth), ``pixel_chunk`` rays at a time; each pixel's result is its
    own, whatever the chunk."""
    # torch.linspace takes other steps than jnp.linspace (XLA rewrites
    # its division); the samples differ by up to 2 ulps
    ts = torch.linspace(near, far, n_samples, device=origins.device)
    nan = torch.tensor(float("nan"), device=origins.device)
    depths, variances = [], []
    for s in range(0, origins.shape[0], pixel_chunk):
        o = origins[s:s + pixel_chunk]
        d = dirs[s:s + pixel_chunk]
        pts = o[:, None, :] + ts[None, :, None] * d[:, None, :]  # (C, S, 3)
        mean = posterior_mean(gpis, pts.reshape(-1, 3)).reshape(-1, n_samples)
        # a real approach to the surface makes the mean rise toward ~ε in
        # the off-surface shell, then fall through 0 at the surface; prior
        # noise near the support's fringe crosses 0 with tiny amplitudes.
        # The detector arms once the mean exceeds 0.25·ε and fires at the
        # next crossing
        armed = torch.cumsum((mean > 0.25 * gpis.off_eps).to(torch.int32),
                             dim=1) > 0
        crossing = (mean[:, :-1] > 0) & (mean[:, 1:] <= 0) & armed[:, :-1]
        has = torch.any(crossing, dim=1)
        # the first crossing: argmax returns the first of equal maxima
        first = torch.argmax(crossing.to(torch.int32), dim=1)
        m0 = torch.gather(mean, 1, first[:, None])[:, 0]
        m1 = torch.gather(mean, 1, first[:, None] + 1)[:, 0]
        frac = m0 / torch.clamp(m0 - m1, min=1e-12)
        t0 = ts[first]
        t1 = ts[first + 1]
        depth = t0 + frac * (t1 - t0)
        # the posterior variance at the interpolated crossing point
        x_cross = o + depth[:, None] * d
        _, var_x = posterior(gpis, x_cross)
        # support gate: far from every contact the zero-mean prior hovers
        # at ~0 and the detector fires on noise; a crossing counts only
        # where the variance is below support_var_frac · signal_var
        has = has & (var_x < support_var_frac * gpis.signal_var)
        # depth variance by the delta method, σ_z² = var_f / (∂f/∂t)², in
        # meters for the fusion
        slope = torch.clamp((m0 - m1) / torch.clamp(t1 - t0, min=1e-9),
                            min=1e-3)
        var_z = var_x / (slope * slope)
        depths.append(torch.where(has, depth, nan))
        variances.append(torch.where(has, var_z, nan))
    return torch.cat(depths), torch.cat(variances)


def render_depth_var(
    gpis: GPIS,
    camera: Camera,
    near: float = 0.05,
    far: float = 2.0,
    n_samples: int = 128,
    pixel_chunk: int = 4096,
    support_var_frac: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel expected surface z-depth and variance on the GP's device
    (NaN where the ray finds no surface or the GP has no support there).
    A chunk holds ``pixel_chunk · n_samples · N`` kernel values, 0.6 GB at
    1024 · 96 · 1536 points, and a few temporaries of that size."""
    dev = gpis.X.device
    h, w = camera.height, camera.width
    vs, us = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    fx, fy, cx, cy = (getattr(camera, k).to(dev) for k in
                      ("fx", "fy", "cx", "cy"))
    c2w = camera.c2w.to(dev)
    # OpenCV-convention ray directions with z = 1, so t is the z-depth
    dir_cam = torch.stack([
        (us + 0.5 - cx) / fx,
        (vs + 0.5 - cy) / fy,
        torch.ones((h, w), dtype=torch.float32, device=dev),
    ], dim=-1).reshape(-1, 3)
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], device=dev))
    R_cv = c2w[:3, :3] @ flip
    dirs = dir_cam @ R_cv.T
    origins = c2w[:3, 3].expand(dirs.shape)
    depth, var = _march(gpis, origins, dirs, near, far, n_samples,
                        pixel_chunk, support_var_frac)
    return depth.reshape(h, w), var.reshape(h, w)
