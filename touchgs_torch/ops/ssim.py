"""Differentiable SSIM (11x11 Gaussian window, σ=1.5) for the splatfacto RGB
loss (port of ``touchgs_tpu/ops/ssim.py``).

The separable blur is two matmuls against the (n, n) banded Toeplitz matrix
of the window: zero rows beyond the border give the same zero-padding
semantics as the JAX package's block-banded form.  The matmuls run in full
float32 (``torch.backends.cuda.matmul.allow_tf32`` must stay False, its
default).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


_KERNEL = _gaussian_kernel()


@functools.lru_cache(maxsize=8)
def _band_matrix(n: int, size: int = 11) -> np.ndarray:
    """(n, n) banded blur matrix: row i holds the window centred at i,
    truncated (not renormalized) at the borders — identical to a zero-pad
    shifted-add blur."""
    half = size // 2
    b = np.zeros((n, n), np.float32)
    for tap in range(size):
        off = tap - half
        idx = np.arange(max(0, -off), min(n, n - off))
        b[idx, idx + off] = _KERNEL[tap]
    return b


# (n, device) -> the band matrix on that device, uploaded once: a step that
# runs as a CUDA graph may copy nothing from the host, and a graph keeps
# reading the tensor it captured, so the entries are never dropped
_BANDS: dict = {}


def _band(n: int, device: torch.device) -> torch.Tensor:
    key = (n, device)
    b = _BANDS.get(key)
    if b is None:
        b = _BANDS[key] = torch.as_tensor(_band_matrix(n), device=device)
    return b


def _blur_cm(img: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur over (C, H, W) with zero padding."""
    _, H, W = img.shape
    bh, bw = _band(H, img.device), _band(W, img.device)
    return torch.matmul(torch.matmul(bh, img), bw.T)


def ssim_cm(
    img0: torch.Tensor,  # (C, H, W) in [0, 1]
    img1: torch.Tensor,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """Mean SSIM over a channel-major image pair (scalar)."""
    c = img0.shape[0]
    # one batched blur over 5·C channels instead of five C-channel blurs
    stacked = torch.cat(
        [img0, img1, img0 * img0, img1 * img1, img0 * img1], dim=0)
    blurred = _blur_cm(stacked)
    mu0 = blurred[0:c]
    mu1 = blurred[c:2 * c]
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = blurred[2 * c:3 * c] - mu00
    s11 = blurred[3 * c:4 * c] - mu11
    s01 = blurred[4 * c:5 * c] - mu01
    ssim_map = ((2 * mu01 + c1) * (2 * s01 + c2)) / (
        (mu00 + mu11 + c1) * (s00 + s11 + c2)
    )
    return torch.mean(ssim_map)


def ssim(
    img0: torch.Tensor,  # (H, W, C) in [0, 1]
    img1: torch.Tensor,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """Mean SSIM over the image (scalar)."""
    return ssim_cm(img0.permute(2, 0, 1), img1.permute(2, 0, 1), c1, c2)
