"""Differentiable SSIM (11x11 Gaussian window, σ=1.5) for the splatfacto RGB
loss (port of ``touchgs_tpu/ops/ssim.py``).

``ssim_cm`` dispatches on the images' device, as the kernel wrappers of
``ops.rasterize_cuda`` do:

- **On CUDA**, ``ssim_cm_fused``: one ``torch.autograd.Function`` whose
  forward and backward are the two kernels of ``csrc/ssim.cu``
  (``ssim_fwd``, ``ssim_bwd``); a CUDA tensor launches them or raises.
- **On the CPU**, ``ssim_cm_band``: the separable blur of the five stacked
  maps x, y, x², y², xy as two matmuls against the (n, n) banded Toeplitz
  matrix of the window, whose zero rows beyond the border give the JAX
  package's zero padding, differentiated by autograd.  Its numbers,
  forward and backward, are those of the port before the kernels: the CPU
  runs that the tests compare across meshes and shards keep their bits.

``ssim_fwd_plain`` and ``ssim_bwd_plain`` are the kernels' plain versions,
which ``ssim_cm_fused`` runs on CPU tensors:

- **Forward**: ``ssim_cm_band``'s map m and its mean over C·H·W, and
  where a gradient is wanted, per pixel, a = ∂m/∂μx − 2μx·∂m/∂σxx −
  μy·∂m/∂σxy, b = ∂m/∂σxx and c = ∂m/∂σxy (μ the blurred means, σ the
  blurred second moments less their products).
- **Backward**: the three maps scaled by dL/dSSIM ÷ N and blurred by the
  same window, which is symmetric and so its own adjoint: dL/dx =
  blur(a) + 2x·blur(b) + y·blur(c).  The gradient into ``img1`` comes from
  the same two passes with the images' roles swapped (the map is symmetric
  in them), only where autograd asks for it.

The kernels compute the same function in float32 with fp32 FMAs; they sum
in another order (a stencil, not a matmul), so their results differ from
the plain versions' in the last bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from touchgs_torch.ops import cuda_build
from touchgs_torch.ops.cuda_build import check_tensor as _check
from touchgs_torch.ops.cuda_build import on_cuda as _on_cuda


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


_KERNEL = _gaussian_kernel()
# the taps as the kernels' launchers read them (host memory)
_TAPS = (ctypes.c_float * _KERNEL.size)(*_KERNEL.tolist())


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


# (n, device) -> the band matrix on that device, uploaded once
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
    bh = _band(H, img.device).to(img.dtype)
    bw = _band(W, img.device).to(img.dtype)
    return torch.matmul(torch.matmul(bh, img), bw.T)


def _ssim_map(img0: torch.Tensor, img1: torch.Tensor, c1: float,
              c2: float) -> tuple:
    """The SSIM map of two (C, H, W) images and the terms of it the
    backward needs: μx, μy, a1, a2, d1, d2 (m = a1·a2 / (d1·d2))."""
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
    a1, a2 = 2 * mu01 + c1, 2 * s01 + c2
    d1, d2 = mu00 + mu11 + c1, s00 + s11 + c2
    return (a1 * a2) / (d1 * d2), (mu0, mu1, a1, a2, d1, d2)


def ssim_cm_band(img0: torch.Tensor, img1: torch.Tensor,
                 c1: float = 0.01**2, c2: float = 0.03**2) -> torch.Tensor:
    """Mean SSIM of two (C, H, W) images by the band-matrix products,
    differentiated by autograd: the CPU path, and on the card the library
    yardstick the kernels replaced."""
    return torch.mean(_ssim_map(img0, img1, c1, c2)[0])


def ssim_fwd_plain(img0: torch.Tensor, img1: torch.Tensor, c1: float,
                   c2: float, partials: bool
                   ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Mean SSIM of two (C, H, W) images and, with ``partials``, the
    (3, C, H, W) maps a, b, c of the backward (module docstring)."""
    ssim_map, (mu0, mu1, a1, a2, d1, d2) = _ssim_map(img0, img1, c1, c2)
    value = torch.mean(ssim_map)
    if not partials:
        return value, None
    d = d1 * d2
    dc = 2 * a1 / d                                  # ∂m/∂σxy
    db = -ssim_map / d2                              # ∂m/∂σxx
    dmu = 2 * mu1 * a2 / d - 2 * mu0 * ssim_map / d1  # ∂m/∂μx, σ held
    da = dmu - 2 * mu0 * db - mu1 * dc
    return value, torch.stack([da, db, dc])


def ssim_bwd_plain(img0: torch.Tensor, img1: torch.Tensor,
                   maps: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """dL/d``img0`` from ``ssim_fwd_plain``'s maps and dL/dSSIM ``grad``."""
    C, H, W = img0.shape
    scaled = maps * (grad / img0.numel())
    blurred = _blur_cm(scaled.reshape(3 * C, H, W))
    ba, bb, bc = blurred[:C], blurred[C:2 * C], blurred[2 * C:]
    return ba + 2 * img0 * bb + img1 * bc


@functools.lru_cache(maxsize=64)
def _scratch_words(H: int, W: int) -> int:
    """The words of the forward kernel's scratch for an H x W image, from
    ``csrc/ssim.cu``, which alone knows its tiling."""
    fn = ctypes.CDLL(str(cuda_build.library("ssim"))).ssim_scratch_words
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(H, W)


def _check_image(t: torch.Tensor, name: str, shape: tuple) -> None:
    """A (C, H, W) float32 image of ``shape``, any strides."""
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or len(shape) != 3 or min(shape) < 1):
        raise ValueError(f"{name}: want a float32 (C, H, W) image of shape "
                         f"{shape}, got {t.dtype} {tuple(t.shape)} strides "
                         f"{t.stride()}")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: {t.numel()} elements, the kernels index "
                         f"under 2**31")


def _check_pair(img0, img1) -> tuple:
    shape = tuple(img0.shape)
    _check_image(img0, "img0", shape)
    _check_image(img1, "img1", shape)
    return shape


def ssim_fwd(img0: torch.Tensor, img1: torch.Tensor, c1: float, c2: float,
             partials: bool) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel (``csrc/ssim.cu``): the mean SSIM (a 0-dim
    tensor) and, with ``partials``, the (3, C, H, W) maps.  CPU tensors
    take ``ssim_fwd_plain``."""
    if not _on_cuda(img0, img1):
        return ssim_fwd_plain(img0, img1, c1, c2, partials)
    C, H, W = _check_pair(img0, img1)
    dev = img0.device
    value = torch.empty((), dtype=torch.float32, device=dev)
    n_scratch = _scratch_words(H, W)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    maps = (torch.empty((3, C, H, W), dtype=torch.float32, device=dev)
            if partials else None)
    cuda_build.launch("ssim_fwd", img0.data_ptr(), img1.data_ptr(), C, H, W,
                      *img0.stride(), *img1.stride(),
                      ctypes.addressof(_TAPS), c1, c2,
                      0 if maps is None else maps.data_ptr(),
                      scratch.data_ptr(), n_scratch, value.data_ptr())
    return value, maps


def ssim_bwd(img0: torch.Tensor, img1: torch.Tensor, maps: torch.Tensor,
             grad: torch.Tensor) -> torch.Tensor:
    """The backward kernel (``csrc/ssim.cu``): dL/d``img0``, laid out as
    ``img0`` is, from ``ssim_fwd``'s maps and dL/dSSIM ``grad`` (read on
    the device).  CPU tensors take ``ssim_bwd_plain``."""
    if not _on_cuda(img0, img1, maps, grad):
        return ssim_bwd_plain(img0, img1, maps, grad)
    C, H, W = _check_pair(img0, img1)
    _check(maps, "maps", torch.float32, (3, C, H, W))
    _check(grad, "grad", torch.float32, ())
    dx = torch.empty_like(img0)
    cuda_build.launch("ssim_bwd", img0.data_ptr(), img1.data_ptr(), C, H, W,
                      *img0.stride(), *img1.stride(),
                      ctypes.addressof(_TAPS), maps.data_ptr(),
                      grad.data_ptr(), dx.data_ptr(), *dx.stride())
    return dx


class _SSIM(torch.autograd.Function):
    """``ssim_fwd`` with ``ssim_bwd`` as its backward; the maps are made
    only when ``partials`` says a gradient into ``img0`` is wanted."""

    @staticmethod
    def forward(ctx, img0, img1, c1, c2, partials):
        value, maps = ssim_fwd(img0, img1, c1, c2, partials)
        ctx.save_for_backward(img0, img1, maps)
        ctx.consts = (c1, c2)
        return value

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        img0, img1, maps = ctx.saved_tensors
        g0 = g1 = None
        if ctx.needs_input_grad[0]:
            g0 = ssim_bwd(img0, img1, maps, grad)
        if ctx.needs_input_grad[1]:
            _, maps1 = ssim_fwd(img1, img0, *ctx.consts, True)
            g1 = ssim_bwd(img1, img0, maps1, grad)
        return g0, g1, None, None, None


def ssim_cm_fused(img0: torch.Tensor, img1: torch.Tensor,
                  c1: float = 0.01**2, c2: float = 0.03**2) -> torch.Tensor:
    """Mean SSIM of two (C, H, W) images through ``_SSIM``: the kernels on
    the card, their plain versions on the CPU."""
    partials = torch.is_grad_enabled() and img0.requires_grad
    return _SSIM.apply(img0, img1, c1, c2, partials)


def ssim_cm(
    img0: torch.Tensor,  # (C, H, W) in [0, 1]
    img1: torch.Tensor,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """Mean SSIM over a channel-major image pair (scalar): the kernels on
    the card, ``ssim_cm_band`` on the CPU."""
    if _on_cuda(img0, img1):
        return ssim_cm_fused(img0, img1, c1, c2)
    return ssim_cm_band(img0, img1, c1, c2)


def ssim(
    img0: torch.Tensor,  # (H, W, C) in [0, 1]
    img1: torch.Tensor,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """Mean SSIM over the image (scalar)."""
    return ssim_cm(img0.permute(2, 0, 1), img1.permute(2, 0, 1), c1, c2)
