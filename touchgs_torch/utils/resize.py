"""``jax.image.resize`` in PyTorch, for the two methods the JAX package uses.

The JAX package resizes images and depth maps with ``jax.image.resize(x,
shape, "bilinear" | "bicubic")`` (``vision/monodepth.py``, the Depth-Anything
position embeddings in ``vision/depth_anything.py``).  That is not
``F.interpolate``: it samples at half-pixel centres, widens the kernel by
the scale when it downsamples (antialiasing), renormalises the weights
where the kernel leaves the image, and uses Keys' cubic with a = -0.5
(``F.interpolate``'s bicubic uses -0.75).  Without ``antialias=True``
``F.interpolate`` misses it by up to 3 on N(0, 1) data (ROADMAP.md C24).

So this is a port of ``scale_and_translate`` itself: one (in, out) weight
matrix per resized axis, computed as JAX computes it (float32, the same
clamps), contracted with the input.  An axis whose size does not change is
left as it is, as in JAX.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5, on |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


KERNELS = {"bilinear": _triangle, "linear": _triangle,
           "bicubic": _keys_cubic, "cubic": _keys_cubic}


def weight_matrix(n_in: int, n_out: int, method: str,
                  device=None) -> torch.Tensor:
    """(n_in, n_out) float32 weights of one axis (``compute_weight_mat``
    with translation 0 and antialiasing on)."""
    kernel = KERNELS[method]
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(float(inv_scale), 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    w = kernel(x / np.float32(kernel_scale))
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for ``method`` "bilinear" or
    "bicubic": every axis whose size differs is resampled, in float32."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} has not {x.ndim} axes")
    if method not in KERNELS:
        raise ValueError(f"unsupported resize method {method!r}")
    x = x.to(torch.float32)
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = weight_matrix(n_in, n_out, method, device=x.device)
        x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)
    return x.contiguous()
