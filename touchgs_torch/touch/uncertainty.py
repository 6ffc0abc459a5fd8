"""Vision-depth uncertainty synthesis (port of
``touchgs_tpu/touch/uncertainty.py``).

The uncertainty map is a weighted sum of four terms:

- distance:   depth × distance_uncertainty_weight
- proximity:  normalized EDT of the sparse-sample mask, box-blurred 250×250
              then median-blurred 5×5
- edge:       dilated mask of the top-3% Sobel-gradient magnitudes
- difference: |dense − sparse| at sparse-valid pixels

The fusion's main path uses weights (edge 0, dist 0.05, prox 0, diff 0).
Torch ops on the input's device, in the JAX package's order of operations.
Borders follow numpy's ``np.pad`` (``_pad``), which ``jnp.pad`` follows and
``F.pad`` does not: numpy's reflect repeats its reflection when the pad
reaches the image's size, as the 250-pixel box blur's does.
"""
from __future__ import annotations

import numpy as np
import torch


def _pad(img: torch.Tensor, pad, mode: str) -> torch.Tensor:
    """``np.pad(img, pad, mode)`` for a 2-D tensor and the modes
    "symmetric", "reflect" and "edge": numpy builds each axis's index
    vector (``np.pad`` of ``arange``), and the tensor is gathered with it,
    so every pad width keeps numpy's semantics."""
    (r0, r1), (c0, c1) = ((pad, pad), (pad, pad)) if isinstance(pad, int) \
        else pad
    h, w = img.shape
    rows = torch.as_tensor(np.pad(np.arange(h), (r0, r1), mode=mode),
                           device=img.device)
    cols = torch.as_tensor(np.pad(np.arange(w), (c0, c1), mode=mode),
                           device=img.device)
    return img.index_select(0, rows).index_select(1, cols)


def _sobel(img: torch.Tensor, axis: int) -> torch.Tensor:
    """scipy.ndimage.sobel: derivative [-1, 0, 1] along ``axis``, smoothing
    [1, 2, 1] along the other; scipy's 'reflect' border is numpy's
    'symmetric'."""
    deriv = (-1.0, 0.0, 1.0)
    smooth = (1.0, 2.0, 1.0)
    ka = deriv if axis == 0 else smooth
    kb = smooth if axis == 0 else deriv
    x = _pad(img, 1, "symmetric")
    x = ka[0] * x[:-2, :] + ka[1] * x[1:-1, :] + ka[2] * x[2:, :]
    x = kb[0] * x[:, :-2] + kb[1] * x[:, 1:-1] + kb[2] * x[:, 2:]
    return x


def _box_blur(img: torch.Tensor, size: int) -> torch.Tensor:
    """cv2.blur: size×size mean filter with BORDER_REFLECT_101 (numpy's
    'reflect'), from a summed-area table (two cumsums)."""
    h, w = img.shape
    r0 = size // 2
    r1 = size - 1 - r0
    padded = _pad(img, ((r0, r1), (r0, r1)), "reflect")
    ii = torch.nn.functional.pad(
        torch.cumsum(torch.cumsum(padded, dim=0), dim=1), (1, 0, 1, 0))
    s = (ii[size:, size:] - ii[:-size, size:] - ii[size:, :-size]
         + ii[:-size, :-size])
    return s[:h, :w] / (size * size)


def _median_blur_5(img: torch.Tensor) -> torch.Tensor:
    """cv2.medianBlur(ksize=5) with BORDER_REPLICATE (numpy's 'edge'); 25
    values a pixel, so the median is the middle one."""
    p = _pad(img, 2, "edge")
    h, w = img.shape
    patches = torch.stack(
        [p[i:i + h, j:j + w] for i in range(5) for j in range(5)], dim=-1)
    return torch.median(patches, dim=-1).values


def _dilate(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """binary_dilation with the 4-connected structure, ``iterations``
    times."""
    m = mask.to(torch.float32)
    for _ in range(iterations):
        p = torch.nn.functional.pad(m, (1, 1, 1, 1))
        m = torch.maximum(
            torch.maximum(p[1:-1, 1:-1], p[:-2, 1:-1]),
            torch.maximum(p[2:, 1:-1],
                          torch.maximum(p[1:-1, :-2], p[1:-1, 2:])))
    return m > 0


def squared_edt(mask_empty: torch.Tensor) -> torch.Tensor:
    """Exact squared Euclidean distance transform: for each True pixel the
    squared distance to the nearest False one (scipy's
    ``distance_transform_edt(mask) ** 2``).  Two dense passes, each a min
    over one axis; pass 1 holds an (h, w, w) tensor (256 MB at 400²)."""
    h, w = mask_empty.shape
    dev = mask_empty.device
    big = 1e12
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    dcol2 = (cols[:, None] - cols[None, :]) ** 2
    col_cost = torch.where(~mask_empty, 0.0, big)
    g = torch.min(col_cost[:, None, :] + dcol2[None, :, :], dim=2).values
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    drow2 = (rows[:, None] - rows[None, :]) ** 2
    d2 = torch.min(g[None, :, :] + drow2[:, :, None], dim=1).values
    return torch.clamp(d2, max=big)


def compute_uncertainty_map_with_edges(
    dense_depth: torch.Tensor,
    sparse_depth: torch.Tensor,
    edge_weight: float = 1.0,
    distance_uncertainty_weight: float = 0.1,
    proximity_weight: float = 0.5,
    dilation_size: int = 1,
    depth_difference_weight: float = 1.0,
) -> torch.Tensor:
    """See the module docstring; the JAX function's signature."""
    distance_uncertainty = dense_depth * distance_uncertainty_weight

    sparse_mask = sparse_depth > 0

    if proximity_weight != 0.0:
        edt = torch.sqrt(squared_edt(~sparse_mask))
        proximity = edt / torch.clamp(torch.max(edt), min=1e-12)
        proximity = proximity * proximity_weight
        proximity = _box_blur(proximity, 250)
        proximity = _median_blur_5(proximity)
    else:
        proximity = torch.zeros_like(dense_depth)

    if edge_weight != 0.0:
        ex = _sobel(dense_depth, axis=0)
        ey = _sobel(dense_depth, axis=1)
        mag = 20.0 * torch.sqrt(ex ** 2 + ey ** 2)
        # jnp.percentile's default is linear interpolation, as quantile's
        thresh = torch.quantile(mag.reshape(-1), 0.97)
        edge_mask = mag > thresh
        edge_uncertainty = (_dilate(edge_mask, dilation_size)
                            .to(torch.float32) * edge_weight)
    else:
        edge_uncertainty = torch.zeros_like(dense_depth)

    diff = torch.abs(dense_depth - sparse_depth)
    diff = torch.where(sparse_mask, diff, 0.0)
    diff = diff * depth_difference_weight

    return distance_uncertainty + proximity + edge_uncertainty + diff
