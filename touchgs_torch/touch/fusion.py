"""Vision-touch depth fusion (port of ``touchgs_tpu/touch/fusion.py``).

- ``create_sparse_depth_map``  — random 1% sparsification
- ``compute_scale_and_offset`` — box-constrained least squares (closed form
  with KKT clipping)
- ``align_vision_depth``       — two-stage alignment: scale+offset to the
  sparse grounded depth, then offset only (scale pinned to 1) to the touch
  depth, applied at touch-valid pixels
- ``fuse_depth_maps_with_uncertainty`` — product of Gaussians on σ, with
  the reference's inf→0 / nan→0 guards in their order and its use of σ
  (not σ²) in the weights
- ``fuse_depth_maps``          — naive overwrite baseline
- ``fuse_view``                — one view's whole pipeline

Torch ops on the inputs' device.  Where the JAX package draws the 1% mask
from a ``jax.random`` key, the port takes a ``torch.Generator`` on that
device, or an injected permutation ``perm`` (ROADMAP.md C13).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from touchgs_torch.touch import uncertainty as cu


def create_sparse_depth_map(
    generator: Optional[torch.Generator],
    dense_depth_map: torch.Tensor,
    keep_percentage: float = 0.01,
    perm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Keep an exact fraction of random pixels, zero the rest.  The pixels
    are the first ``int(total · keep_percentage)`` of ``perm`` (a
    LongTensor of all ``total`` flat indices), else of a permutation drawn
    from ``generator``."""
    total = dense_depth_map.numel()
    k = int(total * keep_percentage)
    dev = dense_depth_map.device
    if perm is None:
        perm = torch.randperm(total, generator=generator, device=dev)
    elif perm.shape != (total,):
        raise ValueError(f"perm has shape {tuple(perm.shape)}, want "
                         f"({total},)")
    mask_flat = torch.zeros(total, dtype=torch.bool, device=dev)
    mask_flat[perm[:k].to(dev)] = True
    return torch.where(mask_flat.reshape(dense_depth_map.shape),
                       dense_depth_map, 0.0)


def compute_scale_and_offset(
    sparse_depth: torch.Tensor,
    dense_depth: torch.Tensor,
    scale_bounds: tuple[Optional[float], Optional[float]] = (0.0, None),
    offset_bounds: tuple[Optional[float], Optional[float]] = (None, None),
) -> tuple[torch.Tensor, torch.Tensor]:
    """argmin_{s,b} Σ_mask (s·dense + b − sparse)², box-constrained, on
    mask = sparse > 0.  Returns 0-dim tensors (scale, offset)."""
    mask = sparse_depth > 0
    count = torch.sum(mask)
    wsum = torch.clamp(count, min=1)
    x = torch.where(mask, dense_depth, 0.0)
    y = torch.where(mask, sparse_depth, 0.0)
    sx = torch.sum(x) / wsum
    sy = torch.sum(y) / wsum
    sxx = torch.sum(x * x) / wsum
    sxy = torch.sum(x * y) / wsum
    var = sxx - sx * sx
    cov = sxy - sx * sy
    scale_free = torch.where(var > 1e-12, cov / torch.clamp(var, min=1e-12),
                             1.0)

    def clip_bounds(v, bounds):
        lo, hi = bounds
        if lo is not None:
            v = torch.clamp(v, min=lo)
        if hi is not None:
            v = torch.clamp(v, max=hi)
        return v

    # scale, clipped; the offset given it, clipped; then the scale again
    # given the offset (one sweep is exact for a 2-variable box QP with at
    # most one active constraint, which covers the callers)
    scale = clip_bounds(scale_free, scale_bounds)
    offset = clip_bounds(sy - scale * sx, offset_bounds)
    scale2 = torch.where(sxx > 1e-12,
                         (sxy - offset * sx) / torch.clamp(sxx, min=1e-12),
                         scale)
    scale = clip_bounds(scale2, scale_bounds)
    # no mask: the identity transform
    any_mask = count > 0
    scale = torch.where(any_mask, scale, 1.0)
    offset = torch.where(any_mask, offset, 0.0)
    return scale, offset


class AlignResult(NamedTuple):
    ds_gs_visual_depth: torch.Tensor   # stage 1 (DS-GS) aligned vision
    vision_depth: torch.Tensor         # stage 2 (Touch-GS) aligned vision
    vision_uncertainty: torch.Tensor   # σ_vis


def align_vision_depth(
    grounded_depth: torch.Tensor,
    touch_depth: torch.Tensor,
    vision_depth: torch.Tensor,
    is_real_world: bool = True,
) -> AlignResult:
    """Two-stage alignment."""
    # stage 1: DS-GS, scale ≥ 0 and offset of vision to the sparse grounded
    # depth
    scale, offset = compute_scale_and_offset(
        grounded_depth, vision_depth, (0.0, None), (None, None))
    vision = scale * vision_depth + offset
    ds_gs = vision

    # stage 2: Touch-GS, reject vision-touch differences > 3 m, then fit the
    # offset with the scale pinned to 1; applied at touch-valid pixels only
    diff = vision - touch_depth
    diff = torch.where(diff > 3.0, 0.0, diff)
    touch_to_align = (torch.where(diff > 0, touch_depth, 0.0)
                      if is_real_world else touch_depth)
    mask = touch_to_align > 0
    _, offset2 = compute_scale_and_offset(
        touch_to_align, vision, (1.0, 1.0), (None, None))
    vision = torch.where(mask, vision + offset2, vision)
    vision = torch.clamp(vision, min=0.0)

    # vision uncertainty at the main path's weights
    vision_unc = cu.compute_uncertainty_map_with_edges(
        vision, grounded_depth,
        edge_weight=0.0, distance_uncertainty_weight=0.05,
        proximity_weight=0.0, depth_difference_weight=0.0, dilation_size=5,
    )
    vision_unc = torch.clamp(vision_unc, 0.0, 10.0) + 5.0
    return AlignResult(ds_gs, vision, vision_unc)


def fuse_depth_maps_with_uncertainty(
    touch_depth: torch.Tensor,
    vision_depth: torch.Tensor,
    touch_uncertainty: torch.Tensor,
    vision_uncertainty: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Product-of-Gaussians fusion on σ, the reference's to the letter: it
    combines σ values directly (not σ²)."""
    mask = touch_uncertainty > 0

    inv_v = 1.0 / vision_uncertainty
    inv_t = 1.0 / touch_uncertainty
    inv_t = torch.where(torch.isinf(inv_t), 0.0, inv_t)
    inv_v = torch.where(torch.isinf(inv_v), 0.0, inv_v)

    fused_unc = 1.0 / (inv_t + inv_v)
    fused_unc = torch.where(torch.isinf(fused_unc), 0.0, fused_unc)
    sigma = fused_unc

    mu_t = touch_depth * mask
    mu_v = vision_depth

    mu_t_w = mu_t / touch_uncertainty
    mu_t_w = torch.where(torch.isnan(mu_t_w), 0.0, mu_t_w)
    # 0/0 → nan → 0 as in the reference; the mask makes mu_t 0 wherever
    # touch_uncertainty is 0, so no finite/0 reaches here
    mu_t_w = torch.where(torch.isinf(mu_t_w), 0.0, mu_t_w)

    mu_v_w = mu_v / vision_uncertainty
    mu_v_w = torch.where(torch.isnan(mu_v_w), 0.0, mu_v_w)

    fused_depth = sigma * (mu_t_w + mu_v_w)
    return fused_depth, fused_unc


def fuse_depth_maps(sparse_depth: torch.Tensor,
                    dense_depth: torch.Tensor) -> torch.Tensor:
    """Naive fusion baseline: overwrite dense with valid sparse."""
    return torch.where(sparse_depth > 0, sparse_depth, dense_depth)


class FusedView(NamedTuple):
    vision_depth: torch.Tensor       # Touch-GS-aligned vision
    ds_gs_depth: torch.Tensor        # DS-GS baseline
    fused_depth: torch.Tensor
    fused_uncertainty: torch.Tensor


def fuse_view(
    generator: Optional[torch.Generator],
    grounded_depth: torch.Tensor,
    touch_depth: torch.Tensor,
    vision_depth: torch.Tensor,
    touch_uncertainty: torch.Tensor,
    use_uncertainty: bool = True,
    is_real_world: bool = True,
    sparsify_percentage: float = 0.01,
    perm: Optional[torch.Tensor] = None,
) -> FusedView:
    """One view's whole fusion pipeline.  All maps in meters at the vision
    resolution, on one device; the grounded map's 1% mask comes from
    ``perm`` or ``generator`` (``create_sparse_depth_map``)."""
    grounded = create_sparse_depth_map(generator, grounded_depth,
                                       sparsify_percentage, perm=perm)
    aligned = align_vision_depth(grounded, touch_depth, vision_depth,
                                 is_real_world)
    if use_uncertainty:
        fused_depth, fused_unc = fuse_depth_maps_with_uncertainty(
            touch_depth, aligned.vision_depth, touch_uncertainty,
            aligned.vision_uncertainty)
        fused_depth = torch.clamp(fused_depth, min=0.0)
        fused_unc = torch.clamp(fused_unc, 0.0, 10.0)
    else:
        fused_depth = fuse_depth_maps(touch_depth, aligned.vision_depth)
        fused_depth = torch.clamp(fused_depth, min=0.0)
        fused_unc = torch.zeros_like(fused_depth)
    return FusedView(
        vision_depth=aligned.vision_depth,
        ds_gs_depth=aligned.ds_gs_visual_depth,
        fused_depth=fused_depth,
        fused_uncertainty=fused_unc,
    )
