"""Tile×Gaussian intersection binning (port of ``touchgs_tpu/ops/tiles.py``).

Static shapes, as in the JAX package:

1. tiles-per-Gaussian are capped at ``max_tiles_per_gaussian``: a fixed k
   range maps k → (tile_x, tile_y) inside each Gaussian's bbox (a centred
   window when the bbox is larger), with a corner cull;
2. one integer key ``(tile_id << depth_bits) | quantized_depth`` per pair,
   sorted, groups tiles together depth-ascending; culled pairs get a sentinel
   key past every tile;
3. two searchsorteds give each tile's [start, count).

The sort is unstable, so ties (same tile and quantized depth) land in an
arbitrary order, as they do in the JAX package; tile extents are exact.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from touchgs_torch.config import RasterizeConfig
from touchgs_torch.ops.projection import ProjectedGaussians


class TileBins(NamedTuple):
    sorted_gauss: torch.Tensor  # (M,) int32 gaussian per intersection, tile-major
    tile_starts: torch.Tensor   # (n_tiles,) int32 offset of each tile's run
    tile_counts: torch.Tensor   # (n_tiles,) int32 run length
    n_tiles_x: int
    n_tiles_y: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bin_gaussians(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    cfg: RasterizeConfig = RasterizeConfig(),
) -> TileBins:
    n_tx = _cdiv(width, cfg.tile_w)
    n_ty = _cdiv(height, cfg.tile_h)
    n_tiles = n_tx * n_ty
    G = proj.means2d.shape[0]
    T_cap = cfg.max_tiles_per_gaussian
    dev = proj.means2d.device
    i32 = torch.int32

    mx = proj.means2d[:, 0].detach()
    my = proj.means2d[:, 1].detach()
    r = proj.radii if proj.cull_radii is None else proj.cull_radii
    r = r.detach()

    def tile_floor(v, size, n):
        return torch.clamp(torch.floor(v / size), 0, n - 1).to(i32)

    x0 = tile_floor(mx - r, cfg.tile_w, n_tx)
    x1 = tile_floor(mx + r, cfg.tile_w, n_tx)
    y0 = tile_floor(my - r, cfg.tile_h, n_ty)
    y1 = tile_floor(my + r, cfg.tile_h, n_ty)
    bw = x1 - x0 + 1
    bh = y1 - y0 + 1
    n_cover = bw * bh  # tiles covered by each gaussian (pre-cap)

    # bbox over the T_cap budget: enumerate a cap-sized window CENTRED on the
    # projected mean, shaped like the bbox (ww·wh ≤ T_cap), so what is dropped
    # is the low-α fringe farthest from the centre
    over = n_cover > T_cap
    ratio = bw.float() / torch.clamp(bh.float(), min=1.0)
    ww = torch.clamp(torch.round(torch.sqrt(T_cap * ratio)).to(i32), 1, T_cap)
    ww = torch.minimum(ww, bw)
    wh = torch.minimum(torch.div(T_cap, ww, rounding_mode="floor"), bh)
    ww = torch.minimum(torch.div(T_cap, wh, rounding_mode="floor"), bw)
    cx_t = tile_floor(mx, cfg.tile_w, n_tx)
    cy_t = tile_floor(my, cfg.tile_h, n_ty)
    wx0 = torch.clamp(cx_t - ww // 2, x0, x1 - ww + 1)
    wy0 = torch.clamp(cy_t - wh // 2, y0, y1 - wh + 1)
    x0 = torch.where(over, wx0, x0)
    y0 = torch.where(over, wy0, y0)
    bw = torch.where(over, ww, bw)
    bh = torch.where(over, wh, bh)
    n_cover = bw * bh

    # quantized depth in the bits left below the tile id
    depth_bits = 31 - max(n_tiles, 1).bit_length()
    if depth_bits < 16:
        raise ValueError(f"too many tiles ({n_tiles}) for int32 sort keys")
    d = proj.depths.detach()
    inf = torch.full_like(d, float("inf"))
    dmin = torch.min(torch.where(proj.valid, d, inf))
    dmax = torch.max(torch.where(proj.valid, d, -inf))
    dscale = ((1 << depth_bits) - 1) / torch.clamp(dmax - dmin, min=1e-9)
    # clamp in INTEGER space: the f32 representation of 2^db − 1 rounds UP
    # for db > 24, and a float clip would let dq bleed into the tile bits.
    # The float→int conversion saturates first (as XLA's does), since an
    # invalid gaussian's depth may lie far outside [dmin, dmax].
    q = torch.clamp((d - dmin) * dscale, -2.0 ** 31, 2.0 ** 31 - 256)
    q = torch.nan_to_num(q, nan=0.0)
    dq = torch.clamp(q.to(i32), 0, (1 << depth_bits) - 1)

    # (G, T_cap) enumeration of covered tiles
    k = torch.arange(T_cap, dtype=i32, device=dev)[None, :]
    tx = x0[:, None] + k % bw[:, None]
    ty = y0[:, None] + torch.div(k, bw[:, None], rounding_mode="floor")
    tile_id = ty * n_tx + tx                                 # (G, T_cap)
    pair_ok = ((k < torch.clamp(n_cover, max=T_cap)[:, None])
               & proj.valid[:, None])

    # corner cull: drop bbox tiles whose rect lies entirely beyond the cull
    # radius; clamping the mean to the tile rect gives the closest point
    tx0 = (tx * cfg.tile_w).float()
    ty0 = (ty * cfg.tile_h).float()
    dx = mx[:, None] - torch.minimum(torch.maximum(mx[:, None], tx0),
                                     tx0 + cfg.tile_w)
    dy = my[:, None] - torch.minimum(torch.maximum(my[:, None], ty0),
                                     ty0 + cfg.tile_h)
    pair_ok &= dx * dx + dy * dy <= (r * r)[:, None]

    key = (tile_id << depth_bits) | dq[:, None]
    sentinel = torch.full((), n_tiles << depth_bits, dtype=i32, device=dev)
    key = torch.where(pair_ok, key, sentinel)

    # the pair's gaussian is its flat index // T_cap, so the sort's
    # permutation gives it without a value gather
    sorted_key, perm = torch.sort(key.reshape(-1), stable=False)
    sorted_gauss = torch.div(perm, T_cap, rounding_mode="floor").to(i32)
    tile_of_pair = (sorted_key >> depth_bits).contiguous()

    tiles = torch.arange(n_tiles, dtype=i32, device=dev)
    starts = torch.searchsorted(tile_of_pair, tiles, right=False).to(i32)
    ends = torch.searchsorted(tile_of_pair, tiles, right=True).to(i32)
    return TileBins(
        sorted_gauss=sorted_gauss,
        tile_starts=starts,
        tile_counts=ends - starts,
        n_tiles_x=n_tx,
        n_tiles_y=n_ty,
    )


def _binning_rows(proj: ProjectedGaussians) -> torch.Tensor:
    """(N, 6) detached: what binning reads of a projection (means, depths,
    radii, cull radii, validity)."""
    r = proj.radii if proj.cull_radii is None else proj.cull_radii
    return torch.stack([proj.means2d[:, 0], proj.means2d[:, 1], proj.depths,
                        proj.radii, r, proj.valid.float()], dim=-1).detach()


def _from_binning_rows(full: torch.Tensor) -> ProjectedGaussians:
    return ProjectedGaussians(means2d=full[:, :2], conics=None,
                              depths=full[:, 2], radii=full[:, 3],
                              valid=full[:, 5] > 0, cull_radii=full[:, 4])


def gather_projection(proj: ProjectedGaussians, mesh) -> ProjectedGaussians:
    """What binning reads of every rank's rows of a row-sharded projection
    (``parallel.mesh.Mesh``), all-gathered in rank order and detached:
    means, depths, radii, cull radii and validity.  Binning is replicated:
    every rank sorts all the Gaussians' keys, as in the JAX package."""
    return _from_binning_rows(mesh.gather_rows(_binning_rows(proj)))


def gather_scene_projections(projs, mesh) -> list:
    """``gather_projection`` of each of S scenes' projections, all of one
    capacity, through one gather (``Mesh.gather_scene_rows``)."""
    full = mesh.gather_scene_rows(torch.stack([_binning_rows(p)
                                               for p in projs]))
    return [_from_binning_rows(f) for f in full]
