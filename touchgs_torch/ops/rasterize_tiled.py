"""Tile rasterizer in plain PyTorch: the scan path (port of
``touchgs_tpu/ops/rasterize_tiled.py``).

The default render path (``RasterizeConfig.use_pallas=False``).  Per tile:
the front-most ``k_tile`` entries of its depth-sorted list in `TileBins`,
composited front to back over the tile's pixels in chunks of ``k_chunk``
with the log-transmittance carried, and no early exit.  Tiles go in blocks
of ``tile_block``; tiles are independent, so the block size changes no
result.  The chunk body is recomputed in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` in the JAX package):
saving its (B, P, k) intermediates for every chunk would take tens of GB at
the 800x800 flagship.

The path has no kernel of its own, on any device: its JAX original is jnp
with no Pallas kernel.  It reports no truncation telemetry
(``lossy_tiles`` is None).

``tile_shards > 0`` (the JAX package's SPMD mode) makes the blocks the
grid's ``tile_shards`` contiguous slices, padded to equal size; with a
``mesh`` (``parallel.mesh.Mesh``) the inputs are this rank's rows of a
row-sharded capacity, the attribute table and the binning inputs are
all-gathered, and each rank composites its own slice, all-gathered into
the image every rank returns whole (as ``rasterize_cuda``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from touchgs_torch.config import RasterizeConfig
from touchgs_torch.ops.projection import ProjectedGaussians
from touchgs_torch.ops.rasterize_ref import RenderOutput
from touchgs_torch.ops.tiles import TileBins, bin_gaussians, gather_projection

# columns of the gathered attribute table
_MX, _MY, _CA, _CB, _CC, _R, _G, _B, _OP, _Z = range(10)


def _chunk(rgb, dep, acc, logT, rows, dead, pix_x, pix_y,
           cfg: RasterizeConfig):
    """Composite one chunk of ``rows`` (B, k, 10) over (B, P) pixels onto
    the carry (rgb (B, P, 3), dep, acc, logT (B, P)), in the JAX package's
    order of operations."""
    dx = pix_x[:, :, None] - rows[:, None, :, _MX]      # (B, P, k)
    dy = pix_y[:, :, None] - rows[:, None, :, _MY]
    sigma = 0.5 * (rows[:, None, :, _CA] * dx * dx
                   + rows[:, None, :, _CC] * dy * dy) \
        + rows[:, None, :, _CB] * dx * dy
    alpha = torch.clamp(rows[:, None, :, _OP] * torch.exp(-sigma),
                        max=cfg.alpha_clip)
    keep = (sigma >= 0) & (alpha >= cfg.alpha_threshold) & ~dead[:, None, :]
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    log1m = torch.log1p(-alpha)
    clogT = torch.cumsum(log1m, dim=2) - log1m  # exclusive within the chunk
    w = torch.exp(logT[:, :, None] + clogT) * alpha
    rgb = rgb + torch.einsum("bpk,bkc->bpc", w, rows[:, :, _R:_B + 1])
    dep = dep + torch.sum(w * rows[:, None, :, _Z], dim=2)
    acc = acc + torch.sum(w, dim=2)
    logT = logT + torch.sum(log1m, dim=2)
    return rgb, dep, acc, logT


def rasterize_tiled(
    proj: ProjectedGaussians,
    colors: torch.Tensor,      # (N, 3)
    opacities: torch.Tensor,   # (N,)
    width: int,
    height: int,
    cfg: RasterizeConfig = RasterizeConfig(),
    background: Optional[torch.Tensor] = None,
    bins: Optional[TileBins] = None,
    k_tile: int = 1024,        # max gaussians composited per tile (front-most)
    k_chunk: int = 64,         # gaussians per scan step
    tile_block: int = 64,      # tiles per block
    tile_shards: int = 0,      # >0: the grid in this many slices
    mesh=None,                 # this rank composites its slice (see above)
) -> RenderOutput:
    if mesh is not None and tile_shards not in (0, mesh.size):
        raise ValueError(f"tile_shards={tile_shards} with a mesh of "
                         f"{mesh.size} ranks: want 0 or {mesh.size}")
    if bins is None:
        bins = bin_gaussians(proj if mesh is None
                             else gather_projection(proj, mesh),
                             width, height, cfg)
    n_tx, n_ty = bins.n_tiles_x, bins.n_tiles_y
    n_tiles = n_tx * n_ty
    th, tw = cfg.tile_h, cfg.tile_w
    M = bins.sorted_gauss.shape[0]
    dev = proj.means2d.device

    # one table of the attributes with a dead zero row at index N, which
    # masked entries gather harmlessly; its gradient row is dropped
    table = torch.cat([proj.means2d, proj.conics, colors, opacities[:, None],
                       proj.depths[:, None]], dim=1)
    if mesh is not None:
        table = mesh.gather_rows(table)
        tile_shards = mesh.size
    N = table.shape[0]
    table = torch.cat([table, table.new_zeros((1, table.shape[1]))], dim=0)
    # don't scan more entries than gaussians exist, nor pad past the tile count
    k_tile = min(k_tile, N)
    if tile_shards > 0:
        tile_block = -(-n_tiles // tile_shards)
        pad_tiles = tile_shards * tile_block - n_tiles
    else:
        tile_block = min(tile_block, n_tiles)
        pad_tiles = (-n_tiles) % tile_block

    # per-tile capped index lists: (n_tiles, k_tile) into sorted_gauss
    ks = torch.arange(k_tile, device=dev)
    ptr = torch.clamp(bins.tile_starts.long()[:, None] + ks[None, :], 0, M - 1)
    in_list = ks[None, :] < torch.clamp(bins.tile_counts, max=k_tile)[:, None]
    gidx = torch.where(in_list, bins.sorted_gauss.long()[ptr],
                       torch.full_like(ptr, N))

    # per-tile pixel centres (n_tiles, P)
    tile_ids = torch.arange(n_tiles, device=dev)
    py, px = torch.meshgrid(torch.arange(th, device=dev),
                            torch.arange(tw, device=dev), indexing="ij")
    pix_x = ((tile_ids % n_tx)[:, None] * tw + px.reshape(1, -1)) + 0.5
    pix_y = ((tile_ids // n_tx)[:, None] * th + py.reshape(1, -1)) + 0.5

    # pad the tiles to a multiple of tile_block, the lists to one of k_chunk
    n_steps = -(-k_tile // k_chunk)
    pad_k = n_steps * k_chunk - k_tile
    gidx = torch.nn.functional.pad(gidx, (0, pad_k, 0, pad_tiles), value=N)
    pix_x = torch.nn.functional.pad(pix_x.float(), (0, 0, 0, pad_tiles))
    pix_y = torch.nn.functional.pad(pix_y.float(), (0, 0, 0, pad_tiles))

    # the backward recomputes each chunk from its carry, as jax.checkpoint
    recompute = torch.is_grad_enabled() and table.requires_grad
    parts = []
    blocks = range(0, n_tiles + pad_tiles, tile_block)
    for b in (blocks if mesh is None else [blocks[mesh.rank]]):
        gi, pxb, pyb = (a[b:b + tile_block] for a in (gidx, pix_x, pix_y))
        B, P = pxb.shape
        carry = (pxb.new_zeros((B, P, 3)), pxb.new_zeros((B, P)),
                 pxb.new_zeros((B, P)), pxb.new_zeros((B, P)))
        for s in range(n_steps):
            gi_c = gi[:, s * k_chunk:(s + 1) * k_chunk]
            args = (*carry, table[gi_c], gi_c >= N, pxb, pyb, cfg)
            carry = (checkpoint(_chunk, *args, use_reentrant=False)
                     if recompute else _chunk(*args))
        parts.append(carry)
    rgb, dep, acc, logT = (torch.cat(p, dim=0) for p in zip(*parts))
    if mesh is not None:
        full = mesh.gather_tiles(torch.cat(
            [rgb, dep[..., None], acc[..., None], logT[..., None]], dim=-1))
        rgb, dep, acc, logT = full[..., :3], full[..., 3], full[..., 4], \
            full[..., 5]

    def assemble(a):
        a = a[:n_tiles].reshape((n_ty, n_tx, th, tw) + a.shape[2:])
        a = a.transpose(1, 2).reshape((n_ty * th, n_tx * tw) + a.shape[4:])
        return a[:height, :width]

    rgb, dep, acc, T = (assemble(a) for a in (rgb, dep, acc, torch.exp(logT)))
    if background is not None:
        rgb = rgb + T[..., None] * background
    dep = torch.where(acc > 1e-10, dep / torch.clamp(acc, min=1e-10),
                      torch.zeros_like(dep))
    return RenderOutput(rgb=rgb, depth=dep, acc=acc)
