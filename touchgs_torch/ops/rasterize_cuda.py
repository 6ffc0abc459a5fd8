"""Tile rasterizer through hand-written CUDA kernels — forward and analytic
backward (port of ``touchgs_tpu/ops/rasterize_pallas.py``).

Division of labour, as in the JAX package:

- **PyTorch**: projection, binning (``ops.tiles``), attribute packing, and
  the backward of the per-tile gather, PyTorch's scatter-add, so the
  kernels stay free of atomics.
- **K1** ``slot_rows`` (``csrc/slot_lists.cu``): the front-packed per-tile
  lists ``gidx`` and, in the same pass, the dense ``(n_tiles, k_tile, 16)``
  attribute rows ``attrs[gidx]`` the compositing kernels read.
  ``slot_lists`` is the same kernel writing ``gidx`` alone.
- **K2** ``forward_tiles`` (``csrc/composite_fwd.cu``): front-to-back
  compositing of each 32x32 tile with the two-chunks-stale tile-wide exit;
  row 6 of its output records the chunks composited.
- **K3** ``backward_tiles`` (``csrc/composite_bwd.cu``): replays exactly
  those chunks and emits per-(tile, slot) attribute gradients.

Each wrapper dispatches on its tensors' device: on the CPU it runs the
plain PyTorch version in ``ops.rasterize_plain``; on CUDA it launches its
kernel or raises.  ``launches`` counts kernel launches by name.

Attribute layout (16 columns): [mx, my, ca~, cb~, cc~, op, z, r, g, b, 0..]
where ca~ = ½·log2(e)·conic_a, cb~ = log2(e)·conic_b, cc~ = ½·log2(e)·conic_c,
so the kernels evaluate α = op·2^(−σ̃) with one exp2.
"""
from __future__ import annotations

from typing import Optional

import torch

from touchgs_torch.config import RasterizeConfig
from touchgs_torch.ops import cuda_build
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.ops.cuda_build import check_tensor as _check
from touchgs_torch.ops.cuda_build import on_cuda as _on_cuda
from touchgs_torch.ops.projection import ProjectedGaussians
from touchgs_torch.ops.rasterize_ref import RenderOutput
from touchgs_torch.ops.tiles import TileBins, bin_gaussians

_LOG2E = 1.4426950408889634
_DMA_ALIGN = 128  # k_tile stays a multiple of this, as in the JAX package

# kernel launches by wrapper; only a launch of the CUDA kernel counts
launches = {"slot_lists": 0, "slot_rows": 0, "composite_fwd": 0,
            "composite_bwd": 0}


def _launch(name: str, key: str, *args) -> None:
    """Launch ``<name>_launch`` on the current stream; count it as ``key``."""
    cuda_build.call(name, *args, cuda_build.current_stream())
    launches[key] += 1


def _check_geometry(th, tw, k_tile, k_chunk):
    npix = th * tw
    if npix % 32 or npix > 1024:
        raise ValueError(f"tile {th}x{tw}: the kernels want a multiple of 32 "
                         f"pixels, at most 1024")
    if k_tile % k_chunk:
        raise ValueError(f"k_tile={k_tile} is not a multiple of "
                         f"k_chunk={k_chunk}")


def _check_lists(sorted_gauss, tile_starts, counts, n_tiles):
    _check(sorted_gauss, "sorted_gauss", torch.int32, (sorted_gauss.shape[0],))
    _check(tile_starts, "tile_starts", torch.int32, (n_tiles,))
    _check(counts, "counts", torch.int32, (n_tiles,))


def slot_lists(sorted_gauss, tile_starts, counts, n_tiles: int, k_tile: int,
               dead: int) -> torch.Tensor:
    """K1: (n_tiles, k_tile) int32 front-packed per-tile lists; ``counts``
    is each tile's count capped at k_tile."""
    if not _on_cuda(sorted_gauss, tile_starts, counts):
        return plain.slot_lists_plain(sorted_gauss, tile_starts, counts,
                                      n_tiles, k_tile, dead)
    _check_lists(sorted_gauss, tile_starts, counts, n_tiles)
    out = torch.empty((n_tiles, k_tile), dtype=torch.int32,
                      device=sorted_gauss.device)
    _launch("slot_lists", "slot_lists", sorted_gauss.data_ptr(),
            tile_starts.data_ptr(), counts.data_ptr(), None, out.data_ptr(),
            None, n_tiles, k_tile, dead)
    return out


def slot_rows(attrs, sorted_gauss, tile_starts, counts, n_tiles: int,
              k_tile: int, dead: int) -> tuple:
    """K1 with rows: (gidx, rows), ``slot_lists``'s (n_tiles, k_tile) int32
    lists and the (n_tiles, k_tile, 16) f32 rows ``attrs[gidx]``, bit for
    bit, written in one pass.  ``attrs`` is the packed (dead + 512, 16)
    table of ``_pack_attrs``, 16-byte aligned."""
    if not _on_cuda(attrs, sorted_gauss, tile_starts, counts):
        return plain.slot_rows_plain(attrs, sorted_gauss, tile_starts,
                                     counts, n_tiles, k_tile, dead)
    _check_lists(sorted_gauss, tile_starts, counts, n_tiles)
    _check(attrs, "attrs", torch.float32, (dead + plain.DEAD_SPREAD, plain.A))
    if attrs.data_ptr() % 16:
        raise ValueError("attrs: want a 16-byte aligned table, for its "
                         "float4 loads")
    gidx = torch.empty((n_tiles, k_tile), dtype=torch.int32,
                       device=attrs.device)
    rows = torch.empty((n_tiles, k_tile, plain.A), dtype=torch.float32,
                       device=attrs.device)
    _launch("slot_lists", "slot_rows", sorted_gauss.data_ptr(),
            tile_starts.data_ptr(), counts.data_ptr(), attrs.data_ptr(),
            gidx.data_ptr(), rows.data_ptr(), n_tiles, k_tile, dead)
    return gidx, rows


class _SlotRows(torch.autograd.Function):
    """K1 with rows as the differentiable gather ``attrs[gidx]``: the
    forward returns (rows, gidx), ``gidx`` not differentiable; the backward
    is the gather's VJP as PyTorch computes it for ``attrs[gidx]``, a
    scatter-add of the rows' gradients into a zero table, through the same
    call, which skips the public ``index_put_``'s range check of the
    indices (a min and a max read back to the host: two syncs a step)."""

    @staticmethod
    def forward(ctx, attrs, sorted_gauss, tile_starts, counts, n_tiles,
                k_tile, dead):
        gidx, rows = slot_rows(attrs, sorted_gauss, tile_starts, counts,
                               n_tiles, k_tile, dead)
        ctx.mark_non_differentiable(gidx)
        ctx.save_for_backward(gidx)
        ctx.attrs_shape = attrs.shape
        return rows, gidx

    @staticmethod
    def backward(ctx, grad_rows, _):
        gidx, = ctx.saved_tensors
        dattrs = grad_rows.new_zeros(ctx.attrs_shape)
        torch.ops.aten._index_put_impl_(dattrs, (gidx,), grad_rows,
                                        accumulate=True, unsafe=True)
        return dattrs, None, None, None, None, None, None


def forward_tiles(n_chunks, tile_ids, attrs_tiled, th, tw, k_tile, k_chunk,
                  n_tx, cfg: RasterizeConfig,
                  early_exit: bool = True) -> torch.Tensor:
    """K2: (n_tiles, 8, th·tw) stack [R, G, B, D, A, T, chunks_done, 0].
    ``early_exit=False`` composites every chunk of each tile's list."""
    if not _on_cuda(n_chunks, tile_ids, attrs_tiled):
        return plain.forward_tiles_plain(n_chunks, tile_ids, attrs_tiled, th,
                                         tw, k_tile, k_chunk, n_tx, cfg,
                                         early_exit)
    _check_geometry(th, tw, k_tile, k_chunk)
    n_tiles = attrs_tiled.shape[0]
    _check(n_chunks, "n_chunks", torch.int32, (n_tiles,))
    _check(tile_ids, "tile_ids", torch.int32, (n_tiles,))
    _check(attrs_tiled, "attrs_tiled", torch.float32,
           (n_tiles, k_tile, plain.A))
    out = torch.empty((n_tiles, plain.ROWS, th * tw), dtype=torch.float32,
                      device=attrs_tiled.device)
    _launch("composite_fwd", "composite_fwd", n_chunks.data_ptr(),
            tile_ids.data_ptr(), attrs_tiled.data_ptr(), out.data_ptr(),
            n_tiles, th, tw, k_tile, k_chunk, n_tx, cfg.alpha_clip,
            cfg.alpha_threshold, int(early_exit))
    return out


def backward_tiles(chunks_done, tile_ids, attrs_tiled, fwd_stack, grad_stack,
                   th, tw, k_tile, k_chunk, n_tx,
                   cfg: RasterizeConfig) -> torch.Tensor:
    """K3: (n_tiles, k_tile, 16) per-slot attribute gradients."""
    if not _on_cuda(chunks_done, tile_ids, attrs_tiled, fwd_stack,
                    grad_stack):
        return plain.backward_tiles_plain(chunks_done, tile_ids, attrs_tiled,
                                          fwd_stack, grad_stack, th, tw,
                                          k_tile, k_chunk, n_tx, cfg)
    _check_geometry(th, tw, k_tile, k_chunk)
    n_tiles = attrs_tiled.shape[0]
    stack_shape = (n_tiles, plain.ROWS, th * tw)
    _check(chunks_done, "chunks_done", torch.int32, (n_tiles,))
    _check(tile_ids, "tile_ids", torch.int32, (n_tiles,))
    _check(attrs_tiled, "attrs_tiled", torch.float32,
           (n_tiles, k_tile, plain.A))
    _check(fwd_stack, "fwd_stack", torch.float32, stack_shape)
    _check(grad_stack, "grad_stack", torch.float32, stack_shape)
    out = torch.empty_like(attrs_tiled)
    _launch("composite_bwd", "composite_bwd", chunks_done.data_ptr(),
            tile_ids.data_ptr(), attrs_tiled.data_ptr(), fwd_stack.data_ptr(),
            grad_stack.data_ptr(), out.data_ptr(), n_tiles, th, tw, k_tile,
            k_chunk, n_tx, cfg.alpha_clip, cfg.alpha_threshold)
    return out


class _CompositeTiles(torch.autograd.Function):
    """K2 forward with K3 as its backward (the JAX `_composite_pallas`
    custom VJP): the backward replays the chunk count the forward recorded
    in row 6 of its output, with or without the early exit."""

    @staticmethod
    def forward(ctx, attrs_tiled, n_chunks, tile_ids, geom, early_exit=True):
        stack = forward_tiles(n_chunks, tile_ids, attrs_tiled, *geom,
                              early_exit=early_exit)
        ctx.save_for_backward(attrs_tiled, tile_ids, stack)
        ctx.geom = geom
        return stack

    @staticmethod
    def backward(ctx, g):
        attrs_tiled, tile_ids, stack = ctx.saved_tensors
        chunks_done = stack[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
        dattrs = backward_tiles(chunks_done, tile_ids, attrs_tiled, stack,
                                g.contiguous(), *ctx.geom)
        return dattrs, None, None, None, None


def _pack_attrs(proj: ProjectedGaussians, colors, opacities) -> torch.Tensor:
    """(N + 512, 16) packed attributes; rows ≥ N are dead (zero).  The conic
    columns carry the exp→exp2 constants; autograd folds them back into the
    conic gradients."""
    N = proj.means2d.shape[0]
    zeros = proj.means2d.new_zeros((N,))
    cols = [zeros] * plain.A
    cols[plain.MX] = proj.means2d[:, 0]
    cols[plain.MY] = proj.means2d[:, 1]
    cols[plain.CA] = proj.conics[:, 0] * (0.5 * _LOG2E)
    cols[plain.CB] = proj.conics[:, 1] * _LOG2E
    cols[plain.CC] = proj.conics[:, 2] * (0.5 * _LOG2E)
    cols[plain.OP] = opacities
    cols[plain.Z] = proj.depths
    cols[plain.R] = colors[:, 0]
    cols[plain.G] = colors[:, 1]
    cols[plain.B] = colors[:, 2]
    attrs = torch.stack(cols, dim=-1)
    return torch.cat([attrs, attrs.new_zeros((plain.DEAD_SPREAD, plain.A))],
                     dim=0)


def rasterize_cuda(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    width: int,
    height: int,
    cfg: RasterizeConfig = RasterizeConfig(),
    background: Optional[torch.Tensor] = None,
    bins: Optional[TileBins] = None,
    k_tile: Optional[int] = None,
    k_chunk: int = 64,
    early_exit: bool = True,
    tile_shards: int = 0,
) -> RenderOutput:
    """Render through the tile kernels (their plain versions on the CPU).
    ``early_exit=False`` turns off the forward's tile-wide exit."""
    if tile_shards > 1:
        raise NotImplementedError(
            "tile_shards > 1 (sharded compositing) is not ported yet: "
            "ROADMAP.md queue A, item 18 (Multi-GPU)")
    if bins is None:
        bins = bin_gaussians(proj, width, height, cfg)
    if k_tile is None:
        k_tile = cfg.k_tile
    n_tx, n_ty = bins.n_tiles_x, bins.n_tiles_y
    n_tiles = n_tx * n_ty
    th, tw = cfg.tile_h, cfg.tile_w
    N = proj.means2d.shape[0]
    if not (_DMA_ALIGN % k_chunk == 0 or k_chunk % _DMA_ALIGN == 0):
        raise ValueError(f"k_chunk={k_chunk} must divide {_DMA_ALIGN} "
                         f"or be a multiple of it")
    k_tile = min(k_tile, max(k_chunk, N))
    k_tile = -(-k_tile // k_chunk) * k_chunk        # multiple of k_chunk
    k_tile = -(-k_tile // _DMA_ALIGN) * _DMA_ALIGN  # and of 128

    attrs = _pack_attrs(proj, colors, opacities)
    capped = torch.clamp(bins.tile_counts, max=k_tile)
    # (n_tiles, k_tile, 16) rows attrs[gidx]; their backward is a scatter-add
    attrs_tiled, _ = _SlotRows.apply(attrs, bins.sorted_gauss,
                                     bins.tile_starts, capped, n_tiles,
                                     k_tile, N)
    n_chunks = torch.div(capped + k_chunk - 1, k_chunk,
                         rounding_mode="floor").to(torch.int32)
    tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=attrs.device)
    stack = _CompositeTiles.apply(attrs_tiled, n_chunks, tile_ids,
                                  (th, tw, k_tile, k_chunk, n_tx, cfg),
                                  early_exit)

    def assemble(a):
        a = a.reshape(n_ty, n_tx, th, tw)
        a = a.transpose(1, 2).reshape(n_ty * th, n_tx * tw)
        return a[:height, :width]

    # stack rows [R, G, B, D, A, T, chunks_done, 0]
    rgb = torch.stack([assemble(stack[:, 0]), assemble(stack[:, 1]),
                       assemble(stack[:, 2])], dim=-1)
    dep = assemble(stack[:, 3])
    acc = assemble(stack[:, 4])
    T = assemble(stack[:, plain.ROW_T])

    if background is not None:
        rgb = rgb + T[..., None] * background
    dep = torch.where(acc > 1e-10, dep / torch.clamp(acc, min=1e-10),
                      torch.zeros_like(dep))
    # truncation telemetry: capped tiles with ≥10% of pixels still
    # unsaturated when the scan ended lost real contributions
    t_final = stack[:, plain.ROW_T].detach()
    unsat_frac = torch.mean((t_final > 1e-3).float(), dim=-1)
    lossy = torch.sum((bins.tile_counts > k_tile) & (unsat_frac > 0.1)
                      ).to(torch.int32)
    return RenderOutput(rgb=rgb, depth=dep, acc=acc, lossy_tiles=lossy)
