"""Tile rasterizer through hand-written CUDA kernels — forward and analytic
backward (port of ``touchgs_tpu/ops/rasterize_pallas.py``).

Division of labour, as in the JAX package:

- **PyTorch**: binning (``ops.tiles``) and the backward of the per-tile
  gather, PyTorch's scatter-add, so the kernels stay free of atomics;
  projection, SH and attribute packing too on the CPU and where the
  camera takes a gradient (``_attr_rows``), while ``splatfacto.render``
  hands the card's other renders the table ``ops.shade``'s kernels
  packed (``attrs``).
- **K1** ``slot_rows`` (``csrc/slot_lists.cu``): the front-packed per-tile
  lists ``gidx`` and, in the same pass, the dense ``(n_tiles, k_tile, 16)``
  attribute rows ``attrs[gidx]`` the compositing kernels read.
  ``slot_lists`` is the same kernel writing ``gidx`` alone.
- **K2** ``forward_tiles`` (``csrc/composite_fwd.cu``): front-to-back
  compositing of each tile with the two-chunks-stale tile-wide exit; row 6
  of its output records the chunks composited.  Any tile shape up to
  ``MAX_TILE_PIXELS`` pixels, as the JAX kernels take any: whole-warp tiles
  of at most 1024 pixels (the flagship's 32x32) run the register kernels,
  the others the group kernels.
- **K3** ``backward_tiles`` (``csrc/composite_bwd.cu``): replays exactly
  those chunks and emits per-(tile, slot) attribute gradients.

Each wrapper dispatches on its tensors' device: on the CPU it runs the
plain PyTorch version in ``ops.rasterize_plain``; on CUDA it launches its
kernel through ``cuda_build.launch``, which counts it, or raises.

``rasterize_cuda`` renders one view, its tile grid whole or in slices
(``tile_shards``; with a ``mesh`` each rank composites its own slice, as
the JAX package's ``shard_map`` region does, ``rasterize_pallas.py:629-
686``).  ``rasterize_cuda_scenes`` renders S scenes through one launch of
each kernel, where the JAX package vmaps the kernels over a scene axis
(``parallel/multiscene.py:109-132``); with a mesh each rank composites its
slice of the scenes' packed grid.

Attribute layout (16 columns): [mx, my, ca~, cb~, cc~, op, z, r, g, b, 0..]
where ca~ = ½·log2(e)·conic_a, cb~ = log2(e)·conic_b, cc~ = ½·log2(e)·conic_c,
so the kernels evaluate α = op·2^(−σ̃) with one exp2.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from touchgs_torch.config import RasterizeConfig
from touchgs_torch.ops import cuda_build
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.ops.cuda_build import check_tensor as _check
from touchgs_torch.ops.cuda_build import on_cuda as _on_cuda
from touchgs_torch.ops.projection import ProjectedGaussians
from touchgs_torch.ops.rasterize_ref import RenderOutput
from touchgs_torch.ops.tiles import (TileBins, bin_gaussians,
                                     gather_projection,
                                     gather_scene_projections)
from touchgs_torch.utils import telemetry

_LOG2E = 1.4426950408889634
_DMA_ALIGN = 128  # k_tile stays a multiple of this, as in the JAX package
# the largest tile K2 and K3 take: K3's group kernel keeps a pixel's T and
# S_u in shared memory (ROADMAP C40)
MAX_TILE_PIXELS = 16384

# the one launch counter, ``cuda_build.launches``, under the name the
# benchmark's job log prints
launches = cuda_build.launches


def _check_geometry(th, tw, k_tile, k_chunk):
    """K2's and K3's tile limits: any tile of 1 to MAX_TILE_PIXELS pixels
    (the group kernels keep 8 bytes a pixel in shared memory, ROADMAP C40),
    k_tile a multiple of k_chunk."""
    npix = th * tw
    if th < 1 or tw < 1 or npix > MAX_TILE_PIXELS:
        raise ValueError(f"tile {th}x{tw}: the compositing kernels take 1 to "
                         f"{MAX_TILE_PIXELS} pixels a tile (MAX_TILE_PIXELS)")
    if k_tile % k_chunk:
        raise ValueError(f"k_tile={k_tile} is not a multiple of "
                         f"k_chunk={k_chunk}")


def _check_lists(sorted_gauss, tile_starts, counts, n_tiles):
    _check(sorted_gauss, "sorted_gauss", torch.int32, (sorted_gauss.shape[0],))
    _check(tile_starts, "tile_starts", torch.int32, (n_tiles,))
    _check(counts, "counts", torch.int32, (n_tiles,))


def slot_lists(sorted_gauss, tile_starts, counts, n_tiles: int, k_tile: int,
               dead: int, tile0: int = 0) -> torch.Tensor:
    """K1: (n_tiles, k_tile) int32 front-packed per-tile lists; ``counts``
    is each tile's count capped at k_tile.  ``tile0`` is the grid index of
    the first tile when the lists are a slice of the grid's."""
    if not _on_cuda(sorted_gauss, tile_starts, counts):
        return plain.slot_lists_plain(sorted_gauss, tile_starts, counts,
                                      n_tiles, k_tile, dead, tile0)
    _check_lists(sorted_gauss, tile_starts, counts, n_tiles)
    out = torch.empty((n_tiles, k_tile), dtype=torch.int32,
                      device=sorted_gauss.device)
    cuda_build.launch("slot_lists", sorted_gauss.data_ptr(),
                      tile_starts.data_ptr(), counts.data_ptr(), None,
                      out.data_ptr(), None, n_tiles, k_tile, dead, tile0)
    return out


def slot_rows(attrs, sorted_gauss, tile_starts, counts, n_tiles: int,
              k_tile: int, dead: int, tile0: int = 0) -> tuple:
    """K1 with rows: (gidx, rows), ``slot_lists``'s (n_tiles, k_tile) int32
    lists and the (n_tiles, k_tile, 16) f32 rows ``attrs[gidx]``, bit for
    bit, written in one pass.  ``attrs`` is the packed (dead + 512, 16)
    table of ``_pack_attrs``, 16-byte aligned."""
    if not _on_cuda(attrs, sorted_gauss, tile_starts, counts):
        return plain.slot_rows_plain(attrs, sorted_gauss, tile_starts,
                                     counts, n_tiles, k_tile, dead, tile0)
    _check_lists(sorted_gauss, tile_starts, counts, n_tiles)
    _check(attrs, "attrs", torch.float32, (dead + plain.DEAD_SPREAD, plain.A))
    if attrs.data_ptr() % 16:
        raise ValueError("attrs: want a 16-byte aligned table, for its "
                         "float4 loads")
    gidx = torch.empty((n_tiles, k_tile), dtype=torch.int32,
                       device=attrs.device)
    rows = torch.empty((n_tiles, k_tile, plain.A), dtype=torch.float32,
                       device=attrs.device)
    cuda_build.launch("slot_lists", sorted_gauss.data_ptr(),
                      tile_starts.data_ptr(), counts.data_ptr(),
                      attrs.data_ptr(), gidx.data_ptr(), rows.data_ptr(),
                      n_tiles, k_tile, dead, tile0, key="slot_rows")
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
                k_tile, dead, tile0=0):
        gidx, rows = slot_rows(attrs, sorted_gauss, tile_starts, counts,
                               n_tiles, k_tile, dead, tile0)
        ctx.mark_non_differentiable(gidx)
        ctx.save_for_backward(gidx)
        ctx.attrs_shape = attrs.shape
        return rows, gidx

    @staticmethod
    def backward(ctx, grad_rows, _):
        gidx, = ctx.saved_tensors
        return (scatter_rows(grad_rows, gidx, ctx.attrs_shape), None, None,
                None, None, None, None, None)


def scatter_rows(grad_rows, gidx, attrs_shape) -> torch.Tensor:
    """The gather ``attrs[gidx]``'s VJP: ``grad_rows`` (n_tiles, k_tile, 16)
    scatter-added by ``gidx`` into a zero table of ``attrs_shape``, with
    duplicate indices, through ``index_put_``'s accumulating call without
    its range check of the indices."""
    dattrs = grad_rows.new_zeros(attrs_shape)
    torch.ops.aten._index_put_impl_(dattrs, (gidx,), grad_rows,
                                    accumulate=True, unsafe=True)
    return dattrs


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
    cuda_build.launch("composite_fwd", n_chunks.data_ptr(),
                      tile_ids.data_ptr(), attrs_tiled.data_ptr(),
                      out.data_ptr(), n_tiles, th, tw, k_tile, k_chunk, n_tx,
                      cfg.alpha_clip, cfg.alpha_threshold, int(early_exit))
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
    cuda_build.launch("composite_bwd", chunks_done.data_ptr(),
                      tile_ids.data_ptr(), attrs_tiled.data_ptr(),
                      fwd_stack.data_ptr(), grad_stack.data_ptr(),
                      out.data_ptr(), n_tiles, th, tw, k_tile, k_chunk, n_tx,
                      cfg.alpha_clip, cfg.alpha_threshold)
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


def _attr_rows(proj: ProjectedGaussians, colors, opacities) -> torch.Tensor:
    """(N, 16) packed attributes.  The conic columns carry the exp→exp2
    constants; autograd folds them back into the conic gradients."""
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
    return torch.stack(cols, dim=-1)


def _with_dead_rows(rows: torch.Tensor) -> torch.Tensor:
    """The table ``rows`` followed by the 512 dead (zero) rows."""
    return torch.cat([rows, rows.new_zeros((plain.DEAD_SPREAD, plain.A))],
                     dim=0)


def _pack_attrs(proj: ProjectedGaussians, colors, opacities) -> torch.Tensor:
    """(N + 512, 16) packed attributes; rows ≥ N are dead (zero)."""
    return _with_dead_rows(_attr_rows(proj, colors, opacities))


def _fit_k_tile(k_tile: int, k_chunk: int, N: int) -> int:
    """The per-tile cap: at most max(k_chunk, N), rounded up to a multiple
    of k_chunk and of 128, as in the JAX package."""
    if not (_DMA_ALIGN % k_chunk == 0 or k_chunk % _DMA_ALIGN == 0):
        raise ValueError(f"k_chunk={k_chunk} must divide {_DMA_ALIGN} "
                         f"or be a multiple of it")
    k_tile = min(k_tile, max(k_chunk, N))
    k_tile = -(-k_tile // k_chunk) * k_chunk        # multiple of k_chunk
    return -(-k_tile // _DMA_ALIGN) * _DMA_ALIGN    # and of 128


def _composite(attrs, sorted_gauss, tile_starts, counts, tile_ids, geom,
               early_exit: bool, tile0: int = 0) -> torch.Tensor:
    """K1 with rows, then K2 (with K3 as its backward), over the tiles whose
    ``tile_starts``, uncapped ``counts`` and grid ``tile_ids`` are given;
    ``tile0`` is the grid index of the first.  ``attrs`` is the packed
    table with its dead rows.  Returns the tiles' (n, 8, th·tw) stack."""
    th, tw, k_tile, k_chunk, n_tx, cfg = geom
    n = counts.shape[0]
    capped = torch.clamp(counts, max=k_tile)
    # (n, k_tile, 16) rows attrs[gidx]; their backward is a scatter-add
    attrs_tiled, _ = _SlotRows.apply(attrs, sorted_gauss, tile_starts,
                                     capped, n, k_tile,
                                     attrs.shape[0] - plain.DEAD_SPREAD,
                                     tile0)
    n_chunks = torch.div(capped + k_chunk - 1, k_chunk,
                         rounding_mode="floor").to(torch.int32)
    return _CompositeTiles.apply(attrs_tiled, n_chunks, tile_ids, geom,
                                 early_exit)


def _composite_shards(attrs, sorted_gauss, tile_starts, tile_counts,
                      tile_ids, geom, early_exit: bool, tile_shards: int,
                      mesh) -> torch.Tensor:
    """The (n_tiles, 8, th·tw) stack of a grid: one view's (``tile_ids``
    0, 1, ...) or ``pack_scenes``'s (each scene's ids again).  With more
    than one shard the grid is padded to a multiple of their number and
    cut into contiguous slices, each composited by its own launches of K1
    (with the slice's first tile as ``tile0``), K2 and K3 with the slice's
    grid tile ids.  With a mesh this rank composites its slice and
    all-gathers the others'; without one every slice runs here, in order.
    Padded tiles have no entries and are dropped."""
    n_tiles = tile_counts.shape[0]
    if mesh is not None:
        if tile_shards not in (0, mesh.size):
            raise ValueError(f"tile_shards={tile_shards} with a mesh of "
                             f"{mesh.size} ranks: want 0 or {mesh.size}")
        tile_shards = mesh.size
    elif tile_shards <= 1:
        return _composite(attrs, sorted_gauss, tile_starts, tile_counts,
                          tile_ids, geom, early_exit)
    per = -(-n_tiles // tile_shards)
    pad = per * tile_shards - n_tiles
    starts, counts, tile_ids = (torch.nn.functional.pad(a, (0, pad))
                                for a in (tile_starts, tile_counts,
                                          tile_ids))

    def shard(s):
        sl = slice(s * per, (s + 1) * per)
        return _composite(attrs, sorted_gauss, starts[sl].contiguous(),
                          counts[sl].contiguous(), tile_ids[sl].contiguous(),
                          geom, early_exit, tile0=s * per)

    if mesh is not None:
        stack = mesh.gather_tiles(shard(mesh.rank))
    else:
        stack = torch.cat([shard(s) for s in range(tile_shards)])
    return stack[:n_tiles]


def _finish(stack, tile_counts, k_tile: int, n_tx: int, n_ty: int, th: int,
            tw: int, width: int, height: int, background) -> RenderOutput:
    """The image of a grid's (n_tiles, 8, th·tw) stack, with the
    background, the normalised depth and the truncation telemetry."""
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
    lossy = torch.sum((tile_counts > k_tile) & (unsat_frac > 0.1)
                      ).to(torch.int32)
    return RenderOutput(rgb=rgb, depth=dep, acc=acc, lossy_tiles=lossy)


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
    mesh=None,
    attrs: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Render through the tile kernels (their plain versions on the CPU).
    ``early_exit=False`` turns off the forward's tile-wide exit.

    ``attrs`` is the packed attribute table of ``shade.shade_packed``, read
    in place of packing ``colors``, ``opacities`` and ``proj``'s means,
    conics and depths: followed by its 512 dead rows, or with a ``mesh``
    this rank's rows alone.

    ``tile_shards > 1`` composites the tile grid in that many contiguous
    slices (``_composite_shards``); the image equals the unsharded one.
    ``mesh`` (``parallel.mesh.Mesh``) makes ``proj``, ``colors`` and
    ``opacities`` this rank's rows of a row-sharded capacity: the binning
    inputs and the packed attribute table are all-gathered (the table's
    gradient reduce-scattered back), binning runs on every rank, and each
    rank composites its slice of the grid, all-gathered for the image
    that every rank returns whole."""
    if mesh is not None:
        if bins is None:
            bins = bin_gaussians(gather_projection(proj, mesh), width,
                                 height, cfg)
        telemetry.mark("bin")
    else:
        if bins is None:
            bins = bin_gaussians(proj, width, height, cfg)
        telemetry.mark("bin")
    packed = attrs is not None
    if not packed:
        attrs = _attr_rows(proj, colors, opacities)
    # the nested stage raster_bwd ends where the compositing's gradient
    # has reached the per-Gaussian rows: the loss's backward, K3 and the
    # rows' scatter-add
    telemetry.mark_at_grad(attrs, "raster_bwd")
    if mesh is not None:
        attrs = _with_dead_rows(mesh.gather_rows(attrs))
    elif not packed:
        attrs = _with_dead_rows(attrs)
    N = attrs.shape[0] - plain.DEAD_SPREAD
    k_tile = _fit_k_tile(cfg.k_tile if k_tile is None else k_tile, k_chunk,
                         N)
    telemetry.note_tiles(bins.tile_counts, k_tile)
    n_tx, n_ty = bins.n_tiles_x, bins.n_tiles_y
    geom = (cfg.tile_h, cfg.tile_w, k_tile, k_chunk, n_tx, cfg)
    tile_ids = torch.arange(n_tx * n_ty, dtype=torch.int32,
                            device=attrs.device)
    stack = _composite_shards(attrs, bins.sorted_gauss, bins.tile_starts,
                              bins.tile_counts, tile_ids, geom, early_exit,
                              tile_shards, mesh)
    return _finish(stack, bins.tile_counts, k_tile, n_tx, n_ty, cfg.tile_h,
                   cfg.tile_w, width, height, background)


def pack_scenes(
    projs: Sequence[ProjectedGaussians],
    colors: Sequence[torch.Tensor],
    opacities: Sequence[torch.Tensor],
    width: int,
    height: int,
    cfg: RasterizeConfig = RasterizeConfig(),
    k_tile: Optional[int] = None,
    k_chunk: int = 64,
    mesh=None,
) -> dict:
    """The kernels' inputs for S scenes of one resolution and one capacity
    C as one tile grid: the scenes' grids concatenated, scene s's sorted
    Gaussians offset by s·C into one packed table (``attrs``) of S·C rows
    and the 512 dead rows, its tile starts by the pairs of the scenes
    before it, and each scene's tiles carrying the grid's ``tile_ids``,
    from which K2 and K3 take the pixel origin.  Also each scene's
    ``bins`` and the kernels' ``geom``.

    With a ``mesh`` (``parallel.mesh.Mesh``) each scene's inputs are this
    rank's rows of its capacity: the binning inputs and the attribute rows
    of all S scenes are all-gathered, each in one gather, into scene-major
    order, and every rank bins every scene."""
    S = len(projs)
    rows = torch.stack([_attr_rows(p, c, o)
                        for p, c, o in zip(projs, colors, opacities)])
    if mesh is not None:
        projs = gather_scene_projections(projs, mesh)
        rows = mesh.gather_scene_rows(rows)
    N = rows.shape[1]
    bins = [bin_gaussians(p, width, height, cfg) for p in projs]
    k_tile = _fit_k_tile(cfg.k_tile if k_tile is None else k_tile, k_chunk,
                         N)
    n_tx, n_ty = bins[0].n_tiles_x, bins[0].n_tiles_y
    attrs = _with_dead_rows(rows.reshape(S * N, plain.A))
    offsets = [0]
    for b in bins[:-1]:
        offsets.append(offsets[-1] + b.sorted_gauss.shape[0])
    return dict(
        attrs=attrs, bins=bins,
        sorted_gauss=torch.cat([b.sorted_gauss + s * N
                                for s, b in enumerate(bins)]),
        tile_starts=torch.cat([b.tile_starts + o
                               for b, o in zip(bins, offsets)]),
        tile_counts=torch.cat([b.tile_counts for b in bins]),
        tile_ids=torch.arange(n_tx * n_ty, dtype=torch.int32,
                              device=attrs.device).repeat(S),
        geom=(cfg.tile_h, cfg.tile_w, k_tile, k_chunk, n_tx, cfg))


def rasterize_cuda_scenes(
    projs: Sequence[ProjectedGaussians],
    colors: Sequence[torch.Tensor],
    opacities: Sequence[torch.Tensor],
    width: int,
    height: int,
    cfg: RasterizeConfig = RasterizeConfig(),
    backgrounds: Optional[Sequence[torch.Tensor]] = None,
    k_tile: Optional[int] = None,
    k_chunk: int = 64,
    early_exit: bool = True,
    mesh=None,
) -> list:
    """Render S scenes of one resolution and one capacity through one
    launch each of K1, K2 and K3 on ``pack_scenes``'s grid.  Each scene's
    image, and its gradients, equal those of ``rasterize_cuda`` alone; the
    dead slots' indices differ, their rows (zero) do not.  Returns the S
    ``RenderOutput``s.

    With a ``mesh`` of ``model`` ranks the scenes' inputs are this rank's
    rows (``pack_scenes``), the packed grid is cut into one contiguous
    slice a rank, this rank composites its slice through one launch each
    of K1 (with the slice's offset into the packed grid as ``tile0``), K2
    and K3, and the slices are all-gathered: every rank returns every
    scene's image whole."""
    x = pack_scenes(projs, colors, opacities, width, height, cfg, k_tile,
                    k_chunk, mesh)
    stack = _composite_shards(x["attrs"], x["sorted_gauss"],
                              x["tile_starts"], x["tile_counts"],
                              x["tile_ids"], x["geom"], early_exit, 0, mesh)
    th, tw, k_tile, _, n_tx, _ = x["geom"]
    n_ty = x["bins"][0].n_tiles_y
    n_tiles = n_tx * n_ty
    if backgrounds is None:
        backgrounds = [None] * len(projs)
    return [_finish(stack[s * n_tiles:(s + 1) * n_tiles], b.tile_counts,
                    k_tile, n_tx, n_ty, th, tw, width, height, bg)
            for s, (b, bg) in enumerate(zip(x["bins"], backgrounds))]
