"""Plain PyTorch versions of the three tile kernels (K1 slot lists, K2
forward compositing, K3 backward compositing).

Each computes the same function as its CUDA kernel in
``touchgs_torch/csrc/`` and as the Pallas kernel it replaces in
``touchgs_tpu/ops/rasterize_pallas.py``, including the two-chunks-stale
tile-wide exit gate and the ``chunks_done`` row.  They run every tile at
once and walk the entries one by one, in the kernels' order, so α and the
transmittance round exactly as the kernels round them.  The wrappers in
``rasterize_cuda`` use them for tensors on the CPU; the CUDA main path never
calls them.
"""
from __future__ import annotations

import torch

from touchgs_torch.config import RasterizeConfig

# attribute columns of the packed 16-wide table
MX, MY, CA, CB, CC, OP, Z, R, G, B = range(10)
A = 16
# stacked forward output rows [R, G, B, D, A, T, chunks_done, 0]
ROWS = 8
ROW_T, ROW_DONE = 5, 6
SAT_EPS = 1e-4     # tile-wide saturation threshold
LN2 = 0.6931471805599453
DEAD_SPREAD = 512  # zero rows appended to the attribute table


def slot_lists_plain(sorted_gauss, tile_starts, counts, n_tiles: int,
                     k_tile: int, dead: int) -> torch.Tensor:
    """(n_tiles, k_tile) int32: slot j of tile t is sorted position
    starts[t] + j for j < counts[t], else dead + ((j + 131·t) & 511)."""
    dev = sorted_gauss.device
    t = torch.arange(n_tiles, dtype=torch.int32, device=dev)[:, None]
    j = torch.arange(k_tile, dtype=torch.int32, device=dev)[None, :]
    live = j < counts[:, None]
    pos = torch.where(live, tile_starts[:, None] + j, torch.zeros_like(j))
    vals = sorted_gauss[pos.long()]
    dead_row = dead + ((j + t * 131) & (DEAD_SPREAD - 1))
    return torch.where(live, vals, dead_row).to(torch.int32)


def _pixel_geometry(tile_ids, th, tw, n_tx):
    """(1, npix) pixel-centre rows and (n_tiles, 1) tile origins."""
    q = torch.arange(th * tw, device=tile_ids.device)
    px = ((q % tw).float() + 0.5)[None, :]
    py = ((q // tw).float() + 0.5)[None, :]
    ox = ((tile_ids % n_tx) * tw).float()[:, None]
    oy = ((tile_ids // n_tx) * th).float()[:, None]
    return px, py, ox, oy


def _sigma(a, px, py, ox, oy):
    """σ̃ and dx, dy for attribute rows ``a`` (last axis the 16 columns),
    in the kernels' order of operations."""
    mx = a[..., MX:MX + 1] - ox
    my = a[..., MY:MY + 1] - oy
    dx = px - mx
    dy = py - my
    sigma = (a[..., CA:CA + 1] * dx * dx + a[..., CC:CC + 1] * dy * dy
             + a[..., CB:CB + 1] * dx * dy)
    return sigma, dx, dy


def _alpha(a, px, py, ox, oy, cfg: RasterizeConfig):
    """α per (tile, pixel) for one entry row ``a`` (n_tiles, 16) of each
    tile, with the intermediates the backward needs.  Also takes a chunk
    of rows (n_tiles, kc, 16) with ``ox``, ``oy`` of shape (n_tiles, 1, 1)."""
    sigma, dx, dy = _sigma(a, px, py, ox, oy)
    expns = torch.exp2(-sigma)
    opx = a[..., OP:OP + 1] * expns
    alpha = torch.clamp(opx, max=cfg.alpha_clip)
    keep = (sigma >= 0) & (alpha >= cfg.alpha_threshold)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    return alpha, opx, expns, dx, dy


def forward_tiles_plain(n_chunks, tile_ids, attrs_tiled, th, tw, k_tile,
                        k_chunk, n_tx, cfg: RasterizeConfig,
                        early_exit: bool = True) -> torch.Tensor:
    """(n_tiles, 8, npix) stack [R, G, B, D, A, T, chunks_done, 0].  With
    ``early_exit=False`` every chunk up to min(n_chunks, k_tile/k_chunk) is
    composited and counted."""
    n_tiles = attrs_tiled.shape[0]
    npix = th * tw
    dev = attrs_tiled.device
    px, py, ox, oy = _pixel_geometry(tile_ids, th, tw, n_tx)
    nch = torch.clamp(n_chunks, max=k_tile // k_chunk)
    T = torch.ones((n_tiles, npix), device=dev)
    outs = [torch.zeros((n_tiles, npix), device=dev) for _ in range(5)]
    m1 = torch.ones((n_tiles,), device=dev)
    m2 = torch.ones((n_tiles,), device=dev)
    live = torch.ones((n_tiles,), dtype=torch.bool, device=dev)
    done = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
    for c in range(int(nch.max()) if n_tiles else 0):
        # two-chunks-stale gate: m2 is the max of T after chunk c − 2
        live = live & (c < nch)
        if early_exit:
            live = live & (m2 > SAT_EPS)
        p = torch.ones_like(T)
        new = list(outs)
        for e in range(k_chunk):
            a = attrs_tiled[:, c * k_chunk + e]
            alpha, _, _, _, _ = _alpha(a, px, py, ox, oy, cfg)
            w = (T * p) * alpha
            new[0] = new[0] + w * a[:, R:R + 1]
            new[1] = new[1] + w * a[:, G:G + 1]
            new[2] = new[2] + w * a[:, B:B + 1]
            new[3] = new[3] + w * a[:, Z:Z + 1]
            new[4] = new[4] + w
            p = p * (1.0 - alpha)
        lv = live[:, None]
        outs = [torch.where(lv, n, o) for n, o in zip(new, outs)]
        T = torch.where(lv, T * p, T)
        done = done + live.to(torch.int32)
        m2, m1 = m1, T.amax(dim=-1)
    rows = outs + [T, done.float()[:, None].expand(n_tiles, npix),
                   torch.zeros_like(T)]
    return torch.stack(rows, dim=1)


def pixels_per_thread(npix: int) -> int:
    """Pixels each thread of K2 and K3 owns: 4 where npix / 4 threads make
    whole warps, else 2, else 1 (``csrc/composite_common.cuh``)."""
    return 4 if npix % 128 == 0 else 2 if npix % 64 == 0 else 1


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (pixel) axis in the backward kernel's order.

    1. Thread q of the S = npix / P threads adds its pixels q, q + S, …,
       q + (P − 1)·S in that order.
    2. Within each warp of 32 threads, a halving tree over lane bits 4, 3
       and 2 (lane i + lane i+16, then +8, then +4: the pairs of the
       kernel's reduce-scatter steps) leaves four partials, lanes 0..3.
    3. Those partials are added one after another, warp by warp.

    The sums of the backward cancel heavily, so only the same order gives
    the kernel's result to the last bit."""
    npix = x.shape[-1]
    p = pixels_per_thread(npix)
    x = x.reshape(x.shape[:-1] + (p, npix // p))
    s = x[..., 0, :]
    for j in range(1, p):
        s = s + x[..., j, :]
    s = s.reshape(s.shape[:-1] + (-1, 32))
    while s.shape[-1] > 4:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    s = s.flatten(-2)
    out = s[..., 0]
    for i in range(1, s.shape[-1]):
        out = out + s[..., i]
    return out


def backward_tiles_plain(chunks_done, tile_ids, attrs_tiled, fwd_stack,
                         grad_stack, th, tw, k_tile, k_chunk, n_tx,
                         cfg: RasterizeConfig) -> torch.Tensor:
    """(n_tiles, k_tile, 16) per-slot rows
    [dmx, dmy, dca~, dcb~, dcc~, dop, dz, dr, dg, db, 0…]; rows past the
    replayed chunks are zero."""
    n_tiles = attrs_tiled.shape[0]
    dev = attrs_tiled.device
    px, py, ox, oy = _pixel_geometry(tile_ids, th, tw, n_tx)
    done = torch.clamp(chunks_done, max=k_tile // k_chunk)
    dattrs = torch.zeros((n_tiles, k_tile, A), device=dev)
    F, Gg = fwd_stack, grad_stack
    gr, gg, gb, gd, ga = (Gg[:, k] for k in range(5))
    # cotangent of the transmittance output through dT_out/dα = −T_out/(1−α)
    gT_term = Gg[:, ROW_T] * F[:, ROW_T]
    # one suffix accumulator: S_u = Σ_j u_j, u_j = w_j·(G·V_j)
    S_u = gr * F[:, 0] + gg * F[:, 1] + gb * F[:, 2] + gd * F[:, 3] + ga * F[:, 4]
    T = torch.ones_like(S_u)
    zero6 = torch.zeros((n_tiles, A - 10), device=dev)
    for c in range(int(done.max()) if n_tiles else 0):
        act = (c < done)[:, None]
        p = torch.ones_like(T)
        cu = torch.zeros_like(T)
        for e in range(k_chunk):
            i = c * k_chunk + e
            a = attrs_tiled[:, i]
            alpha, opx, expns, dx, dy = _alpha(a, px, py, ox, oy, cfg)
            T_i = T * p
            w = T_i * alpha
            direct = (a[:, R:R + 1] * gr + a[:, G:G + 1] * gg
                      + a[:, B:B + 1] * gb + a[:, Z:Z + 1] * gd + ga)
            u = w * direct
            U_i = S_u - (cu + u)
            one_m = torch.clamp(1.0 - alpha, min=1e-6)
            gate = (alpha > 0) & (opx < cfg.alpha_clip)
            dalpha = torch.where(gate, T_i * direct - (U_i + gT_term) / one_m,
                                 torch.zeros_like(alpha))
            dsigma = -LN2 * dalpha * alpha
            t1 = dsigma * dx
            t2 = dsigma * dy
            s = _block_sum(torch.stack(
                [t1, t2, t1 * dx, t1 * dy, t2 * dy, dalpha * expns,
                 w * gd, w * gr, w * gg, w * gb], dim=1))        # (n_tiles, 10)
            ca, cb, cc = a[:, CA:CA + 1], a[:, CB:CB + 1], a[:, CC:CC + 1]
            s1, s2 = s[:, 0:1], s[:, 1:2]
            # ∂σ̃/∂dx = 2·ca~·dx + cb~·dy (packed-coefficient quad form)
            dmx = -(2.0 * ca * s1 + cb * s2)
            dmy = -(cb * s1 + 2.0 * cc * s2)
            row = torch.cat([dmx, dmy, s[:, 2:10], zero6], dim=1)
            dattrs[:, i] = torch.where(act, row, torch.zeros_like(row))
            cu = cu + u
            p = p * (1.0 - alpha)
        T = torch.where(act, T * p, T)
        S_u = torch.where(act, S_u - cu, S_u)
    return dattrs
