"""Kernel-anatomy probes: the forward ablations (K5) and the bf16 probe
(K6), as CUDA kernels with their plain PyTorch versions.

Ports of the two Pallas kernels of ``tools/exp_kernel_anatomy.py``:

- **K5** ``variant`` (``csrc/anatomy_variants.cu``, replacing
  ``make_variant``, :78-135): K2 stripped down with no early exit, in K2's
  thread shape, in the modes ``full``, ``no_mxu``, ``alpha_only`` and
  ``noexp``.  Output (n_tiles, 2, npix) = [Σ-row, T].
- **K6** ``bf16_probe`` (``csrc/bf16_probe.cu``, replacing ``bf16_probe``'s
  ``make(dtype)``, :188-213): the α chain summed over 512 rows, in f32 or
  in packed bf16 with the chunk sums on the tensor cores.  Output
  (n_tiles, 1, 1024) f32.

Each wrapper dispatches on its tensors' device: on the CPU it runs the plain
version here; on CUDA it launches its kernel through
``cuda_build.launch``, which counts it as ``anatomy_<mode>`` or
``bf16_probe_<leg>``, or raises.
"""
from __future__ import annotations

import torch

from touchgs_torch.config import RasterizeConfig
from touchgs_torch.ops import cuda_build
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.ops.cuda_build import check_tensor, on_cuda
from touchgs_torch.ops.rasterize_cuda import _check_geometry

MODES = ("full", "no_mxu", "alpha_only", "noexp")
# fp32 operations per (entry, pixel), counted in csrc/anatomy_variants.cu's
# header comment
OPS_PER_PAIR = {"full": 31, "no_mxu": 23, "alpha_only": 19, "noexp": 19}
# per (row, pixel) of the bf16 probe, counted in csrc/bf16_probe.cu's header
# comment: the α chain (in the working type) and the chunk sum (in f32)
PROBE_CHAIN_OPS, PROBE_SUM_OPS = 18, 1
PROBE_ROWS, PROBE_CHUNK, PROBE_COLS, PROBE_NPIX = 512, 128, 16, 1024
PROBE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def variant_plain(mode: str, n_chunks, tile_ids, attrs_tiled, th, tw,
                  k_tile, k_chunk, n_tx,
                  cfg: RasterizeConfig) -> torch.Tensor:
    """(n_tiles, 2, npix) [Σ-row, T] of K5 ``mode``, a chunk at a time."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: want one of {MODES}")
    n_tiles = attrs_tiled.shape[0]
    dev = attrs_tiled.device
    px, py, ox, oy = plain._pixel_geometry(tile_ids, th, tw, n_tx)
    ox, oy = ox[:, :, None], oy[:, :, None]          # (n_tiles, 1, 1)
    nch = torch.clamp(n_chunks, max=k_tile // k_chunk)
    acc = torch.zeros((n_tiles, th * tw), device=dev)
    T = torch.ones_like(acc)
    for c in range(int(nch.max()) if n_tiles else 0):
        live = (c < nch)[:, None]
        a = attrs_tiled[:, c * k_chunk:(c + 1) * k_chunk]   # (n_tiles, kc, 16)
        if mode == "noexp":
            sigma, _, _ = plain._sigma(a, px, py, ox, oy)
            expns = 1.0 - 0.25 * sigma                       # stand-in for exp2
            alpha = torch.clamp(a[..., plain.OP:plain.OP + 1] * expns,
                                max=cfg.alpha_clip)
            keep = (sigma >= 0) & (alpha >= cfg.alpha_threshold)
            alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        else:
            alpha, _, _, _, _ = plain._alpha(a, px, py, ox, oy, cfg)
        if mode in ("alpha_only", "noexp"):
            s = alpha.sum(dim=1)
        else:
            # w = T·p·α with p the exclusive running product of (1 − α);
            # `full`'s other four rows never reach its output
            incl = torch.cumprod(1.0 - alpha, dim=1)
            excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1)
            s = ((T[:, None] * excl) * alpha).sum(dim=1)
            T = torch.where(live, T * incl[:, -1], T)
        acc = torch.where(live, acc + s, acc)
    return torch.stack([acc, T], dim=1)


def variant(mode: str, n_chunks, tile_ids, attrs_tiled, th, tw, k_tile,
            k_chunk, n_tx, cfg: RasterizeConfig) -> torch.Tensor:
    """K5: (n_tiles, 2, th·tw) [Σ-row, T] of the forward ablation ``mode``
    (``full``, ``no_mxu``, ``alpha_only`` or ``noexp``), no early exit."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: want one of {MODES}")
    if not on_cuda(n_chunks, tile_ids, attrs_tiled):
        return variant_plain(mode, n_chunks, tile_ids, attrs_tiled, th, tw,
                             k_tile, k_chunk, n_tx, cfg)
    _check_geometry(th, tw, k_tile, k_chunk)
    n_tiles = attrs_tiled.shape[0]
    npix = th * tw
    if not plain.whole_warps(npix):
        raise ValueError(f"tile {th}x{tw}: K5 wants a multiple of 32 pixels, "
                         f"at most 1024")
    check_tensor(n_chunks, "n_chunks", torch.int32, (n_tiles,))
    check_tensor(tile_ids, "tile_ids", torch.int32, (n_tiles,))
    check_tensor(attrs_tiled, "attrs_tiled", torch.float32,
                 (n_tiles, k_tile, plain.A))
    out = torch.empty((n_tiles, 2, npix), dtype=torch.float32,
                      device=attrs_tiled.device)
    # `full` stores its R, G, B, D rows here, so they stay in the code
    scratch = (torch.empty((n_tiles, 4, npix), dtype=torch.float32,
                           device=out.device) if mode == "full" else None)
    cuda_build.launch("anatomy_variants", n_chunks.data_ptr(),
                      tile_ids.data_ptr(), attrs_tiled.data_ptr(),
                      out.data_ptr(),
                      None if scratch is None else scratch.data_ptr(),
                      MODES.index(mode), n_tiles, th, tw, k_tile, k_chunk,
                      n_tx, cfg.alpha_clip, cfg.alpha_threshold,
                      key=f"anatomy_{mode}")
    return out


def bf16_probe_plain(attrs: torch.Tensor) -> torch.Tensor:
    """(n_tiles, 1, 1024) f32.  Every operation of the α chain is rounded to
    ``attrs.dtype``; each chunk's sum is taken once in f32 and rounded to the
    dtype; the running total is kept in the dtype."""
    dt, dev = attrs.dtype, attrs.device
    n_tiles = attrs.shape[0]
    px = torch.arange(PROBE_NPIX, device=dev).to(dt)[None, None, :]
    py = px * 0.5
    clip = torch.tensor(0.999, dtype=dt, device=dev)
    thr = torch.tensor(1 / 255.0, dtype=dt, device=dev)
    acc = torch.zeros((n_tiles, PROBE_NPIX), dtype=dt, device=dev)
    for c in range(PROBE_ROWS // PROBE_CHUNK):
        a = attrs[:, c * PROBE_CHUNK:(c + 1) * PROBE_CHUNK]
        mx, my, ca, cb, cc, op = (a[..., k:k + 1] for k in range(6))
        dx = px - mx
        dy = py - my
        sig = ca * dx * dx + cc * dy * dy + cb * dx * dy
        al = torch.minimum(clip, op * torch.exp2(-sig))
        al = torch.where((sig >= 0) & (al >= thr), al, torch.zeros_like(al))
        acc = acc + al.float().sum(dim=1).to(dt)
    return acc.float()[:, None, :]


def bf16_probe(attrs: torch.Tensor) -> torch.Tensor:
    """K6: the α-sum probe on (n_tiles, 512, 16) ``attrs`` in f32 or bf16;
    (n_tiles, 1, 1024) f32."""
    leg = {v: k for k, v in PROBE_DTYPES.items()}.get(attrs.dtype)
    if leg is None:
        raise ValueError(f"attrs: want float32 or bfloat16, got {attrs.dtype}")
    if not on_cuda(attrs):
        return bf16_probe_plain(attrs)
    n_tiles = attrs.shape[0]
    check_tensor(attrs, "attrs", attrs.dtype,
                 (n_tiles, PROBE_ROWS, PROBE_COLS))
    if attrs.data_ptr() % 16:  # the kernel reads rows with 16-byte loads
        raise ValueError("attrs: want a 16-byte aligned start")
    out = torch.empty((n_tiles, 1, PROBE_NPIX), dtype=torch.float32,
                      device=attrs.device)
    cuda_build.launch("bf16_probe", attrs.data_ptr(), out.data_ptr(),
                      int(leg == "bf16"), n_tiles, key=f"bf16_probe_{leg}")
    return out
