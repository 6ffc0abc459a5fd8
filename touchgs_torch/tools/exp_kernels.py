"""The tile kernels, the per-tile gather and its scatter-add, and SSIM, each
timed alone on the card at the bench's shapes (port of
``tools/exp_kernels.py``).

The scene is the bench's (800x800, 100k Gaussians from ``init_random`` in a
capacity of 131072, SH degree 3, ``pair_stats.bench_camera``, colours
|sh_dc|) under ``RasterizeConfig(use_pallas=True)``: 625 tiles of 32x32,
k_tile 512.  Rows, as the JAX tool's:

- ``slot lists``: K1's lists alone (``rasterize_cuda.slot_lists``);
- ``gather real``: the rows ``attrs[gidx]``;
- ``slot rows``: the port's K1 with rows, which does both in one pass;
- ``fwd kernel`` and ``bwd kernel``: K2 and K3 at k_chunk 128 (K3 on a
  cotangent of ones);
- ``scatter real``: the gather's VJP as ``_SlotRows.backward`` takes it
  (``rasterize_cuda.scatter_rows``: on the card the scatter kernel, which
  adds the live slots alone), on K3's gradients;
- ``ssim fwd`` and ``ssim fwd+grad`` on two 800x800x3 images from
  ``default_rng(0)``: the kernels of ``csrc/ssim.cu``; beside them
  ``ssim plain fwd+grad`` (``ssim_fwd_plain`` and ``ssim_bwd_plain`` on the
  card) and ``ssim band fwd+grad`` (``ssim_cm_band``: autograd through the
  band-matrix products, the step's SSIM before the kernels, the library
  yardstick), and
  each again at 1280x720; ``ssim device`` rows give the two kernels' own
  device time a call under ``torch.profiler``.

    python -m touchgs_torch.tools.exp_kernels [--iters N]

It needs a CUDA card and exits with status 1 without one.  Every time comes
from ``utils.profiling.measure`` (CUDA events); a row that raises prints
``FAILED`` with its reason.  The computing functions take a ``device`` so
that the tests drive them on the CPU at a small size.
"""
from __future__ import annotations

import re
import sys

import numpy as np
import torch

from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.ops.ssim import (ssim, ssim_bwd_plain, ssim_cm_band,
                                    ssim_fwd_plain)
from touchgs_torch.tools.exp_common import bench_tiles, iters_arg, needs_card
from touchgs_torch.utils.profiling import card, timed_row

ITERS = 20
SSIM_SIZE = 800
# (H, W) of the benchmark's two cells
SSIM_SHAPES = ((800, 800), (720, 1280))
C1, C2 = 0.01**2, 0.03**2


def kernel_rows(x: dict) -> tuple:
    """(rows, K2's stack): name → (fn, args) of the kernel rows on
    ``bench_tiles``' inputs, in the JAX tool's order."""
    geom, at, nc, tids = x["geom"], x["at"], x["nc"], x["tids"]
    fwd = rc.forward_tiles(nc, tids, at, *geom)
    done = fwd[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
    ones = torch.ones_like(fwd)
    dattrs = rc.backward_tiles(done, tids, at, fwd, ones, *geom)
    return {
        "slot lists": (rc.slot_lists, x["k1"]),
        "gather real": (lambda a, g: a[g], (x["attrs"], x["gidx"])),
        "slot rows": (rc.slot_rows, (x["attrs"], *x["k1"])),
        "fwd kernel": (lambda a: rc.forward_tiles(nc, tids, a, *geom), (at,)),
        "bwd kernel": (lambda a, f, g: rc.backward_tiles(
            done, tids, a, f, g, *geom), (at, fwd, ones)),
        "scatter real": (rc.scatter_rows,
                         (dattrs, x["gidx"], x["k1"][2], x["k1"][5],
                          x["geom"][5].max_tiles_per_gaussian)),
    }, fwd


def ssim_inputs(device="cuda", size: int = SSIM_SIZE,
                width: int | None = None) -> tuple:
    """Two (size, width or size, 3) images from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return tuple(torch.as_tensor(rng.uniform(0, 1, (size, width or size, 3)),
                                 dtype=torch.float32, device=device)
                 for _ in range(2))


def ssim_fwd_grad(a, b):
    a = a.detach().requires_grad_(True)
    return torch.autograd.grad(ssim(a, b), a)[0]


def ssim_plain_fwd_grad(a, b):
    """dSSIM/da through the plain versions (band-matrix blur, analytic
    backward) on ``a``'s device."""
    pa, pb = a.permute(2, 0, 1), b.permute(2, 0, 1)
    _, maps = ssim_fwd_plain(pa, pb, C1, C2, True)
    return ssim_bwd_plain(pa, pb, maps, torch.ones((), device=a.device))


def ssim_band_fwd_grad(a, b):
    a = a.detach().requires_grad_(True)
    v = ssim_cm_band(a.permute(2, 0, 1), b.permute(2, 0, 1))
    return torch.autograd.grad(v, a)[0]


def ssim_device_ms(a, b, iters: int) -> dict:
    """{kernel: device ms a call} of ``ssim_fwd_grad`` over ``iters``
    calls under ``torch.profiler`` (the kernels alone, no host work)."""
    from torch.profiler import ProfilerActivity, profile

    ssim_fwd_grad(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            ssim_fwd_grad(a, b)
        torch.cuda.synchronize()
    return {m.group(0): e.device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if (m := re.search(r"ssim_\w+?_kernel", e.key))}


def run(iters: int = ITERS) -> dict:
    """Print the JAX tool's rows with the card's times; returns them."""
    x = bench_tiles()
    rows, fwd = kernel_rows(x)
    done = fwd[:, plain.ROW_DONE, 0]
    print(f"tiles={x['n_tiles']} mean nc={float(x['nc'].float().mean()):.2f} "
          f"mean done={float(done.mean()):.2f}", flush=True)
    out: dict = {}
    for name, (fn, args) in rows.items():
        timed_row(out, name, fn, *args, iters=iters, width=16)
    for h, w in SSIM_SHAPES:
        a, b = ssim_inputs(size=h, width=w)
        at = "" if (h, w) == (SSIM_SIZE, SSIM_SIZE) else f" {w}x{h}"
        for name, fn in (("ssim fwd", ssim), ("ssim fwd+grad", ssim_fwd_grad),
                         ("ssim plain fwd+grad", ssim_plain_fwd_grad),
                         ("ssim band fwd+grad", ssim_band_fwd_grad)):
            timed_row(out, name + at, fn, a, b, iters=iters, width=32)
        for kernel, ms in ssim_device_ms(a, b, iters).items():
            out[f"ssim device {kernel}{at}"] = ms
            print(f"{'ssim device ' + kernel + at:<32} {ms:9.4f} ms",
                  flush=True)
    return out


def main(argv=None, out: dict | None = None) -> int:
    """Exit status 1 without a card; ``out`` receives the rows."""
    argv = sys.argv[1:] if argv is None else argv
    if not needs_card("exp_kernels"):
        return 1
    print(card(), flush=True)
    rows = run(iters_arg(argv, ITERS))
    if out is not None:
        out["rows"] = rows
    return 0


if __name__ == "__main__":
    sys.exit(main())
