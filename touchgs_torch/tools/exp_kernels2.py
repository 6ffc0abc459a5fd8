"""K2 with and without its early exit at k_chunk 128 and 256, and K3 at
each, timed on the card on the bench's tiles (port of
``tools/exp_kernels2.py``).

The tiles are ``exp_kernels``' (the bench scene, 625 tiles of 32x32,
k_tile 512).  Rows, as the JAX tool's: ``fwd kc=<k_chunk> ee=<True|False>``
for K2 with the exit on and off, then ``bwd kc=<k_chunk>`` for K3 on a
cotangent of ones, replaying the chunks of K2 without its exit (the JAX
tool's last forward).

    python -m touchgs_torch.tools.exp_kernels2 [--iters N]

It needs a CUDA card and exits with status 1 without one.  Every time comes
from ``utils.profiling.measure`` (CUDA events); a row that raises prints
``FAILED`` with its reason.  ``rows`` takes any tiles, so that the tests
drive it on the CPU at a small size.
"""
from __future__ import annotations

import sys

import torch

from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.tools.exp_common import bench_tiles, iters_arg, needs_card
from touchgs_torch.utils.profiling import card, timed_row

ITERS = 20
K_CHUNKS = (128, 256)


def rows(x: dict) -> dict:
    """name → (fn, args) of the JAX tool's rows on ``bench_tiles``' inputs
    (its chunk counts are recomputed for each k_chunk)."""
    th, tw, k_tile, _, n_tx, rcfg = x["geom"]
    capped, at, tids = x["k1"][2], x["at"], x["tids"]
    out = {}
    for kc in K_CHUNKS:
        geom = (th, tw, k_tile, kc, n_tx, rcfg)
        nc = ((capped + kc - 1) // kc).to(torch.int32)
        for ee in (True, False):
            out[f"fwd kc={kc} ee={ee}"] = (
                lambda a, nc=nc, geom=geom, ee=ee: rc.forward_tiles(
                    nc, tids, a, *geom, early_exit=ee), (at,))
        fwd = rc.forward_tiles(nc, tids, at, *geom, early_exit=False)
        done = fwd[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
        out[f"bwd kc={kc}"] = (
            lambda a, f, g, done=done, geom=geom: rc.backward_tiles(
                done, tids, a, f, g, *geom), (at, fwd, torch.ones_like(fwd)))
    return out


def main(argv=None, out: dict | None = None) -> int:
    """Exit status 1 without a card; ``out`` receives the rows."""
    argv = sys.argv[1:] if argv is None else argv
    if not needs_card("exp_kernels2"):
        return 1
    print(card(), flush=True)
    iters = iters_arg(argv, ITERS)
    times: dict = {}
    for name, (fn, args) in rows(bench_tiles()).items():
        timed_row(times, name, fn, *args, iters=iters, width=24)
    if out is not None:
        out["rows"] = times
    return 0


if __name__ == "__main__":
    sys.exit(main())
