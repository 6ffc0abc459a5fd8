"""The candidates for the backward's gradient reduction, and the sorts of
the binning, timed on the card (port of ``tools/exp_scatter.py``).

The step's scatter-add (the VJP of the per-tile gather ``attrs[gidx]``)
adds the (tile, slot) rows' gradients into per-Gaussian rows, with
duplicate indices.  Candidates, at the JAX tool's shapes (700 tiles of 1152
slots, 16 wide, into 131584 rows; 16 pair slots a Gaussian), on rows,
indices and unique pair ids from ``default_rng(0)``:

- A: PyTorch's duplicate-index scatter-add (``index_put_`` with
  accumulate=True, ``rasterize_plain.scatter_rows_plain``), every slot
  added: ``_SlotRows.backward`` on the CPU;
- B: a set of each row into its own pair slot of a (131072·16, 16) buffer
  (no collisions), then a reshape-sum over the 16 slots;
- B′: the same with an add in place of the set;
- D: the rows gathered by the permutation that sorts them by Gaussian (the
  first step of a sort-based segment sum).

Then on each cell's real lists (``chip_smoke.cell_lists``: the benchmark's
start state of the cell's configuration, one view, at its k_tile), with a
seeded random gradient a slot:

- A: as above, every slot of the lists, the dead ones too;
- E: the scatter kernel (``rasterize_cuda.scatter_rows``, what
  ``_SlotRows.backward`` runs on the card), the live slots alone;

each also on the device alone (``chip_smoke.device_ms``: the profiler's
kernel records, a row ``... device``).

Then the sorts of the binning at 2,097,152 elements: (key, value) stable
and unstable, keys only, and (key, value) with uint32 keys; and the rank
double sort over 131072.  A (key, value) sort is ``torch.sort`` of the keys
and a gather of the values by its permutation.

    python -m touchgs_torch.tools.exp_scatter [--iters N]

It needs a CUDA card and exits with status 1 without one.  Every time comes
from ``utils.profiling.measure`` (CUDA events); a row that raises (a dtype
the card's sort does not take, say) prints ``FAILED`` with its reason.  The
computing functions take a ``device`` and sizes, so that the tests drive
them on the CPU at a small size.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.tools.exp_common import iters_arg, needs_card
from touchgs_torch.utils.profiling import card, timed_row

ITERS = 20
N_TILES, K_WIDE, A = 700, 1152, 16
C = 131_072 + 512
T_CAP = 16
G = 131_072
# the cells whose start states' lists rows A and E take (``chip_smoke``'s
# names of the benchmark's configurations)
CELLS = ("blender800", "mirror720", "real1m")


def reduction_inputs(device="cuda", n_tiles: int = N_TILES,
                     k_wide: int = K_WIDE, c: int = C, g: int = G,
                     t_cap: int = T_CAP, seed: int = 0) -> dict:
    """The JAX tool's rows (n_tiles, k_wide, 16), indices into c rows and
    unique pair ids into g·t_cap slots, drawn in its order."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n_tiles, k_wide, A)).astype(np.float32)
    gidx = rng.integers(0, c, (n_tiles, k_wide)).astype(np.int32)
    pid = rng.permutation(g * t_cap)[:n_tiles * k_wide].reshape(
        n_tiles, k_wide).astype(np.int64)
    t = (lambda a: torch.as_tensor(a, device=device))
    order = torch.argsort(t(gidx).reshape(-1).long())
    return dict(rows=t(rows), gidx=t(gidx), pid=t(pid), order=order, c=c,
                g=g, t_cap=t_cap)


def scatter_add_dup(x: dict, r):
    """A: (c, 16), the rows added by ``gidx`` with duplicates."""
    dead = x["c"] - plain.DEAD_SPREAD
    return plain.scatter_rows_plain(r, x["gidx"], dead)


def _pair_space(x: dict, r, accumulate: bool):
    buf = r.new_zeros((x["g"] * x["t_cap"], A))
    buf.index_put_((x["pid"].reshape(-1),), r.reshape(-1, A),
                   accumulate=accumulate)
    return buf.reshape(x["g"], x["t_cap"], A).sum(dim=1)


def scatter_set_unique(x: dict, r):
    """B: (g, 16), each row set into its own pair slot, then summed over a
    Gaussian's t_cap slots."""
    return _pair_space(x, r, accumulate=False)


def scatter_add_unique(x: dict, r):
    """B′: B with an add in place of the set."""
    return _pair_space(x, r, accumulate=True)


def gather_rows_by_perm(x: dict, r):
    """D: the rows in the order that sorts them by Gaussian."""
    return r.reshape(-1, A)[x["order"]]


REDUCTIONS = (("A scatter-add dup", scatter_add_dup),
              ("B scatter set unique", scatter_set_unique),
              ("B' scatter add unique", scatter_add_unique),
              ("D gather rows by perm", gather_rows_by_perm))


def cell_rows(lists: dict, seed: int = 0) -> dict:
    """name → (fn, args) of rows A and E on a cell's lists
    (``chip_smoke.cell_lists``), with a gradient a slot from a seeded
    generator on the lists' device."""
    gidx, counts = lists["gidx"], lists["counts"]
    gen = torch.Generator(device=gidx.device)
    gen.manual_seed(seed)
    grad = torch.randn(gidx.shape + (A,), generator=gen, device=gidx.device)
    dead, width = lists["dead"], lists["width"]
    return {
        "A index_put_ every slot": (plain.scatter_rows_plain,
                                    (grad, gidx, dead)),
        "E kernel, live slots": (rc.scatter_rows,
                                 (grad, gidx, counts, dead, width)),
    }


def sort_inputs(device="cuda", m: int = G * T_CAP, g: int = G,
                seed: int = 1) -> dict:
    """Keys in [0, 2³¹ − 1), as int32 and as uint32, values in [0, g) and
    float rank keys."""
    rng = np.random.default_rng(seed)
    keys = torch.as_tensor(rng.integers(0, 2**31 - 1, m).astype(np.int32),
                           device=device)
    vals = torch.as_tensor(rng.integers(0, g, m).astype(np.int32),
                           device=device)
    kg = torch.as_tensor(rng.normal(size=g).astype(np.float32), device=device)
    return dict(keys=keys, keys_u32=keys.to(torch.uint32), vals=vals, kg=kg)


def sort_pair(k, v, stable: bool = False):
    """(keys, values) sorted by key: the keys' sort and a gather of the
    values by its permutation."""
    s, i = torch.sort(k, stable=stable)
    return s, v[i]


def sort_keys(k):
    return torch.sort(k).values


def rank_double_sort(k):
    """Each element's rank: the sort's permutation, sorted again."""
    o = torch.sort(k, stable=True).indices
    return torch.sort(o, stable=True).indices


def sort_rows(s: dict) -> dict:
    """name → (fn, args) of the sort rows."""
    return {
        "sort 2.1M (k,v) stable": (lambda k, v: sort_pair(k, v, True),
                                   (s["keys"], s["vals"])),
        "sort 2.1M (k,v) unstable": (sort_pair, (s["keys"], s["vals"])),
        "sort 2.1M keys only": (sort_keys, (s["keys"],)),
        "sort 2.1M u32 (k,v)": (sort_pair, (s["keys_u32"], s["vals"])),
        "rank double-sort 131k": (rank_double_sort, (s["kg"],)),
    }


def main(argv=None, out: dict | None = None) -> int:
    """Exit status 1 without a card; ``out`` receives the rows."""
    argv = sys.argv[1:] if argv is None else argv
    if not needs_card("exp_scatter"):
        return 1
    print(card(), flush=True)
    iters = iters_arg(argv, ITERS)
    times: dict = {}
    x = reduction_inputs()
    for name, fn in REDUCTIONS:
        timed_row(times, name, fn, x, x["rows"], iters=iters)
    del x
    from chip_smoke import cell_lists, device_ms

    for cell in CELLS:
        lists = cell_lists(cell, "cuda")
        n_tiles, k_tile = lists["gidx"].shape
        live = int(lists["counts"].sum())
        print(f"{cell}: {n_tiles} x {k_tile} slots, {live} live "
              f"({100 * live / (n_tiles * k_tile):.2f}%)", flush=True)
        for name, (fn, args) in cell_rows(lists).items():
            timed_row(times, f"{name} {cell}", fn, *args, iters=iters)
            ms = device_ms(lambda: fn(*args), iters)
            times[f"{name} {cell} device"] = ms
            print(f"{name} {cell} device {ms:9.5f} ms", flush=True)
        del lists
    for name, (fn, args) in sort_rows(sort_inputs()).items():
        timed_row(times, name, fn, *args, iters=iters)
    if out is not None:
        out["rows"] = times
    return 0


if __name__ == "__main__":
    sys.exit(main())
