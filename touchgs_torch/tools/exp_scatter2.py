"""The scatter-add's cost by rows, width, dtype and out-of-range share, and
three gathers, timed on the card (port of ``tools/exp_scatter2.py``).

Eight scatter-add cases into a zero table of 131584 rows, indices and data
from ``default_rng(0)`` in the JAX tool's order: 806,400 rows of 16 f32
(the base), the same with 31% of the rows out of range, 8 and 32 wide, bf16,
403,200 and 201,600 rows, and 1 wide.  JAX's ``.at[].add`` drops rows whose
index is out of range, while ``index_add_`` and ``index_put_`` raise on
them, so the port masks those rows: they are added into one spare row past
the table, which is then cut off (the same result as dropping them, with no
read back to the host).  Then the gathers of 806k rows from 131k and from
806k, and of 2.1M rows from 131k, 16 wide.

    python -m touchgs_torch.tools.exp_scatter2 [--iters N]

It needs a CUDA card and exits with status 1 without one.  Every time comes
from ``utils.profiling.measure`` (CUDA events); a row that raises prints
``FAILED`` with its reason.  The computing functions take a ``device`` and
sizes, so that the tests drive them on the CPU at a small size.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from touchgs_torch.tools.exp_common import iters_arg, needs_card
from touchgs_torch.utils.profiling import card, timed_row

ITERS = 20
C = 131_584
# (name, rows, width, dtype, out-of-range share), tools/exp_scatter2.py:50-59
CASES = (
    ("806k x16 f32 (base)", 806_400, 16, torch.float32, 0.0),
    ("806k x16 f32 31% OOB", 806_400, 16, torch.float32, 0.31),
    ("806k x8  f32", 806_400, 8, torch.float32, 0.0),
    ("806k x32 f32", 806_400, 32, torch.float32, 0.0),
    ("806k x16 bf16", 806_400, 16, torch.bfloat16, 0.0),
    ("403k x16 f32", 403_200, 16, torch.float32, 0.0),
    ("202k x16 f32", 201_600, 16, torch.float32, 0.0),
    ("806k x1  f32 scalar-ish", 806_400, 1, torch.float32, 0.0),
)
# (rows, source rows) of the gathers, tools/exp_scatter2.py:69
GATHERS = ((806_400, C), (806_400, 806_400), (2_100_000, C))


def case_inputs(rng, rows: int, width: int, dtype, oob: float, c: int = C,
                device="cuda") -> tuple:
    """(indices, data) of a case, drawn as the JAX tool draws them: indices
    in [0, c), those of an ``oob`` share of the rows set to c + 10."""
    idx = rng.integers(0, c, rows)
    if oob:
        dead = rng.random(rows) < oob
        idx = np.where(dead, c + 10, idx)
    data = rng.normal(size=(rows, width))
    return (torch.as_tensor(idx.astype(np.int64), device=device),
            torch.as_tensor(data, dtype=dtype, device=device))


def scatter_add(idx, data, c: int = C):
    """(c, width): ``data``'s rows added at ``idx``; rows whose index lies
    outside [0, c) go into a spare row past the table and are dropped."""
    idx = torch.where((idx >= 0) & (idx < c), idx, c)
    out = data.new_zeros((c + 1, data.shape[1]))
    return out.index_add_(0, idx, data)[:c]


def gather(data, idx):
    return data[idx]


def main(argv=None, out: dict | None = None) -> int:
    """Exit status 1 without a card; ``out`` receives the rows."""
    argv = sys.argv[1:] if argv is None else argv
    if not needs_card("exp_scatter2"):
        return 1
    print(card(), flush=True)
    iters = iters_arg(argv, ITERS)
    rng = np.random.default_rng(0)
    times: dict = {}
    for name, rows, width, dtype, oob in CASES:
        try:
            idx, data = case_inputs(rng, rows, width, dtype, oob)
        except Exception as e:  # a failing row is a finding: print it, go on
            times[name] = f"FAILED: {type(e).__name__}: {str(e)[:150]}"
            print(f"{name:<26} {times[name]}", flush=True)
            continue
        timed_row(times, name, scatter_add, idx, data, iters=iters, width=26)
    for rows, src in GATHERS:
        idx = torch.as_tensor(rng.integers(0, src, rows), device="cuda")
        data = torch.as_tensor(rng.normal(size=(src, 16)),
                               dtype=torch.float32, device="cuda")
        timed_row(times, f"gather {rows // 1000}k from {src // 1000}k x16",
                  gather, data, idx, iters=iters, width=26)
    if out is not None:
        out["rows"] = times
    return 0


if __name__ == "__main__":
    sys.exit(main())
