"""The binning sort with and without its value operand, and SH in the 2-D
(K·3, C) layout, timed on the card (port of ``tools/exp_tail2.py``).

- ``sort_pair`` against ``sort_single``: the (key, value) sort (the keys'
  ``torch.sort`` and a gather of the values by its permutation) against
  the keys alone, at the binning's 2²¹ elements, and the pair at 2²⁰;
- SH: the port's per-coefficient ``eval_sh`` (``sh_old``) against the 2-D
  layout (``sh_2d``: the (C, 48) coefficients transposed to (48, C), every
  operation on (C,) rows), forward plus the gradient of the sum with
  respect to ``sh_dc`` and ``sh_rest`` with its parity error, then the
  forward alone.

Keys and values are ``exp_scatter.sort_inputs``'; the state is
``init_random(100000, capacity 131072, SH degree 3)``
(``exp_tail.tail_inputs``).

    python -m touchgs_torch.tools.exp_tail2 [--iters N]

It needs a CUDA card and exits with status 1 without one.  Every time comes
from ``utils.profiling.measure`` (CUDA events); a row that raises prints
``FAILED`` with its reason.
"""
from __future__ import annotations

import sys

import torch

from touchgs_torch.tools.exp_common import iters_arg, needs_card
from touchgs_torch.tools.exp_scatter import sort_inputs, sort_keys, sort_pair
from touchgs_torch.tools.exp_tail import (eval_sh_2d, eval_sh_old, sh_grad,
                                          sh_parity, tail_inputs)
from touchgs_torch.utils.profiling import card, timed_row

ITERS = 20


def sort_half(k, v):
    """The (key, value) sort of the first half."""
    return sort_pair(k[:k.shape[0] // 2], v[:v.shape[0] // 2])


def main(argv=None, out: dict | None = None) -> int:
    """Exit status 1 without a card; ``out`` receives the rows."""
    argv = sys.argv[1:] if argv is None else argv
    if not needs_card("exp_tail2"):
        return 1
    print(card(), flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    iters = iters_arg(argv, ITERS)
    times: dict = {}
    s = sort_inputs()
    keys, vals = s["keys"], s["vals"]
    timed_row(times, "sort_pair(2M)", sort_pair, keys, vals, iters=iters,
              width=16)
    timed_row(times, "sort_single(2M)", sort_keys, keys, iters=iters,
              width=16)
    timed_row(times, "sort_pair(1M)", sort_half, keys, vals, iters=iters,
              width=16)
    x = tail_inputs()
    times["sh_2d parity"] = sh_parity(eval_sh_2d, x)
    print(f"sh_2d parity: {times['sh_2d parity']:.2e}", flush=True)
    args = (x["dc"], x["rest"], x["dirs"])
    timed_row(times, "sh_old", sh_grad, eval_sh_old, *args, iters=iters,
              width=16)
    timed_row(times, "sh_2d", sh_grad, eval_sh_2d, *args, iters=iters,
              width=16)
    timed_row(times, "sh_old fwd", eval_sh_old, *args, iters=iters, width=16)
    timed_row(times, "sh_2d  fwd", eval_sh_2d, *args, iters=iters, width=16)
    if out is not None:
        out["rows"] = times
    return 0


if __name__ == "__main__":
    sys.exit(main())
