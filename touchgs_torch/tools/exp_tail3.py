"""The tail candidates chained with a data dependency, so that calls under
0.1 ms are timed without the host's gaps (port of ``tools/exp_tail3.py``).

Each candidate runs R = 9 times in a chain, each repeat reading the last
one's result, and once; its time is (t(R) − t(1)) / (R − 1).  The JAX tool
chains the repeats inside one ``jax.jit``; on the card the counterpart is
one CUDA-graph replay of the chain (captured after warm-up calls on a side
stream), so ``t`` is the CUDA-event time of a replay.  Each row prints the
chained time, then the single call's replay and the eager single call.
Candidates, as the JAX tool's: the (key, value) sort and the keys alone at
2²¹ (``exp_tail2``; each repeat sorts the last keys xor (i + 1)), SH
forward plus gradient in the per-coefficient and the 2-D layouts
(``exp_tail``; each repeat nudges the coefficients by 1e-9 of the
gradient), and the fused Adam per leaf and on flat views (every repeat
updates the parameters in place).

    python -m touchgs_torch.tools.exp_tail3 [--iters N]

It needs a CUDA card and exits with status 1 without one.  Every time comes
from ``utils.profiling.measure`` (CUDA events); a row that raises prints
``FAILED`` with its reason.  ``chain_ms`` takes the timer, so that the
tests check its arithmetic on the CPU.
"""
from __future__ import annotations

import sys
from typing import Callable

import torch

from touchgs_torch.tools.exp_common import iters_arg, needs_card
from touchgs_torch.tools.exp_scatter import sort_inputs, sort_keys, sort_pair
from touchgs_torch.tools.exp_tail import (ADAM_LRS, adam_flat, adam_state,
                                          eval_sh_2d, eval_sh_old, sh_grad,
                                          tail_inputs)
from touchgs_torch.utils.profiling import card, measure

ITERS = 10
R = 9
WARMUP = 2  # eager calls on a side stream before a capture


def chain_ms(time_chain: Callable[[int], float], reps: int = R) -> tuple:
    """(ms a repeat, ms of the one-repeat chain) from ``time_chain(n)``,
    the ms of a chain of n repeats: (t(reps) − t(1)) / (reps − 1), t(1)."""
    t1 = time_chain(1)
    return (time_chain(reps) - t1) / (reps - 1), t1


def graph_ms(fn: Callable, iters: int) -> float:
    """ms of one replay of ``fn()`` captured as a CUDA graph."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return measure(g.replay, iters=iters) * 1e3


def sort_pair_chain(k, v, reps: int):
    for i in range(reps):
        k, v = sort_pair(k ^ (i + 1), v)
    return k, v


def sort_single_chain(k, reps: int):
    for i in range(reps):
        k = sort_keys(k ^ (i + 1))
    return k


def sh_chain(evaluate, dc, rest, d, reps: int):
    out = dc.new_zeros(())
    for i in range(reps):
        g_dc, g_rest = sh_grad(evaluate, dc, rest, d + i * 1e-6)
        dc = dc + 1e-9 * g_dc
        rest = rest + 1e-9 * g_rest
        out = out + g_dc.sum()
    return out, dc


def chains() -> dict:
    """name → the candidate's chain of n repeats, as a callable of n."""
    s = sort_inputs()
    keys, vals = s["keys"], s["vals"]
    x = tail_inputs()
    sh = (x["dc"], x["rest"], x["dirs"])
    old = adam_state(x["params"])
    flat = adam_state(x["params"])

    def adam_old(n):
        diff, grads, opt, state = old
        for _ in range(n):
            opt.step(diff, grads, state)

    def adam_flat_chain(n):
        diff, grads, _, state = flat
        for _ in range(n):
            adam_flat(diff, grads, state, ADAM_LRS)

    return {
        "sort_pair(2M)": lambda n: sort_pair_chain(keys, vals, n),
        "sort_single(2M)": lambda n: sort_single_chain(keys, n),
        "sh_old fwd+grad": lambda n: sh_chain(eval_sh_old, *sh, n),
        "sh_2d  fwd+grad": lambda n: sh_chain(eval_sh_2d, *sh, n),
        "adam_old": adam_old,
        "adam_flat": adam_flat_chain,
    }


def main(argv=None, out: dict | None = None) -> int:
    """Exit status 1 without a card; ``out`` receives the rows."""
    argv = sys.argv[1:] if argv is None else argv
    if not needs_card("exp_tail3"):
        return 1
    print(card(), flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    iters = iters_arg(argv, ITERS)
    rows: dict = {}
    for name, chain in chains().items():
        try:
            ms, t1 = chain_ms(lambda n: graph_ms(lambda: chain(n), iters))
            eager = measure(chain, 1, iters=iters) * 1e3
        except Exception as e:  # a failing row is a finding: print it, go on
            rows[name] = f"FAILED: {type(e).__name__}: {str(e)[:150]}"
            print(f"{name} chained: {rows[name]}", flush=True)
            continue
        rows[name] = dict(chained_ms=ms, single_replay_ms=t1, eager_ms=eager)
        print(f"{name} chained: {ms:8.4f} ms (single-call replay {t1:.4f}, "
              f"eager {eager:.4f})", flush=True)
    if out is not None:
        out["rows"] = rows
    return 0


if __name__ == "__main__":
    sys.exit(main())
