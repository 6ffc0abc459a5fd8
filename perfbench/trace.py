"""The traced run's record: ``torch.profiler`` over one period of the
window, and spans that the benchmark puts around the program's refine and
growth (at their module attributes, synchronised before and after).

From the profiler's events it keeps each device operation's interval and
each host operation's, and reduces them to the device seconds by name, the
busy seconds (the union of the device intervals), and the idle gaps, each
named by the innermost host operation that was running at its middle.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

from perfbench import counts

SPAN_TARGETS = ("refine_state", "grow_state")


def profile_call(run, device) -> tuple:
    """Run ``run()`` under the profiler; the profiler, whose events
    ``reduce_events`` reads once the window has closed, and the call's
    wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return prof, wall


def _events(prof):
    """(name, start_ns, end_ns, on_device) of every profiled event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        s = e.start_ns()
        out.append((e.name(), s, s + e.duration_ns(), dev))
    return out


def reduce_events(prof) -> dict:
    ev = _events(prof)
    device = [(s, e, n) for n, s, e, d in ev if d and e > s]
    host = [(s, e, n) for n, s, e, d in ev if not d and e > s]
    by_name = collections.Counter()
    for s, e, n in device:
        by_name[n] += (e - s) * 1e-9
    busy = counts.busy_seconds((s * 1e-9, e * 1e-9) for s, e, _ in device)
    return dict(device_s=dict(by_name), busy_s=busy,
                idle_gaps=idle_gaps(device, host), device_ops=len(device))


def idle_gaps(device, host, top: int = 10) -> list:
    """[[host operation, seconds]] of the device's idle gaps, summed by the
    innermost host operation running at each gap's middle (or "after" the
    last one to end before it, where the host ran Python), the largest
    first."""
    iv = sorted((s, e) for s, e, _ in device)
    if not iv:
        return []
    gaps, end = [], iv[0][1]
    for s, e in iv[1:]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    host = sorted(host)
    starts = [h[0] for h in host]
    named = collections.Counter()
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        best, before = None, None
        for s, e, n in reversed(host[max(0, i - 200):i]):
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
            elif e < mid and (before is None or e > before[1]):
                before = (s, e, n)
        name = (best[2] if best else f"after {before[2]}" if before
                else "(no host operation)")
        named[name] += (g1 - g0) * 1e-9
    return [[n, s] for n, s in named.most_common(top)]


@contextlib.contextmanager
def spans(record: dict, device):
    """Time each call of the trainer's refine and growth, synchronised
    before and after, in ``record["spans"][name]`` (ms)."""
    from touchgs_torch.train import trainer as tmod

    saved = {n: getattr(tmod, n) for n in SPAN_TARGETS}
    record.setdefault("spans", {n: [] for n in SPAN_TARGETS})

    def wrap(name, fn):
        def timed(*a, **k):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"perfbench.{name}"):
                out = fn(*a, **k)
            torch.cuda.synchronize(device)
            record["spans"][name].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    for n, fn in saved.items():
        setattr(tmod, n, wrap(n, fn))
    try:
        yield record
    finally:
        for n, fn in saved.items():
            setattr(tmod, n, fn)
