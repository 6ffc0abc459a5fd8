"""The training loop's account of itself, kept in ``Trainer.events``: where
a graphed step's device time goes, stage by stage, and where the host's
time goes.

**Stages.**  ``mark(stage)`` closes a stage of the step's device work
(``make_train_step``'s ``body``, ``render`` and ``rasterize_cuda``).  It
does nothing unless a hook is installed on the calling thread
(``marks_to``): ``graphs.GraphedStep`` installs a ``StageEvents`` while it
captures, which records a timing CUDA event on the capture stream at each
mark, an event-record node of the graph, so that every replay timestamps
the boundaries on the device.  The warm-ups, the eager and scan paths and
the CPU record nothing.  The marks of the single-scene step are ``start``
and then ``STAGES`` in order; a stage's time is the interval from the
mark before it.  ``Trainer.run`` reads the last replay's intervals at each
log point, after its reads have waited for the device (``add_stages``).

**Host spans.**  ``span(events, name)`` adds the block's milliseconds on
the host clock to ``events["host_<name>_ms"]``, less the time spent in
spans opened inside it, so that the spans of one thread never count a
nanosecond twice.  ``timer(events, key, name)`` adds the block's whole
time to ``events[key]`` and leaves the enclosing span's account alone
(``capture_ms``, inside ``dispatch``).  While ``torch.profiler`` runs,
each also opens a host range ``touchgs.<name>``, so that it sits on the
profiler's clock beside the device's records.

**Counter.**  ``count_read`` adds to ``events["host_reads"]`` at every
site where the loop or the refine waits for the device to read a value
back, or synchronises its stream.

Every value in ``events`` is an int or a float: the benchmark subtracts
them over its window.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

import torch

# the single-scene step's stages, in the order their marks close them
STAGES = ("shade", "bin", "composite", "loss", "backward", "adam", "stats")
# Trainer.run's spans: each adds to events["host_<name>_ms"]
SPANS = ("fetch", "dispatch", "read", "refine", "grow", "reset", "log",
         "ckpt")

_local = threading.local()   # this thread's mark hook and open spans


def new_events() -> dict:
    """``Trainer.events`` at its start: the counts of growths, refines,
    opacity resets and captures; the capture milliseconds; the host's
    reads; the stage milliseconds and their samples; the spans' host
    milliseconds."""
    events = {"grow": 0, "refine": 0, "reset_opacity": 0, "capture": 0,
              "capture_ms": 0.0, "host_reads": 0, "stage_samples": 0}
    events.update({f"stage_{s}_ms": 0.0 for s in STAGES})
    events.update({f"host_{s}_ms": 0.0 for s in SPANS})
    return events


def mark(stage: str) -> None:
    """Close ``stage`` of the step's device work: calls this thread's hook
    (``marks_to``), where there is one."""
    hook = getattr(_local, "hook", None)
    if hook is not None:
        hook(stage)


@contextlib.contextmanager
def marks_to(hook: Callable[[str], None]):
    """Send this thread's ``mark`` calls to ``hook`` while the block
    runs."""
    prev = getattr(_local, "hook", None)
    _local.hook = hook
    try:
        yield hook
    finally:
        _local.hook = prev


class StageEvents:
    """The stage boundaries of one captured graph: a timing CUDA event
    recorded on the current (capture) stream at each mark.  Recorded with
    ``external=True``, each is a node of the graph, which every replay
    records anew."""

    def __init__(self):
        self.marks: list = []

    def __call__(self, stage: str) -> None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.marks.append((stage, ev))

    def ms(self) -> dict:
        """Each stage's milliseconds in the last replay, summed where a
        name recurs.  The replay must have finished."""
        out: dict = {}
        for (_, a), (stage, b) in zip(self.marks, self.marks[1:]):
            out[stage] = out.get(stage, 0.0) + a.elapsed_time(b)
        return out


def add_stages(events: dict, stage_ms: Optional[dict]) -> None:
    """Add one replay's stage milliseconds to ``events``."""
    if not stage_ms:
        return
    for stage, ms in stage_ms.items():
        key = f"stage_{stage}_ms"
        events[key] = events.get(key, 0.0) + ms
    events["stage_samples"] = events.get("stage_samples", 0) + 1


def _profiler_range(name: str):
    """A ``touchgs.<name>`` range entered while the profiler runs;
    otherwise None.  A host-only range: ``record_function``'s user-scope
    ranges also become spans on the device's track of the trace, which a
    reader of device time would count as device work."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return None
    rf = torch._C._profiler._RecordFunctionFast(f"touchgs.{name}")
    rf.__enter__()
    return rf


class span:
    """``with span(events, name):`` adds the block's host milliseconds,
    less those of the spans opened inside it, to
    ``events["host_<name>_ms"]``; reads counted inside it with
    ``count_read()`` go to ``events``."""

    __slots__ = ("events", "key", "name", "t0", "inner", "rf")

    def __init__(self, events: dict, name: str):
        self.events, self.name = events, name
        self.key = f"host_{name}_ms"

    def __enter__(self):
        self.rf = _profiler_range(self.name)
        stack = getattr(_local, "spans", None)
        if stack is None:
            stack = _local.spans = []
        stack.append(self)
        self.inner = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = _local.spans
        stack.pop()
        if stack:
            stack[-1].inner += dt
        self.events[self.key] = (self.events.get(self.key, 0.0)
                                 + (dt - self.inner) * 1e-6)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class timer:
    """``with timer(events, key, name):`` adds the block's whole host
    milliseconds to ``events[key]``; the span it runs in keeps them in its
    own account."""

    __slots__ = ("events", "key", "name", "t0", "rf")

    def __init__(self, events: dict, key: str, name: str):
        self.events, self.key, self.name = events, key, name

    def __enter__(self):
        self.rf = _profiler_range(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.events[self.key] = self.events.get(self.key, 0.0) + dt * 1e-6
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def count_read(events: Optional[dict] = None, n: int = 1) -> None:
    """Count ``n`` waits for the device in ``events["host_reads"]``, or,
    without ``events``, in the innermost open span's; outside any span it
    counts nothing."""
    if events is None:
        stack = getattr(_local, "spans", None)
        if not stack:
            return
        events = stack[-1].events
    events["host_reads"] = events.get("host_reads", 0) + n


def drain(device: torch.device) -> None:
    """Wait for ``device``'s current stream (nothing on the CPU), counted
    as a read of the innermost open span."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    count_read()
