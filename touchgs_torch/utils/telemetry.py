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
mark before it.  A nested stage (``NESTED``) lies inside one of them and
splits nothing: its time is the interval from the mark ``NESTED`` names to
its own, which ``mark_at_grad`` sets where the backward reaches a
tensor's gradient (``raster_bwd``: the loss's backward, K3 and the rows'
scatter-add, inside ``backward``).  ``Trainer.run`` reads the last
replay's intervals at each log point, after its reads have waited for the
device (``add_stages``): a stage's into ``events["stage_<stage>_ms"]``, a
nested stage's into ``events["nested_<stage>_ms"]``, outside the stages'
sum.

**Tile lists.**  ``note_tiles(counts, k_tile)`` hands a render's uncapped
per-tile list lengths and its cap to this thread's tile hook
(``tiles_to``), where there is one: ``graphs.GraphedStep`` keeps a graph's
(its capture's tensor, which every replay rewrites) and an eager step's.
At each log point ``Trainer.run`` adds the last step's to ``events``
(``tile_entries``: Σ min(count, k_tile); ``tile_slots``: n_tiles × k_tile;
``tile_samples``: 1), reduced on the device there and read with the
truncation guard's own read: nothing in the step, and no read more.

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
# nested stages: the mark each one's interval starts from
NESTED = {"raster_bwd": "loss"}
# Trainer.run's spans: each adds to events["host_<name>_ms"]
SPANS = ("fetch", "dispatch", "read", "refine", "grow", "reset", "log",
         "ckpt")

_local = threading.local()   # this thread's mark hook and open spans


def new_events() -> dict:
    """``Trainer.events`` at its start: the counts of growths, refines,
    opacity resets and captures; the capture milliseconds; the host's
    reads; the stage and nested-stage milliseconds and their samples; the
    tile lists' entries, slots and samples; the spans' host
    milliseconds."""
    events = {"grow": 0, "refine": 0, "reset_opacity": 0, "capture": 0,
              "capture_ms": 0.0, "host_reads": 0, "stage_samples": 0,
              "tile_entries": 0, "tile_slots": 0, "tile_samples": 0}
    events.update({f"stage_{s}_ms": 0.0 for s in STAGES})
    events.update({f"nested_{s}_ms": 0.0 for s in NESTED})
    events.update({f"host_{s}_ms": 0.0 for s in SPANS})
    return events


def mark(stage: str) -> None:
    """Close ``stage`` of the step's device work: calls this thread's hook
    (``marks_to``), where there is one."""
    hook = getattr(_local, "hook", None)
    if hook is not None:
        hook(stage)


def mark_at_grad(t: torch.Tensor, stage: str) -> None:
    """Close the nested ``stage`` when the backward has computed ``t``'s
    gradient, through this thread's hook, where there is one and ``t``
    takes a gradient.  The hook is looked up now: autograd may run the
    gradient hook on its own device thread, on the stream of ``t``'s
    forward (a capture's stream)."""
    hook = getattr(_local, "hook", None)
    if hook is not None and t.requires_grad:
        t.register_hook(lambda grad: hook(stage))


@contextlib.contextmanager
def _hooked(name: str, hook):
    prev = getattr(_local, name, None)
    setattr(_local, name, hook)
    try:
        yield hook
    finally:
        setattr(_local, name, prev)


def marks_to(hook: Callable[[str], None]):
    """Send this thread's ``mark`` calls to ``hook`` while the block
    runs."""
    return _hooked("hook", hook)


def tiles_to(hook: Callable[[torch.Tensor, int], None]):
    """Send this thread's ``note_tiles`` calls to ``hook`` while the block
    runs."""
    return _hooked("tiles", hook)


def note_tiles(counts: torch.Tensor, k_tile: int) -> None:
    """Hand a render's (n_tiles,) uncapped list lengths and its cap to this
    thread's tile hook (``tiles_to``), where there is one."""
    hook = getattr(_local, "tiles", None)
    if hook is not None:
        hook(counts, k_tile)


class TileLists:
    """The per-tile list lengths and cap of the last render a step noted
    (``note_tiles``): a graph's are its capture's tensor, which each
    replay rewrites."""

    __slots__ = ("counts", "k_tile")

    def __init__(self):
        self.counts, self.k_tile = None, 0

    def __call__(self, counts: torch.Tensor, k_tile: int) -> None:
        self.counts, self.k_tile = counts, k_tile

    def entries(self) -> torch.Tensor:
        """Σ min(count, k_tile), on the device, as an int64 scalar."""
        return torch.clamp(self.counts, max=self.k_tile).sum(
            dtype=torch.int64)


def add_tile_lists(events: dict, lists: TileLists, entries: int) -> None:
    """Add one render's tile lists to ``events``: its ``entries`` (read
    from ``lists.entries()``), its slots and a sample."""
    events["tile_entries"] = events.get("tile_entries", 0) + int(entries)
    events["tile_slots"] = (events.get("tile_slots", 0)
                            + lists.counts.numel() * lists.k_tile)
    events["tile_samples"] = events.get("tile_samples", 0) + 1


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
        name recurs; nested marks split nothing.  The replay must have
        finished."""
        out: dict = {}
        seq = [m for m in self.marks if m[0] not in NESTED]
        for (_, a), (stage, b) in zip(seq, seq[1:]):
            out[stage] = out.get(stage, 0.0) + a.elapsed_time(b)
        return out

    def nested_ms(self) -> dict:
        """Each nested stage's milliseconds in the last replay: from the
        last mark before it of the stage ``NESTED`` names."""
        out: dict = {}
        last: dict = {}
        for stage, ev in self.marks:
            if stage in NESTED:
                a = last.get(NESTED[stage])
                if a is not None:
                    out[stage] = out.get(stage, 0.0) + a.elapsed_time(ev)
            else:
                last[stage] = ev
        return out


def add_stages(events: dict, stage_ms: Optional[dict]) -> None:
    """Add one replay's stage and nested-stage milliseconds to
    ``events``."""
    if not stage_ms:
        return
    for stage, ms in stage_ms.items():
        key = (f"nested_{stage}_ms" if stage in NESTED
               else f"stage_{stage}_ms")
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
