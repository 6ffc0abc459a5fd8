"""The compiled train steps: the port's counterpart of the JAX package's
``jax.jit(step_fn, donate_argnums=(0,))`` (``touchgs_tpu/train/trainer.py:
120``, ``parallel/multiscene.py:157``, ``parallel/sharded.py:102``), a
step captured once as a CUDA graph and replayed.

``GraphedStep`` runs the device work of one training step (``body``: the
render through K1 with rows, K2 and K3, the loss, ``torch.autograd.grad``,
``FusedAdam.step`` and ``update_stats``, and in the mesh steps their
collectives) as a CUDA graph.  ``make_train_step`` (the kernel path, with
or without the SO3xR3 pose optimizer and ``tile_shards``),
``make_sharded_train_step`` and ``make_multiscene_train_step`` (with or
without a mesh) return one:

- **warm-up**: ``WARMUP_ITERS`` calls on a clone of the state, on a side
  stream, so that what PyTorch sets up lazily (cuBLAS's workspace for the
  stream, autograd's device thread, the kernels' modules, NCCL's first
  collective on the stream) happens before the capture; the real state is
  not advanced;
- **capture**: one call of ``body`` on the state itself under
  ``torch.cuda.graph``, which records the work and runs none of it;
- **replay**: each call copies the static inputs (the camera or stacked
  cameras, the image or images, depth and uncertainty, and the pose
  step's view index) into the graph's buffers and replays the graph.  The
  graph reads and writes the state's own tensors in place, as the JAX
  step donates its state.  The metrics it returns are device tensors of
  the graph's, which the next replay overwrites: a caller that keeps one
  clones it.

One graph is kept per static key, all in one memory pool: the active SH
degree (``ops/sh.py`` takes it as a Python int), the static inputs' shapes
and which of them are None, and the state's tensors (data pointers and
shapes).  An SH-degree step, a capacity growth or a checkpoint restore
(new tensors) makes a new key, so the next call warms up and captures
again; refine and the opacity reset write into the state's tensors and
cost no capture.  The pose step's view is a device index in the graph's
buffer, so one graph serves every view, as the JAX step's traced
``view_idx`` does.  The k_tile is fixed per step (``make_train_step``'s
argument): the truncation guard's escalation makes a new step.  Graphs
whose tensors are gone are dropped after the next capture.  ``events
["capture"]`` counts the captures and ``events["capture_ms"]`` adds their
host milliseconds, warm-ups included (``telemetry.timer``), after a wait
for the steps queued before, counted and timed as a read, so that they
leave out the drain of the queue.

Stages: the capture records a timing event at each ``telemetry.mark`` of
the body, a node of the graph (``telemetry.StageEvents``);
``take_stage_ms`` gives the last replay's stage milliseconds once.  Tile
lists: each graph keeps the per-tile list lengths and cap that its
capture noted (``telemetry.TileLists``), tensors its replays rewrite, and
an eager call (a state on the CPU) its own; ``take_tile_lists`` gives the
last call's once.

A capture or replay that fails raises: nothing falls back to the eager
step.  A state on the CPU runs ``__wrapped__``, the plain step, as each
kernel wrapper runs its plain version on CPU tensors (and the mesh steps
their gloo collectives).

Launch counts: a replay runs no Python, so each graph keeps the counts of
its capture and adds them to ``rasterize_cuda.launches`` at every replay;
the warm-ups' launches, real ones on the clone, go to
``rasterize_cuda.launches_warmup``.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable, Optional

import torch

from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.utils import telemetry

WARMUP_ITERS = 3  # eager calls on a clone before a capture


def state_tensors(state) -> list:
    """Every tensor of a ``TrainState`` that the step reads or writes: the
    parameters, Adam's count and moments, the densify statistics and, with
    the pose optimizer, the pose deltas."""
    opt = state.opt_state
    return ([getattr(state.params, f.name)
             for f in dataclasses.fields(state.params)]
            + [opt.count] + [opt.mu[k] for k in sorted(opt.mu)]
            + [opt.nu[k] for k in sorted(opt.nu)]
            + [getattr(state.densify, f.name)
               for f in dataclasses.fields(state.densify)]
            + ([] if state.pose_deltas is None else [state.pose_deltas]))


_CAMERA_FIELDS = ("fx", "fy", "cx", "cy", "c2w")


def _own(x, device):
    """A copy of the static input ``x`` (a tensor, a ``Camera`` or None) on
    ``device``: the graph's buffer for it."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    return dataclasses.replace(x, **{k: _own(getattr(x, k), device)
                                     for k in _CAMERA_FIELDS})


def _copy_in(dst, src) -> None:
    """Copy the static input ``src`` into the graph's buffer ``dst``."""
    if dst is None:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    for k in _CAMERA_FIELDS:
        getattr(dst, k).copy_(getattr(src, k))


def _spec(x):
    """What a graph fixes of the static input ``x``: None, a tensor's shape
    and dtype, a camera's resolution and its fields' shapes."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    return (x.width, x.height) + tuple(tuple(getattr(x, k).shape)
                                       for k in _CAMERA_FIELDS)


class _Graph:
    """One captured step: the graph, its static inputs (a flat tuple of
    cameras, tensors and Nones of the graph's own), its metrics, the
    kernel launches of its capture and its stage events."""

    def __init__(self, inputs: tuple, device):
        self.inputs = tuple(_own(x, device) for x in inputs)
        self.graph = torch.cuda.CUDAGraph()
        self.metrics: dict = {}
        self.launches = dict.fromkeys(rc.launches, 0)
        self.stages = telemetry.StageEvents()
        self.tiles = telemetry.TileLists()

    def replay(self, inputs: tuple) -> None:
        for dst, src in zip(self.inputs, inputs):
            _copy_in(dst, src)
        self.graph.replay()
        rc.add_launches(self.launches)


class GraphedStep:
    """The train step as a CUDA graph (see the module docstring): called
    as the plain step, ``(state, camera, image, depth, unc,
    active_sh_degree, *extra) -> (state, metrics)``; ``__wrapped__`` is
    the plain step.  ``body`` is the plain step's device work, called as
    ``body(state, camera, image, depth, unc, active_sh_degree,
    *view)``; it returns the metrics and leaves ``state.step`` alone.

    The static inputs are the camera (or stacked cameras), the image (or
    the (S, H, W, 3) images), the depth and the uncertainty (or None) and,
    with ``view_input``, the step's first extra argument, the view index,
    as a (1,) int64 tensor (an int is put on the device first); without
    it the extra arguments are the plain step's alone.  A mesh step's
    ``body`` closes over its mesh, so the process groups of the graphs'
    collectives live as long as the step."""

    def __init__(self, step_fn: Callable, body: Callable,
                 events: Optional[dict] = None, view_input: bool = False):
        functools.update_wrapper(self, step_fn)
        self.body = body
        self.events = {} if events is None else events
        self.events.setdefault("capture", 0)
        self.view_input = view_input
        self.graphs: dict = {}
        self.pool = None      # the graphs' shared memory pool
        self._stream = None   # warm-up and capture stream
        self._replayed = None  # the graph replayed last, until read
        self._tiles = None     # the last call's tile lists, until read

    def __call__(self, state, camera, image, depth, unc, active_sh_degree,
                 *extra):
        if state.params.means.device.type != "cuda":
            self._tiles = telemetry.TileLists()
            with telemetry.tiles_to(self._tiles):
                return self.__wrapped__(state, camera, image, depth, unc,
                                        active_sh_degree, *extra)
        inputs = (camera, image, depth, unc)
        if self.view_input:
            inputs += (view_index(extra[0], state.params.means.device),)
        sh = int(active_sh_degree)
        key = (sh, tuple(_spec(x) for x in inputs),
               tuple((t.data_ptr(), tuple(t.shape))
                     for t in state_tensors(state)))
        g = self.graphs.get(key)
        if g is None:
            g = self._capture(key, state, inputs, sh)
        g.replay(inputs)
        self._replayed, self._tiles = g, g.tiles
        state.step += 1
        return state, g.metrics

    def take_stage_ms(self) -> dict:
        """The last replay's milliseconds by stage and nested stage
        (``telemetry.StageEvents.ms``, ``nested_ms``), once; empty where
        nothing replayed since the last call.  The replay must have
        finished."""
        g, self._replayed = self._replayed, None
        return {} if g is None else {**g.stages.ms(), **g.stages.nested_ms()}

    def take_tile_lists(self) -> Optional[telemetry.TileLists]:
        """The last call's tile lists (its graph's, or its eager run's),
        once; None where nothing ran since the last call or the step's
        render noted none."""
        t, self._tiles = self._tiles, None
        return t if t is not None and t.counts is not None else None

    def _run(self, state, inputs: tuple, sh: int) -> dict:
        return self.body(state, *inputs[:4], sh, *inputs[4:])

    def _capture(self, key, state, inputs: tuple, sh: int) -> _Graph:
        """Wait for the steps queued before, then warm up on a clone of
        ``state`` and capture ``body`` on ``state`` itself, its marks as
        the graph's stage events; runs none of the captured work.  The
        wait is a read, the warm-ups and the capture ``capture_ms``.  Then
        drop the graphs whose tensors are gone: after the capture, since a
        pool that no graph holds any more is released and cannot take
        another."""
        ev = self.events
        # the warm-ups' launches would wait behind the queued steps, and
        # the capture waits for them on entry: drained first, they are
        # not the capture's time
        with telemetry.span(ev, "read"):
            telemetry.drain(state.params.means.device)
        with telemetry.timer(ev, "capture_ms", "capture"):
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream()
            s = self._stream
            g = _Graph(inputs, state.params.means.device)
            s.wait_stream(torch.cuda.current_stream())
            # the warm-ups also run the step's collectives on the capture
            # stream before the capture, as NCCL wants
            with torch.cuda.stream(s), rc.launches_on(s, rc.launches_warmup):
                warm = copy.deepcopy(state)
                for _ in range(WARMUP_ITERS):
                    self._run(warm, g.inputs, sh)
                del warm
            torch.cuda.current_stream().wait_stream(s)
            # "thread_local": a live viewer renders (and syncs) on its own
            # thread while the trainer captures
            with rc.launches_on(s, g.launches), torch.cuda.graph(
                    g.graph, pool=self.pool, stream=s,
                    capture_error_mode="thread_local"), \
                    telemetry.marks_to(g.stages), \
                    telemetry.tiles_to(g.tiles):
                g.metrics = self._run(state, g.inputs, sh)
        for k in [k for k in self.graphs if k[-1] != key[-1]]:
            del self.graphs[k]
        self.graphs[key] = g
        ev["capture"] += 1
        return g


def view_index(view_idx, device) -> torch.Tensor:
    """``view_idx`` as a (1,) int64 tensor on ``device``: the pose step's
    view, which a graph takes as a static input.  A tensor is taken as it
    is; an int is filled in on the device (no copy from the host)."""
    if isinstance(view_idx, torch.Tensor):
        return view_idx.reshape(1)
    return torch.full((1,), int(view_idx), dtype=torch.int64, device=device)
