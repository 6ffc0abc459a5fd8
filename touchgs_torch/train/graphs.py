"""The compiled train step: the port's counterpart of the JAX package's
``jax.jit(step_fn, donate_argnums=(0,))`` (``touchgs_tpu/train/trainer.py:
120``), a step captured once as a CUDA graph and replayed.

``GraphedStep`` runs the device work of one training step (``body``: the
render through K1 with rows, K2 and K3, the loss, ``torch.autograd.grad``,
``FusedAdam.step`` and ``update_stats``) as a CUDA graph:

- **warm-up**: ``WARMUP_ITERS`` calls on a clone of the state, on a side
  stream, so that what PyTorch sets up lazily (cuBLAS's workspace for the
  stream, autograd's device thread, the kernels' modules) happens before
  the capture; the real state is not advanced;
- **capture**: one call of ``body`` on the state itself under
  ``torch.cuda.graph``, which records the work and runs none of it;
- **replay**: each call copies the camera, image, depth and uncertainty
  into the graph's static buffers and replays the graph.  The graph reads
  and writes the state's own tensors in place, as the JAX step donates its
  state.  The metrics it returns are device tensors of the graph's, which
  the next replay overwrites: a caller that keeps one clones it.

One graph is kept per static key, all in one memory pool: the active SH
degree (``ops/sh.py`` takes it as a Python int), the image size, which of
depth and uncertainty are given, and the state's tensors (data pointers and
shapes).  An SH-degree step, a capacity growth or a checkpoint restore
(new tensors) makes a new key, so the next call warms up and captures
again; refine and the opacity reset write into the state's tensors and cost
no capture.  The k_tile is fixed per step (``make_train_step``'s
argument): the truncation guard's escalation makes a new step.  Graphs
whose tensors are gone are dropped after the next capture.  ``events
["capture"]`` counts the captures.

A capture or replay that fails raises: nothing falls back to the eager
step.  A state on the CPU runs ``__wrapped__``, the plain step, as each
kernel wrapper runs its plain version on CPU tensors.

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

WARMUP_ITERS = 3  # eager calls on a clone before a capture


def state_tensors(state) -> list:
    """Every tensor of a ``TrainState`` that the step reads or writes: the
    parameters, Adam's count and moments, the densify statistics."""
    opt = state.opt_state
    return ([getattr(state.params, f.name)
             for f in dataclasses.fields(state.params)]
            + [opt.count] + [opt.mu[k] for k in sorted(opt.mu)]
            + [opt.nu[k] for k in sorted(opt.nu)]
            + [getattr(state.densify, f.name)
               for f in dataclasses.fields(state.densify)])


class _Graph:
    """One captured step: the graph, its static inputs (a camera, image,
    depth and uncertainty of the graph's own), its metrics and the kernel
    launches of its capture."""

    def __init__(self, camera, image, depth, unc, device):
        def own(t):
            return None if t is None else t.to(device, copy=True)

        self.camera = dataclasses.replace(
            camera, **{k: own(getattr(camera, k))
                       for k in ("fx", "fy", "cx", "cy", "c2w")})
        self.image, self.depth, self.unc = own(image), own(depth), own(unc)
        self.graph = torch.cuda.CUDAGraph()
        self.metrics: dict = {}
        self.launches = dict.fromkeys(rc.launches, 0)

    def inputs(self) -> tuple:
        return self.camera, self.image, self.depth, self.unc

    def replay(self, camera, image, depth, unc) -> None:
        for k in ("fx", "fy", "cx", "cy", "c2w"):
            getattr(self.camera, k).copy_(getattr(camera, k))
        for dst, src in ((self.image, image), (self.depth, depth),
                         (self.unc, unc)):
            if dst is not None:
                dst.copy_(src)
        self.graph.replay()
        rc.add_launches(self.launches)


class GraphedStep:
    """The train step as a CUDA graph (see the module docstring): called
    as the plain step, ``(state, camera, image, depth, unc,
    active_sh_degree[, view_idx]) -> (state, metrics)``; ``__wrapped__`` is
    the plain step.  ``body`` is the plain step's device work, which
    returns the metrics and leaves ``state.step`` alone."""

    def __init__(self, step_fn: Callable, body: Callable,
                 events: Optional[dict] = None):
        functools.update_wrapper(self, step_fn)
        self.body = body
        self.events = {} if events is None else events
        self.events.setdefault("capture", 0)
        self.graphs: dict = {}
        self.pool = None      # the graphs' shared memory pool
        self._stream = None   # warm-up and capture stream

    def __call__(self, state, camera, image, depth, unc, active_sh_degree,
                 view_idx=None):
        if state.params.means.device.type != "cuda":
            return self.__wrapped__(state, camera, image, depth, unc,
                                    active_sh_degree, view_idx)
        sh = int(active_sh_degree)
        key = (sh, camera.width, camera.height, depth is None, unc is None,
               tuple((t.data_ptr(), tuple(t.shape))
                     for t in state_tensors(state)))
        g = self.graphs.get(key)
        if g is None:
            g = self._capture(key, state, camera, image, depth, unc, sh)
        g.replay(camera, image, depth, unc)
        state.step += 1
        return state, g.metrics

    def _capture(self, key, state, camera, image, depth, unc,
                 sh: int) -> _Graph:
        """Warm up on a clone of ``state``, then capture ``body`` on
        ``state`` itself; runs none of the captured work.  Then drop the
        graphs whose tensors are gone: after the capture, since a pool
        that no graph holds any more is released and cannot take
        another."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream()
        s = self._stream
        g = _Graph(camera, image, depth, unc, state.params.means.device)
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s), rc.launches_on(s, rc.launches_warmup):
            warm = copy.deepcopy(state)
            for _ in range(WARMUP_ITERS):
                self.body(warm, *g.inputs(), sh)
            del warm
        torch.cuda.current_stream().wait_stream(s)
        # "thread_local": a live viewer renders (and syncs) on its own
        # thread while the trainer captures
        with rc.launches_on(s, g.launches), torch.cuda.graph(
                g.graph, pool=self.pool, stream=s,
                capture_error_mode="thread_local"):
            g.metrics = self.body(state, *g.inputs(), sh)
        for k in [k for k in self.graphs if k[-1] != key[-1]]:
            del self.graphs[k]
        self.graphs[key] = g
        self.events["capture"] += 1
        return g
