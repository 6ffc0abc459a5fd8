"""The training step over a (data, model) mesh of ranks (port of
``touchgs_tpu/parallel/sharded.py``).

The JAX package's explicit reduce-scatter design (``sharded.py:1-22``),
with the collectives written out on ``torch.distributed``:

1. Gaussian parameters, Adam moments and densify statistics are split by
   rows over every rank (``mesh.shard_rows``); the fused Adam runs on this
   rank's rows.
2. Projection and SH run on this rank's rows.
3. The packed attribute table is all-gathered; its backward is a
   reduce-scatter, each rank receiving the summed gradient of its rows.
   Binning is replicated: every rank bins all the Gaussians.
4. The tile grid is split: each rank composites its contiguous slice
   (K1 with the slice's ``tile0``, K2 and K3 with its grid tile ids) and
   the slices are all-gathered.
5. Every rank computes the same loss on the whole image (SSIM's window
   crosses slices); the tiles' gather hands each rank its own slice of the
   cotangent in the backward.

Every rank calls the step with the same camera and images.  A world of one
(one GPU under NCCL, or no process group) runs the same code.  On the card
the step runs as a CUDA graph (``train/graphs.py``, the JAX package's "one
jitted SPMD program per train step", ``sharded.py:3``) with its NCCL
collectives captured inside it; on the CPU (gloo) it runs the plain step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from touchgs_torch.config import TrainConfig
from touchgs_torch.data.cameras import Camera
from touchgs_torch.models.densify import DensifyState, update_stats
from touchgs_torch.models.gaussians import GaussianParams
from touchgs_torch.models.splatfacto import compute_losses, render
from touchgs_torch.parallel.mesh import (Mesh, _all_gather, shard_rows,
                                         state_shardings)
from touchgs_torch.train.graphs import GraphedStep
from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam, FusedAdamState
from touchgs_torch.train.trainer import TrainState


def _all_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a copy without a process group)."""
    x = x.clone()
    if mesh.group is not None:
        torch.distributed.all_reduce(x, group=mesh.group)
    return x


def make_sharded_train_step(cfg: TrainConfig, mesh: Mesh,
                            optimizer: Optional[FusedAdam] = None
                            ) -> Callable:
    """Returns step(state, camera, image, depth, unc, active_sh_degree) →
    (state, metrics) for a ``state`` that ``shard_state`` placed; the
    state is updated in place.  Metrics are device scalars over the whole
    image and every rank's Gaussians.  The step is a
    ``graphs.GraphedStep``: a CUDA graph on a state on the card (the
    gathers, reduce-scatters and sums captured in it, the mesh's groups
    held as long as its graphs), the plain step on the CPU; captures
    count in its ``events["capture"]``."""
    if optimizer is None:
        optimizer = FusedAdam(cfg.optim)

    def body(state: TrainState, camera: Camera, image, depth, unc,
             active_sh_degree: int) -> dict:
        params = state.params
        diff = {g: getattr(params, g).detach().requires_grad_(True)
                for g in PARAM_GROUPS}
        offset0 = torch.zeros((params.capacity, 2),
                              device=params.means.device, requires_grad=True)
        out, proj = render(
            dataclasses.replace(params, **diff), camera, cfg.model,
            active_sh_degree=active_sh_degree, means2d_offset=offset0,
            tile_shards=mesh.size, mesh=mesh)
        losses = compute_losses(out, image, depth, unc, cfg.depth,
                                cfg.ssim_lambda)
        grads = torch.autograd.grad(losses.total,
                                    list(diff.values()) + [offset0])
        optimizer.step({g: getattr(params, g) for g in PARAM_GROUPS},
                       dict(zip(diff, grads[:-1])), state.opt_state)
        update_stats(state.densify, grads[-1], proj.radii.detach(),
                     proj.valid, camera.width, camera.height)
        return {
            "loss": losses.total.detach(), "psnr": losses.psnr.detach(),
            "depth_loss": losses.depth_loss.detach(),
            "num_alive": _all_sum(params.num_alive, mesh),
        }

    def step_fn(state: TrainState, camera: Camera, image, depth, unc,
                active_sh_degree: int):
        metrics = body(state, camera, image, depth, unc, active_sh_degree)
        state.step += 1
        return state, metrics

    return GraphedStep(step_fn, body)


def map_state(state: TrainState, fn) -> TrainState:
    """``state`` with each tensor leaf ``x`` of its parameters, Adam state
    and densify statistics replaced by ``fn(dotted name, x)`` (the names of
    ``mesh.named_leaves``); the step and the pose deltas are kept."""
    p = state.params
    opt = state.opt_state
    return TrainState(
        params=GaussianParams(**{k.name: fn(f"params.{k.name}",
                                            getattr(p, k.name))
                                 for k in dataclasses.fields(p)}),
        opt_state=FusedAdamState(
            count=fn("opt_state.count", opt.count),
            mu={k: fn(f"opt_state.mu.{k}", v) for k, v in opt.mu.items()},
            nu={k: fn(f"opt_state.nu.{k}", v) for k, v in opt.nu.items()}),
        densify=DensifyState(*(fn(f"densify.{k.name}",
                                  getattr(state.densify, k.name))
                               for k in dataclasses.fields(DensifyState))),
        step=state.step, pose_deltas=state.pose_deltas)


def _map_rows(state: TrainState, fn) -> TrainState:
    """``state`` with ``fn`` applied to every leaf whose leading axis is
    the capacity (``state_shardings``), the other leaves shared."""
    rows = {k for k, v in state_shardings(state).items() if v}
    return map_state(state, lambda name, x: fn(x) if name in rows else x)


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's share of a whole ``TrainState``: its rows of every leaf
    whose leading axis is the capacity, the rest shared.  The capacity must
    be a multiple of the world."""
    if state.params.capacity % mesh.size:
        raise ValueError(f"capacity {state.params.capacity} is not a "
                         f"multiple of the {mesh.size} ranks")
    return _map_rows(state, lambda x: shard_rows(x, mesh))


def gather_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The whole ``TrainState`` from every rank's share (``shard_state``'s
    inverse), on every rank."""
    return _map_rows(state, lambda x: _all_gather(x, mesh))
