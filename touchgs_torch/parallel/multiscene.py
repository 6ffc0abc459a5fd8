"""Multi-scene batch training on one GPU (port of
``touchgs_tpu/parallel/multiscene.py``).

S scenes train at once: every parameter, Adam-moment and densify leaf gains
a leading scene axis, and the step differentiates the SUM of the scenes'
losses, so each scene trains exactly as if alone.  Adaptive density control
is per scene (``make_multiscene_refine_step``: refine each scene with its
own ``torch.Generator``, then zero that scene's Adam moments at its
rewritten slots).  Capacity is shared across the batch, as in the JAX
package (``multiscene.py:11-18``): a scene that outgrows its share
saturates inside ``refine``, so size ``max_gaussians`` for the largest.

Where the JAX package vmaps ``render`` over the scene axis, Pallas kernels
included (``multiscene.py:109-132``), the port renders all S scenes
through one launch each of K1, K2 and K3 on the tile kernels' path
(``ops.rasterize_cuda.rasterize_cuda_scenes``: the grids concatenated, one
packed table of S·C rows).  Projection, SH, binning and the losses (SSIM
and depth included) run per scene.  The scan path renders scene by scene.
The JAX package also shards the scene axis over a mesh; the port's batch
runs in one process.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from touchgs_torch.config import TrainConfig
from touchgs_torch.data.cameras import Camera
from touchgs_torch.models.densify import (
    DensifyState,
    refine,
    reset_opacities,
    update_stats,
)
from touchgs_torch.models.gaussians import FIELDS, GaussianParams
from touchgs_torch.models.splatfacto import compute_losses, render, shade
from touchgs_torch.ops.rasterize_cuda import rasterize_cuda_scenes
from touchgs_torch.parallel.mesh import named_leaves
from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam
from touchgs_torch.train.trainer import TrainState


def stack_params(params_list: Sequence[GaussianParams]) -> GaussianParams:
    """Per-scene params as one `GaussianParams` with a leading scene axis."""
    return GaussianParams(**{f: torch.stack([getattr(p, f)
                                             for p in params_list])
                             for f in FIELDS})


def scene_params(params: GaussianParams, s: int) -> GaussianParams:
    """Scene ``s`` of stacked params (views, differentiable)."""
    return GaussianParams(**{f: getattr(params, f)[s] for f in FIELDS})


def stack_cameras(cams: Sequence[Camera]) -> Camera:
    """Cameras of one resolution as one `Camera` with (S,) intrinsics and
    an (S, 4, 4) c2w."""
    if len({(c.width, c.height) for c in cams}) != 1:
        raise ValueError("a multi-scene batch wants one resolution")
    return Camera(
        fx=torch.stack([c.fx for c in cams]),
        fy=torch.stack([c.fy for c in cams]),
        cx=torch.stack([c.cx for c in cams]),
        cy=torch.stack([c.cy for c in cams]),
        c2w=torch.stack([c.c2w for c in cams]),
        width=cams[0].width, height=cams[0].height,
    )


def camera_at(cams: Camera, s: int) -> Camera:
    """Camera ``s`` of stacked cameras."""
    return Camera(fx=cams.fx[s], fy=cams.fy[s], cx=cams.cx[s], cy=cams.cy[s],
                  c2w=cams.c2w[s], width=cams.width, height=cams.height)


def make_multiscene_state(params_list: Sequence[GaussianParams],
                          cfg: TrainConfig,
                          optimizer: Optional[FusedAdam] = None
                          ) -> TrainState:
    if optimizer is None:
        optimizer = FusedAdam(cfg.optim)
    params = stack_params(params_list)
    S, C = params.means.shape[:2]
    dev = params.means.device
    return TrainState(
        params=params,
        opt_state=optimizer.init({g: getattr(params, g)
                                  for g in PARAM_GROUPS}),
        densify=DensifyState(*(torch.zeros((S, C), device=dev)
                               for _ in range(3))),
        step=0,
    )


def render_scenes(params: GaussianParams, cameras: Camera, cfg,
                  active_sh_degree: Optional[int] = None,
                  means2d_offsets: Optional[torch.Tensor] = None) -> list:
    """(RenderOutput, ProjectedGaussians) of each scene of stacked
    ``params`` from its camera of stacked ``cameras``; on the tile kernels'
    path all scenes go through one launch of each kernel."""
    S = params.means.shape[0]

    def offset(s):
        return None if means2d_offsets is None else means2d_offsets[s]

    if not cfg.rasterize.use_pallas:
        return [render(scene_params(params, s), camera_at(cameras, s), cfg,
                       active_sh_degree, means2d_offset=offset(s))
                for s in range(S)]
    shaded = [shade(scene_params(params, s), camera_at(cameras, s), cfg,
                    active_sh_degree, means2d_offset=offset(s))
              for s in range(S)]
    projs, colors, opacities, bgs = zip(*shaded)
    outs = rasterize_cuda_scenes(projs, colors, opacities, cameras.width,
                                 cameras.height, cfg.rasterize,
                                 backgrounds=bgs, k_tile=cfg.rasterize.k_tile,
                                 k_chunk=cfg.rasterize.k_chunk)
    return list(zip(outs, projs))


def make_multiscene_train_step(cfg: TrainConfig,
                               optimizer: Optional[FusedAdam] = None
                               ) -> Callable:
    """step(state, cameras, images, depths, uncs, active_sh_degree) over S
    scenes → (state, metrics), ``state`` updated in place.  ``cameras``
    stacked (``stack_cameras`` or ``Cameras.stacked``), ``images`` (S, H,
    W, 3), ``depths`` and ``uncs`` (S, H, W) or None.  Metrics: the mean of
    the scene losses, each scene's loss and PSNR, device tensors."""
    if optimizer is None:
        optimizer = FusedAdam(cfg.optim)

    def step_fn(state: TrainState, cameras: Camera, images, depths, uncs,
                active_sh_degree: int):
        params = state.params
        S, C = params.means.shape[:2]
        diff = {g: getattr(params, g).detach().requires_grad_(True)
                for g in PARAM_GROUPS}
        offsets0 = torch.zeros((S, C, 2), device=params.means.device,
                               requires_grad=True)
        rendered = render_scenes(dataclasses.replace(params, **diff), cameras,
                                 cfg.model, active_sh_degree, offsets0)
        losses = [compute_losses(out, images[s],
                                 None if depths is None else depths[s],
                                 None if uncs is None else uncs[s],
                                 cfg.depth, cfg.ssim_lambda)
                  for s, (out, _) in enumerate(rendered)]
        # SUM, not mean: d(sum)/d(scene s) = d(loss_s), so each scene trains
        # as if alone and the screen-space gradients feeding densify keep
        # their absolute units (grad_threshold is an absolute number)
        total = torch.stack([lo.total for lo in losses]).sum()
        grads = torch.autograd.grad(total, list(diff.values()) + [offsets0])
        optimizer.step({g: getattr(params, g) for g in PARAM_GROUPS},
                       dict(zip(diff, grads[:-1])), state.opt_state)
        radii = torch.stack([p.radii.detach() for _, p in rendered])
        valid = torch.stack([p.valid for _, p in rendered])
        state.densify = update_stats(state.densify, grads[-1], radii, valid,
                                     cameras.width, cameras.height)
        state.step += 1
        metrics = {"loss": total.detach() / S,
                   "loss_per_scene": torch.stack([lo.total.detach()
                                                  for lo in losses]),
                   "psnr_per_scene": torch.stack([lo.psnr.detach()
                                                  for lo in losses])}
        return state, metrics

    return step_fn


def _reset_opt_slots_multiscene(opt_state, touched: torch.Tensor, S: int,
                                C: int) -> None:
    """Zero the Adam moments at (re)written slots, per scene, in place:
    every moment leaf with a leading (S, C) block, masked by the (S, C)
    ``touched``; the shared step counter is left as it is."""
    for moments in (opt_state.mu, opt_state.nu):
        for k, v in moments.items():
            if v.dim() >= 2 and tuple(v.shape[:2]) == (S, C):
                v[touched] = 0.0


def make_multiscene_refine_step(cfg: TrainConfig) -> Callable:
    """refine_fn(state, generators=None, do_densify=True, use_size_cull=True,
    use_screen_size=False, split_noise=None) → state: densify/clone/split/
    prune each scene with its own generator (or the injected (S, k, C, 3)
    ``split_noise``), then the per-scene Adam-moment reset.  The flags are
    the single-scene schedule's, driven from the shared step."""

    def refine_fn(state: TrainState, generators=None, do_densify=True,
                  use_size_cull=True, use_screen_size=False,
                  split_noise=None) -> TrainState:
        S, C = state.params.means.shape[:2]
        outs = [refine(scene_params(state.params, s),
                       DensifyState(*(getattr(state.densify, f.name)[s]
                                      for f in dataclasses.fields(
                                          DensifyState))),
                       cfg.densify, do_densify=do_densify,
                       use_size_cull=use_size_cull,
                       use_screen_size=use_screen_size,
                       split_noise=(None if split_noise is None
                                    else split_noise[s]),
                       generator=None if generators is None else generators[s])
                for s in range(S)]
        params = stack_params([p for p, _, _ in outs])
        densify = DensifyState(*(torch.stack([getattr(d, f.name)
                                              for _, d, _ in outs])
                                 for f in dataclasses.fields(DensifyState)))
        _reset_opt_slots_multiscene(state.opt_state,
                                    torch.stack([t for _, _, t in outs]),
                                    S, C)
        return dataclasses.replace(state, params=params, densify=densify)

    return refine_fn


def make_multiscene_reset_opacity_step(cfg: TrainConfig) -> Callable:
    def reset_fn(state: TrainState) -> TrainState:
        # elementwise: the stacked (S, C) params need no loop
        return dataclasses.replace(state, params=reset_opacities(
            state.params, cfg.densify.reset_opacity_value))

    return reset_fn


def scene_generators(seed: int, S: int, device) -> list:
    """One ``torch.Generator`` a scene, seeded ``seed + s``."""
    gens = []
    for s in range(S):
        g = torch.Generator(device=device)
        g.manual_seed(seed + s)
        gens.append(g)
    return gens


def run_multiscene(
    state: TrainState,
    cfg: TrainConfig,
    step_fn: Callable,
    batch_fn: Callable[[int, np.random.Generator], tuple],
    steps: int,
    refine_fn: Optional[Callable] = None,
    reset_fn: Optional[Callable] = None,
    n_train_views: int = 8,
    log_fn: Optional[Callable[[dict], None]] = None,
    generators: Optional[Sequence[torch.Generator]] = None,
) -> tuple[TrainState, dict]:
    """Drive S scenes through the single-scene schedule of ``Trainer.run``
    (densify warmup, window and pause, the periodic opacity reset): every
    scene refines at the same steps, each with its own generator
    (``scene_generators(cfg.seed, S, ...)`` unless given) and its own
    gradient statistics.  ``batch_fn(step, rng)`` returns the step's
    arguments after the state."""
    if refine_fn is None:
        refine_fn = make_multiscene_refine_step(cfg)
    if reset_fn is None:
        reset_fn = make_multiscene_reset_opacity_step(cfg)
    S = state.params.means.shape[0]
    if generators is None:
        generators = scene_generators(cfg.seed, S, state.params.means.device)
    dcfg = cfg.densify
    rng = np.random.default_rng(cfg.seed)
    metrics = {}
    for step in range(steps):
        state, metrics = step_fn(state, *batch_fn(step, rng))
        if (dcfg.warmup_steps <= step < dcfg.stop_refine_at
                and step % dcfg.refine_every == 0 and step > 0):
            pause = min(n_train_views + dcfg.refine_every,
                        dcfg.reset_opacity_every // 2)
            state = refine_fn(state, generators,
                              (step % dcfg.reset_opacity_every) > pause,
                              step > dcfg.reset_opacity_every,
                              step < dcfg.stop_screen_size_at)
        if (step > 0 and step % dcfg.reset_opacity_every == 0
                and step < dcfg.stop_refine_at):
            state = reset_fn(state)
        if log_fn and (step % cfg.log_every == 0 or step == steps - 1):
            out = {k: v.tolist() for k, v in metrics.items()}
            out["step"] = step
            out["alive_per_scene"] = state.params.alive.sum(dim=-1).tolist()
            log_fn(out)
    return state, metrics


def multiscene_shardings(state: TrainState) -> dict:
    """Each leaf of a multi-scene ``TrainState`` by its dotted name, with
    the mesh axes of its leading axes, as the JAX package places them:
    ``("data", "model")`` for a leading (S, C) block (scene axis over
    ``data``, Gaussians over ``model``), ``("data",)`` for a leading S,
    ``()`` (replicated) for the rest.  A description only: the port's
    batch runs in one process."""
    S, C = state.params.means.shape[:2]

    def spec(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 2 \
                and tuple(x.shape[:2]) == (S, C):
            return ("data", "model")
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == S:
            return ("data",)
        return ()

    return {name: spec(x) for name, x in named_leaves(state)}
