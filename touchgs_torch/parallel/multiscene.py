"""Multi-scene batch training, on one GPU or over a (data, model) mesh of
ranks (port of ``touchgs_tpu/parallel/multiscene.py``).

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

With a ``mesh`` (``parallel.mesh.Mesh``) the scene axis goes on ``data``
and each scene's Gaussian capacity on ``model``, as the JAX package places
them (``multiscene_shardings``), with the collectives written out.  Rank
(d, m) of a Dd × Dm mesh holds scenes ``[d·S/Dd, (d+1)·S/Dd)`` and, of
each, rows ``[m·C/Dm, (m+1)·C/Dm)`` of every (S, C) leaf
(``shard_multiscene_state``).  Every rank is called with the whole batch
of S scenes and takes its own.  Per step, on each rank:

1. projection and SH run on its rows of its scenes;
2. the scenes' packed attribute table and binning inputs are gathered
   over the ``model`` ranks (the table's backward reduce-scatters), and
   binning is replicated across them;
3. its slice of the ``model`` group's packed grid goes through one launch
   each of K1 (with the slice's ``tile0``), K2 and K3, and the slices are
   gathered, so every ``model`` rank holds its scenes' images whole;
4. every ``model`` rank computes the same per-scene losses and
   differentiates their sum; fused Adam and the densify statistics run on
   its rows;
5. the per-scene losses and PSNRs are gathered over the ``data`` ranks:
   every rank returns the same metrics.

Refine gathers a scene's rows over ``model`` and refines the whole scene
on every ``model`` rank alike (the scene's own generator, or the injected
noise, by its index in the whole batch); each rank keeps its rows.  The
opacity reset is elementwise on the rank's rows.  ``S % data`` and
``C % model`` must be 0, as a JAX ``NamedSharding`` wants.

On the card the step runs as a CUDA graph (``train/graphs.py``), the
counterpart of the JAX package's jitted, donated multi-scene step
(``multiscene.py:157``), its collectives captured inside it.  Refine and
the opacity reset write their results into the state's own tensors and
return that state, as ``trainer.refine_state`` does, so they cost no
capture.
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
from touchgs_torch.parallel.mesh import Mesh, _all_gather, named_leaves
from touchgs_torch.parallel.sharded import map_state
from touchgs_torch.train.graphs import GraphedStep
from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam
from touchgs_torch.train.trainer import TrainState, assign_fields


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


def _first_scene(mesh: Optional[Mesh], n_local: int, n_batch: int) -> int:
    """The batch index of this rank's first scene, for a state holding
    ``n_local`` scenes and a batch of ``n_batch``; raises ValueError when
    they do not fit the mesh."""
    data, d = (1, 0) if mesh is None else (mesh.data, mesh.coords[0])
    if n_batch != n_local * data:
        raise ValueError(f"a batch of {n_batch} scenes for a state of "
                         f"{n_local} scenes on {data} data ranks")
    return d * n_local


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
                  means2d_offsets: Optional[torch.Tensor] = None,
                  mesh: Optional[Mesh] = None) -> list:
    """(RenderOutput, ProjectedGaussians) of each scene of stacked
    ``params`` from its camera of stacked ``cameras``; on the tile kernels'
    path all scenes go through one launch of each kernel.  With a ``mesh``,
    ``params`` (and ``means2d_offsets``) are this rank's share of a state
    that ``shard_multiscene_state`` placed, ``cameras`` the whole batch's:
    it renders this rank's scenes, whole images, and each projection is
    this rank's rows."""
    S = params.means.shape[0]
    first = _first_scene(mesh, S, cameras.fx.shape[0])
    model = None if mesh is None else mesh.axis("model")

    def offset(s):
        return None if means2d_offsets is None else means2d_offsets[s]

    if not cfg.rasterize.use_pallas:
        return [render(scene_params(params, s),
                       camera_at(cameras, first + s), cfg, active_sh_degree,
                       means2d_offset=offset(s), mesh=model)
                for s in range(S)]
    shaded = [shade(scene_params(params, s), camera_at(cameras, first + s),
                    cfg, active_sh_degree, means2d_offset=offset(s))
              for s in range(S)]
    projs, colors, opacities, bgs = zip(*shaded)
    outs = rasterize_cuda_scenes(projs, colors, opacities, cameras.width,
                                 cameras.height, cfg.rasterize,
                                 backgrounds=bgs, k_tile=cfg.rasterize.k_tile,
                                 k_chunk=cfg.rasterize.k_chunk, mesh=model)
    return list(zip(outs, projs))


def _gather_data(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every ``data`` rank's ``x`` (its scenes' values), in scene order."""
    return x if mesh is None else _all_gather(x, mesh.axis("data"))


def make_multiscene_train_step(cfg: TrainConfig,
                               optimizer: Optional[FusedAdam] = None,
                               mesh: Optional[Mesh] = None) -> Callable:
    """step(state, cameras, images, depths, uncs, active_sh_degree) over S
    scenes → (state, metrics), ``state`` updated in place.  ``cameras``
    stacked (``stack_cameras`` or ``Cameras.stacked``), ``images`` (S, H,
    W, 3), ``depths`` and ``uncs`` (S, H, W) or None.  Metrics: the mean of
    the scene losses, each scene's loss and PSNR, device tensors.

    With a ``mesh`` the state is this rank's share
    (``shard_multiscene_state``), the batch the whole one on every rank,
    and every rank returns the metrics of all S scenes.  A mesh of more
    than one rank needs a process group.

    The step is a ``graphs.GraphedStep``: a CUDA graph on a state on the
    card (with a mesh, its gathers captured in it and the mesh's groups
    held as long as its graphs), the plain step on the CPU; captures count
    in its ``events["capture"]``."""
    if optimizer is None:
        optimizer = FusedAdam(cfg.optim)
    if mesh is not None:
        mesh.check_group()

    def body(state: TrainState, cameras: Camera, images, depths, uncs,
             active_sh_degree: int) -> dict:
        params = state.params
        S, C = params.means.shape[:2]
        first = _first_scene(mesh, S, cameras.fx.shape[0])
        mine = slice(first, first + S)
        diff = {g: getattr(params, g).detach().requires_grad_(True)
                for g in PARAM_GROUPS}
        offsets0 = torch.zeros((S, C, 2), device=params.means.device,
                               requires_grad=True)
        rendered = render_scenes(dataclasses.replace(params, **diff), cameras,
                                 cfg.model, active_sh_degree, offsets0, mesh)
        images, depths, uncs = (None if a is None else a[mine]
                                for a in (images, depths, uncs))
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
        update_stats(state.densify, grads[-1], radii, valid, cameras.width,
                     cameras.height)
        per_scene = _gather_data(torch.stack([lo.total.detach()
                                              for lo in losses]), mesh)
        return {"loss": per_scene.sum() / per_scene.shape[0],
                "loss_per_scene": per_scene,
                "psnr_per_scene": _gather_data(
                    torch.stack([lo.psnr.detach() for lo in losses]), mesh)}

    def step_fn(state: TrainState, cameras: Camera, images, depths, uncs,
                active_sh_degree: int):
        metrics = body(state, cameras, images, depths, uncs,
                       active_sh_degree)
        state.step += 1
        return state, metrics

    return GraphedStep(step_fn, body)


def _reset_opt_slots_multiscene(opt_state, touched: torch.Tensor, S: int,
                                C: int) -> None:
    """Zero the Adam moments at (re)written slots, per scene, in place:
    every moment leaf with a leading (S, C) block, masked by the (S, C)
    ``touched``; the shared step counter is left as it is."""
    for moments in (opt_state.mu, opt_state.nu):
        for k, v in moments.items():
            if v.dim() >= 2 and tuple(v.shape[:2]) == (S, C):
                v[touched] = 0.0


def make_multiscene_refine_step(cfg: TrainConfig,
                                mesh: Optional[Mesh] = None) -> Callable:
    """refine_fn(state, generators=None, do_densify=True, use_size_cull=True,
    use_screen_size=False, split_noise=None) → state: densify/clone/split/
    prune each scene with its own generator (or the injected (S, k, C, 3)
    ``split_noise``), then the per-scene Adam-moment reset.  The flags are
    the single-scene schedule's, driven from the shared step.  The results
    are written into ``state``'s tensors, which it returns (the JAX
    package's refine donates its state): a graphed step goes on replaying.

    With a ``mesh`` the state is this rank's share: each of its scenes is
    gathered whole over the ``model`` ranks and refined alike on each,
    ``generators`` and ``split_noise`` being the whole batch's (indexed by
    the scene's place in it); the rank keeps its rows and zeroes the
    moments at its rewritten slots."""
    if mesh is not None:
        mesh.check_group()
    model = None if mesh is None else mesh.axis("model")

    def whole(x):  # this rank's scenes' (S, c, ...) rows → (S, C, ...)
        return x if model is None else model.gather_scene_rows(x)

    def refine_fn(state: TrainState, generators=None, do_densify=True,
                  use_size_cull=True, use_screen_size=False,
                  split_noise=None) -> TrainState:
        S, c = state.params.means.shape[:2]
        first = 0 if mesh is None else mesh.coords[0] * S
        params = GaussianParams(**{f: whole(getattr(state.params, f))
                                   for f in FIELDS})
        stats = DensifyState(*(whole(getattr(state.densify, f.name))
                               for f in dataclasses.fields(DensifyState)))
        outs = [refine(scene_params(params, s),
                       DensifyState(*(getattr(stats, f.name)[s]
                                      for f in dataclasses.fields(
                                          DensifyState))),
                       cfg.densify, do_densify=do_densify,
                       use_size_cull=use_size_cull,
                       use_screen_size=use_screen_size,
                       split_noise=(None if split_noise is None
                                    else split_noise[first + s]),
                       generator=(None if generators is None
                                  else generators[first + s]))
                for s in range(S)]
        mine = slice(None) if model is None else \
            slice(model.rank * c, (model.rank + 1) * c)
        params = stack_params([GaussianParams(**{
            f: getattr(p, f)[mine] for f in FIELDS}) for p, _, _ in outs])
        densify = DensifyState(*(torch.stack([getattr(d, f.name)[mine]
                                              for _, d, _ in outs])
                                 for f in dataclasses.fields(DensifyState)))
        _reset_opt_slots_multiscene(state.opt_state,
                                    torch.stack([t[mine] for _, _, t in outs]),
                                    S, c)
        assign_fields(state.params, params)
        assign_fields(state.densify, densify)
        return state

    return refine_fn


def make_multiscene_reset_opacity_step(cfg: TrainConfig) -> Callable:
    """reset_fn(state) → state: the opacity reset, written into ``state``'s
    opacities (as the refine), which it returns."""
    def reset_fn(state: TrainState) -> TrainState:
        # elementwise: the stacked (S, C) params need no loop
        state.params.logit_opacities.copy_(reset_opacities(
            state.params, cfg.densify.reset_opacity_value).logit_opacities)
        return state

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
    mesh: Optional[Mesh] = None,
) -> tuple[TrainState, dict]:
    """Drive S scenes through the single-scene schedule of ``Trainer.run``
    (densify warmup, window and pause, the periodic opacity reset): every
    scene refines at the same steps, each with its own generator
    (``scene_generators(cfg.seed, S, ...)`` unless given) and its own
    gradient statistics.  ``batch_fn(step, rng)`` returns the step's
    arguments after the state.  With a ``mesh``, ``state`` is this rank's
    share, ``step_fn`` made with the same mesh, S the whole batch's count,
    and the default refine is the mesh's; every rank of the mesh must call
    it, ``log_fn`` given on any of them."""
    if refine_fn is None:
        refine_fn = make_multiscene_refine_step(cfg, mesh)
    if reset_fn is None:
        reset_fn = make_multiscene_reset_opacity_step(cfg)
    S = state.params.means.shape[0] * (1 if mesh is None else mesh.data)
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
        # on a mesh every rank counts at the log steps, with or without a
        # log_fn: the count gathers over the mesh's groups
        if (log_fn or mesh is not None) and (step % cfg.log_every == 0
                                             or step == steps - 1):
            alive = alive_per_scene(state, mesh)
            if log_fn:
                out = {k: v.tolist() for k, v in metrics.items()}
                out["step"] = step
                out["alive_per_scene"] = alive.tolist()
                log_fn(out)
    return state, metrics


def alive_per_scene(state: TrainState, mesh: Optional[Mesh] = None
                    ) -> torch.Tensor:
    """(S,) live Gaussians of each scene of the batch; with a ``mesh``,
    summed over the ``model`` ranks and gathered over the ``data`` ranks
    from this rank's share."""
    n = state.params.alive.sum(dim=-1)
    if mesh is None:
        return n
    model = mesh.axis("model")
    n = _all_gather(n, model).reshape(model.size, -1).sum(dim=0)
    return _gather_data(n, mesh)


def _scene_specs(state: TrainState) -> dict:
    S, C = state.params.means.shape[:2]

    def spec(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 2 \
                and tuple(x.shape[:2]) == (S, C):
            return ("data", "model")
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == S:
            return ("data",)
        return ()

    return {name: spec(x) for name, x in named_leaves(state)}


def multiscene_shardings(mesh: Mesh, state: TrainState) -> dict:
    """Each leaf of a multi-scene ``TrainState`` by its dotted name, with
    the mesh axes of its leading axes, as the JAX package places them:
    ``("data", "model")`` for a leading (S, C) block (scene axis over
    ``data``, Gaussians over ``model``), ``("data",)`` for a leading S,
    ``()`` (shared) for the rest.  ``shard_multiscene_state`` places a
    state so; raises ValueError when ``mesh`` cannot split it evenly."""
    S, C = state.params.means.shape[:2]
    if S % mesh.data or C % mesh.model:
        raise ValueError(f"{S} scenes of capacity {C} on a mesh of "
                         f"data={mesh.data}, model={mesh.model}: want "
                         f"S % data == 0 and C % model == 0")
    return _scene_specs(state)


def shard_multiscene_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's share of a whole multi-scene ``TrainState``, placed as
    ``multiscene_shardings`` says: of a leading (S, C) block the rows
    ``[m·C/Dm, (m+1)·C/Dm)`` of the scenes ``[d·S/Dd, (d+1)·S/Dd)`` at
    mesh coordinates (d, m), of a leading S those scenes; every other leaf
    copied (the counterpart of ``jax.device_put(state,
    multiscene_shardings(mesh, state))``)."""
    specs = multiscene_shardings(mesh, state)
    S, C = state.params.means.shape[:2]
    s, c = S // mesh.data, C // mesh.model
    d, m = mesh.coords
    scenes, rows = slice(d * s, (d + 1) * s), slice(m * c, (m + 1) * c)

    def place(name, x):
        spec = specs[name]
        if spec == ("data", "model"):
            x = x[scenes, rows]
        elif spec == ("data",):
            x = x[scenes]
        return x.clone()

    return map_state(state, place)


def gather_multiscene_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The whole multi-scene ``TrainState`` from every rank's share
    (``shard_multiscene_state``'s inverse), on every rank."""
    specs = _scene_specs(state)
    model = mesh.axis("model")

    def gather(name, x):
        spec = specs[name]
        if spec == ("data", "model"):
            return _gather_data(model.gather_scene_rows(x), mesh)
        if spec == ("data",):
            return _gather_data(x, mesh)
        return x.clone()

    with torch.no_grad():
        return map_state(state, gather)
