"""Training loop for depth-supervised Gaussian splatting (port of
``touchgs_tpu/train/trainer.py``).

Per step: render one training view, photometric + depth loss, per-group
Adam, densify bookkeeping; periodic refine, opacity reset and capacity
growth; checkpoints through ``train/checkpoint.py``; with
``cfg.pose_opt.mode == "SO3xR3"`` per-camera pose deltas optimized with the
model (``models/pose_opt.py``).  Parameters, Adam moments and densify
statistics are updated in place where the JAX package returns new arrays,
through the step, refine and the opacity reset alike.  On CUDA the kernel
path's step, with or without the pose optimizer and ``tile_shards``, runs
as a CUDA graph (``train/graphs.py``), the counterpart of the JAX
package's jitted, donated step.  ``run(viewer=...)`` publishes
the status and a clone of the parameters to a live ``viewer.ViewerServer``
at each log point.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from touchgs_torch.config import TrainConfig
from touchgs_torch.data.cameras import Camera
from touchgs_torch.data.scene import Scene
from touchgs_torch.models.densify import (
    DensifyState,
    refine,
    reset_opacities,
    update_stats,
)
from touchgs_torch.models.gaussians import (
    GaussianParams,
    init_from_points,
    init_random,
    params_from_numpy,
)
from touchgs_torch.models.pose_opt import apply_pose_delta
from touchgs_torch.models.splatfacto import compute_losses, render
from touchgs_torch.train.graphs import GraphedStep, view_index
from touchgs_torch.train.optim import (
    PARAM_GROUPS,
    FusedAdam,
    FusedAdamState,
    reset_opt_slots,
)
from touchgs_torch.utils import telemetry


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    opt_state: FusedAdamState
    densify: DensifyState
    step: int
    # (n_cameras, 6) SO3xR3 tangents when cfg.pose_opt.mode != "off"
    # (legacy/config_tactile.py:36-37), else None
    pose_deltas: Optional[torch.Tensor] = None


def state_from_numpy(leaves: dict, device: torch.device | str = "cuda"
                     ) -> TrainState:
    """Build a `TrainState` from numpy leaves laid out as the JAX
    package's ``TrainState``: ``{"params": {field: array}, "count": int,
    "mu": {group: array}, "nu": {group: array}, "densify": {field: array},
    "step": int}`` and, with the pose optimizer, ``"pose_deltas"``."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    return TrainState(
        params=params_from_numpy(leaves["params"], device),
        opt_state=FusedAdamState(
            count=torch.tensor(int(leaves["count"]), dtype=torch.int32,
                               device=device),
            mu={k: t(v) for k, v in leaves["mu"].items()},
            nu={k: t(v) for k, v in leaves["nu"].items()},
        ),
        densify=DensifyState(**{k: t(v) for k, v in leaves["densify"].items()}),
        step=int(leaves["step"]),
        pose_deltas=(None if leaves.get("pose_deltas") is None
                     else t(leaves["pose_deltas"])),
    )


def _finite_dead_slots(gauss: dict, alive: torch.Tensor) -> dict:
    """The Gaussian groups with every dead slot set to a finite constant
    (an identity quaternion, zeros elsewhere), for the pose optimizer's
    step.  Dead slots turn NaN after the first step (the quaternion norm's
    gradient at 0, in both packages); they render nothing, but the camera's
    gradient sums every slot's projection Jacobian, and 0·NaN would make it
    NaN.  ``torch.where`` passes the live slots' values and gradients
    unchanged (ROADMAP.md C21).  Device ops only: the graphed pose step
    takes it."""
    out = {}
    for g, x in gauss.items():
        fill = torch.zeros_like(x)
        if g == "quats":
            fill[:, 0].fill_(1.0)   # a fill, not a scalar from the host
        out[g] = torch.where(alive.view((-1,) + (1,) * (x.dim() - 1)), x,
                             fill)
    return out


def make_train_step(cfg: TrainConfig, optimizer: FusedAdam,
                    k_tile: Optional[int] = None,
                    tile_shards: int = 0,
                    events: Optional[dict] = None) -> Callable:
    """The train step: (state, camera, image, depth, unc, active_sh_degree
    [, view_idx]) → (state, metrics), updating ``state`` in place.
    ``view_idx`` selects the camera's row of ``state.pose_deltas`` when the
    SO3xR3 pose optimizer is on (cfg.pose_opt.mode): a (1,) int64 tensor
    on the state's device (``Trainer.view_index``) or an int.  Metrics are
    device scalars, so the step never waits for the device.  ``k_tile``
    overrides the config's per-tile entry cap; ``tile_shards`` composites
    the tile grid in that many slices (``render``).

    The kernel path (``cfg.model.rasterize.use_pallas``), with or without
    the pose optimizer and ``tile_shards``, returns a
    ``graphs.GraphedStep``: on a state on CUDA it runs as a CUDA graph (the
    pose step's view index one of its inputs, so one graph serves every
    view), on the CPU as the plain step, its ``__wrapped__``; it counts its
    captures in ``events["capture"]``.  The scan path (its checkpointed
    chunks) returns the plain step, which runs eagerly."""
    pose_on = cfg.pose_opt.mode != "off"

    def body(state: TrainState, camera: Camera, image, depth, unc,
             active_sh_degree: int, view_idx=None) -> dict:
        """The step's device work; returns the metrics.  Its marks close
        the stages that ``telemetry.STAGES`` names (``render`` marks
        shade, bin and composite)."""
        telemetry.mark("start")
        params = state.params
        C = params.capacity
        diff = {g: getattr(params, g).detach().requires_grad_(True)
                for g in PARAM_GROUPS}
        targets = {g: getattr(params, g) for g in PARAM_GROUPS}
        gauss = dict(diff)
        cam = camera
        if pose_on:
            diff["pose_deltas"] = state.pose_deltas.detach().requires_grad_(
                True)
            targets["pose_deltas"] = state.pose_deltas
            # the view's row by a device index: no host read, and one
            # captured graph serves every view
            idx = view_index(view_idx, params.means.device)
            cam = apply_pose_delta(
                camera, diff["pose_deltas"].index_select(0, idx)[0])
            gauss = _finite_dead_slots(gauss, params.alive)
        offset0 = torch.zeros((C, 2), device=params.means.device,
                              requires_grad=True)
        out, proj = render(
            dataclasses.replace(params, **gauss),
            cam, cfg.model, active_sh_degree=active_sh_degree,
            means2d_offset=offset0, k_tile=k_tile, tile_shards=tile_shards,
        )
        losses = compute_losses(out, image, depth, unc, cfg.depth,
                                cfg.ssim_lambda)
        telemetry.mark("loss")
        grads = torch.autograd.grad(losses.total,
                                    list(diff.values()) + [offset0])
        telemetry.mark("backward")
        optimizer.step(targets, dict(zip(diff, grads[:-1])), state.opt_state)
        telemetry.mark("adam")
        # the radii come out of the graph (ceil): kept out of it, so the
        # statistics hold no step's autograd graph alive
        update_stats(state.densify, grads[-1], proj.radii.detach(),
                     proj.valid, camera.width, camera.height)
        metrics = {
            "loss": losses.total.detach(),
            "rgb_l1": losses.rgb_l1.detach(),
            "ssim_loss": losses.ssim_loss.detach(),
            "depth_loss": losses.depth_loss.detach(),
            "psnr": losses.psnr.detach(),
            "num_alive": params.num_alive,
        }
        if out.lossy_tiles is not None:  # the tile kernels' telemetry
            metrics["lossy_tiles"] = out.lossy_tiles
        telemetry.mark("stats")
        return metrics

    def step_fn(state: TrainState, camera: Camera, image, depth, unc,
                active_sh_degree: int, view_idx=None):
        metrics = body(state, camera, image, depth, unc, active_sh_degree,
                       view_idx)
        state.step += 1
        return state, metrics

    if not cfg.model.rasterize.use_pallas:
        return step_fn
    return GraphedStep(step_fn, body, events, view_input=pose_on)


def assign_fields(dst, src) -> None:
    """Copy every tensor field of the dataclass ``src`` into ``dst``'s."""
    for f in dataclasses.fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


def refine_state(state: TrainState, cfg: TrainConfig, do_densify=True,
                 use_size_cull=True, use_screen_size=False, split_noise=None,
                 generator: Optional[torch.Generator] = None) -> TrainState:
    """Densify + prune, then zero the Adam moments of rewritten slots.
    The results are written into ``state``'s tensors (the capacity never
    changes), which it returns, as the JAX package's ``make_refine_step``
    donates its state: a captured step goes on replaying."""
    params, densify, touched = refine(
        state.params, state.densify, cfg.densify, do_densify=do_densify,
        use_size_cull=use_size_cull, use_screen_size=use_screen_size,
        split_noise=split_noise, generator=generator,
    )
    reset_opt_slots(state.opt_state, touched)
    assign_fields(state.params, params)
    assign_fields(state.densify, densify)
    return state


def reset_opacity_state(state: TrainState, cfg: TrainConfig) -> TrainState:
    """The opacity reset, written into ``state``'s opacities (as
    ``refine_state``), which it returns."""
    state.params.logit_opacities.copy_(reset_opacities(
        state.params, cfg.densify.reset_opacity_value).logit_opacities)
    return state


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


def grow_state(state: TrainState, new_capacity: int) -> TrainState:
    """Zero-pad every per-gaussian tensor of the state to ``new_capacity``;
    padded slots are dead (``alive`` pads to False), and ``log_scales`` pads
    with −12 (scale ≈ 0) so a virgin slot never trips a size prune.  The
    pose deltas and their moments are per camera and keep their shape."""
    old = state.params.capacity
    if new_capacity <= old:
        return state

    def pad(x, fill=0):
        extra = x.new_full((new_capacity - old,) + tuple(x.shape[1:]), fill)
        return torch.cat([x, extra], dim=0)

    p = state.params
    params = GaussianParams(
        means=pad(p.means), quats=pad(p.quats),
        log_scales=pad(p.log_scales, -12.0),
        logit_opacities=pad(p.logit_opacities), sh_dc=pad(p.sh_dc),
        sh_rest=pad(p.sh_rest), alive=pad(p.alive, False))
    opt = state.opt_state

    def pad_moments(moments):
        return {k: pad(v) if k in PARAM_GROUPS else v
                for k, v in moments.items()}

    return TrainState(
        params=params,
        opt_state=FusedAdamState(count=opt.count, mu=pad_moments(opt.mu),
                                 nu=pad_moments(opt.nu)),
        densify=DensifyState(*(pad(getattr(state.densify, f.name))
                               for f in dataclasses.fields(DensifyState))),
        step=state.step,
        pose_deltas=state.pose_deltas,
    )


class Trainer:
    """Host-side training loop for one scene.

    ``device=None`` means ``cuda``; without a GPU that raises, and the
    CPU runs only when the caller passes ``device="cpu"``.
    """

    def __init__(self, scene: Scene, cfg: TrainConfig,
                 device: torch.device | str | None = None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer wants a CUDA device and none is "
                               "available; pass device='cpu' to run on the CPU")
        self.scene = scene
        self.cfg = cfg
        pose_on = cfg.pose_opt.mode != "off"
        self.optimizer = FusedAdam(
            cfg.optim,
            extra_lrs={"pose_deltas": cfg.pose_opt.lr} if pose_on else None)

        n_seed = (len(scene.seed_points)
                  if scene.seed_points is not None
                  and len(scene.seed_points) > 0 else 50_000)
        init_cap = cfg.model.max_gaussians
        if cfg.grow_capacity:
            init_cap = min(init_cap,
                           cfg.init_capacity
                           or max(_next_pow2(2 * n_seed), 4096))
        if scene.seed_points is not None and len(scene.seed_points) > 0:
            params = init_from_points(
                scene.seed_points, scene.seed_colors, capacity=init_cap,
                sh_degree=cfg.model.sh_degree,
                init_opacity=cfg.model.init_opacity, seed=cfg.seed,
                device=self.device)
        else:
            params = init_random(
                n=min(50_000, cfg.model.max_gaussians // 2),
                capacity=init_cap, sh_degree=cfg.model.sh_degree,
                init_opacity=cfg.model.init_opacity, seed=cfg.seed,
                device=self.device)
        pose_deltas = (torch.zeros((len(scene.cameras), 6),
                                   device=self.device) if pose_on else None)
        diff0 = {g: getattr(params, g) for g in PARAM_GROUPS}
        if pose_on:
            diff0["pose_deltas"] = pose_deltas
        self.state = TrainState(
            params=params, opt_state=self.optimizer.init(diff0),
            densify=DensifyState.zeros(params.capacity, self.device),
            step=0, pose_deltas=pose_deltas,
        )
        self._k_tile: Optional[int] = None   # escalated cap (None = config)
        self._lossy_streak = 0
        # the largest lossy_tiles of the steps since the last check (a
        # device scalar)
        self._lossy_max: Optional[torch.Tensor] = None
        # the run's account (``utils/telemetry.py``): how often run()
        # grew the capacity, refined and reset the opacities and the
        # graphed step captured; the host's milliseconds by span and its
        # reads; the graphed step's device milliseconds by stage
        self.events = telemetry.new_events()
        self.train_step = make_train_step(cfg, self.optimizer,
                                          events=self.events)
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = self._generator(cfg.seed)
        self.history: list[dict] = []
        self._batch_cache: dict = {}
        self._batch_cache_bytes = 0
        self._view_indices: dict = {}

    def _generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def view_index(self, view_idx: int) -> torch.Tensor:
        """The view as the (1,) int64 device tensor the pose step takes
        (its row of ``state.pose_deltas``), made once a view."""
        t = self._view_indices.get(view_idx)
        if t is None:
            t = self._view_indices[view_idx] = view_index(view_idx,
                                                          self.device)
        return t

    def _batch(self, view_idx: int):
        """(camera, image, depth, unc) on the device, cached up to
        ``cfg.view_cache_bytes`` so views are uploaded once; the view's
        index tensor is ``view_index``'s."""
        hit = self._batch_cache.get(view_idx)
        if hit is not None:
            return hit
        s = self.scene

        def up(a):
            return (None if a is None
                    else torch.as_tensor(np.asarray(a[view_idx], np.float32),
                                         device=self.device))

        image, depth, unc = up(s.images), up(s.depths), up(s.uncertainties)
        batch = (s.cameras.at(view_idx, self.device), image, depth, unc)
        nbytes = sum(a.numel() * a.element_size() for a in (image, depth, unc)
                     if a is not None)
        if self._batch_cache_bytes + nbytes <= self.cfg.view_cache_bytes:
            self._batch_cache[view_idx] = batch
            self._batch_cache_bytes += nbytes
        return batch

    def active_sh_degree(self, step: int) -> int:
        return min(step // self.cfg.sh_degree_interval, self.cfg.model.sh_degree)

    def run(self, max_steps: Optional[int] = None,
            log_fn: Optional[Callable[[dict], None]] = None,
            ckpt_manager=None, viewer=None) -> dict:
        """Train from ``state.step`` to ``max_steps`` (``cfg.max_steps``),
        saving to ``ckpt_manager`` every ``cfg.checkpoint_every`` steps and
        at the last one, and publishing each log point's status and
        parameters to ``viewer`` (a ``viewer.ViewerServer``)."""
        cfg = self.cfg
        steps = max_steps if max_steps is not None else cfg.max_steps
        dcfg = cfg.densify
        # resume from the state's step: schedules continue from there
        start = self.state.step
        if start:
            # deterministic resume: re-derive the host RNG streams
            self.rng = np.random.default_rng(cfg.seed + start)
            self.generator = self._generator(cfg.seed + start)
        t0 = time.time()
        last_metrics = {}
        ev = self.events
        span = telemetry.span
        for step in range(start, steps):
            with span(ev, "fetch"):
                view = int(self.rng.choice(self.scene.i_train))
                cam, image, depth, unc = self._batch(view)
                sh, view_idx = (self.active_sh_degree(step),
                                self.view_index(view))
            with span(ev, "dispatch"):
                self.state, metrics = self.train_step(
                    self.state, cam, image, depth, unc, sh, view_idx)
                if "lossy_tiles" in metrics:
                    # device scalars — no sync; the guard reads the window
                    # max at log points so truncation between them is seen
                    # too.  A graphed step's metrics are overwritten by its
                    # next replay, so the max is kept in a tensor of the
                    # trainer's
                    lossy = metrics["lossy_tiles"]
                    self._lossy_max = (
                        lossy.clone() if self._lossy_max is None
                        else torch.maximum(self._lossy_max, lossy))
            if (
                dcfg.warmup_steps <= step < dcfg.stop_refine_at
                and step % dcfg.refine_every == 0
                and step > 0
            ):
                cap = self.state.params.capacity
                with span(ev, "read"):
                    # the steps queued before the refine drain here, so
                    # that the growth and the refine time their own work
                    telemetry.drain(self.device)
                    grow = (cfg.grow_capacity
                            and cap < cfg.model.max_gaussians)
                    if grow:
                        telemetry.count_read()
                        grow = (float(self.state.params.num_alive)
                                > cfg.grow_trigger_fraction * cap)
                if grow:
                    with span(ev, "grow"):
                        self.state = grow_state(
                            self.state, min(cap * 2, cfg.model.max_gaussians))
                    ev["grow"] += 1
                # splatfacto's schedule: pause densification after each
                # opacity reset; size culling after the first reset period;
                # screen-size gates until stop_screen_size_at
                pause = min(len(self.scene.i_train) + dcfg.refine_every,
                            dcfg.reset_opacity_every // 2)
                do_densify = (step % dcfg.reset_opacity_every) > pause
                with span(ev, "refine"):
                    self.state = refine_state(
                        self.state, cfg, do_densify,
                        step > dcfg.reset_opacity_every,
                        step < dcfg.stop_screen_size_at,
                        generator=self.generator,
                    )
                ev["refine"] += 1
            if (step > 0 and step % dcfg.reset_opacity_every == 0
                    and step < dcfg.stop_refine_at):
                with span(ev, "reset"):
                    self.state = reset_opacity_state(self.state, cfg)
                ev["reset_opacity"] += 1
            if step % cfg.log_every == 0 or step == steps - 1:
                with span(ev, "read"):
                    telemetry.count_read(n=len(metrics))
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    window_lossy = None
                    take_lists = getattr(self.train_step, "take_tile_lists",
                                         None)
                    lists = take_lists() if take_lists is not None else None
                    if self._lossy_max is not None:
                        telemetry.count_read()
                        # the last step's tile lists, reduced here, ride
                        # on the guard's read
                        read = [self._lossy_max.to(torch.int64)]
                        if lists is not None:
                            read.append(lists.entries())
                        vals = torch.stack(read).tolist()
                        window_lossy = float(vals[0])
                        if lists is not None:
                            telemetry.add_tile_lists(ev, lists, vals[1])
                        self._lossy_max = None
                with span(ev, "log"):
                    # the reads waited for the step: its replay's stage
                    # events are done
                    take = getattr(self.train_step, "take_stage_ms", None)
                    if take is not None:
                        telemetry.add_stages(ev, take())
                    self._log_point(step, steps, start, t0, last_metrics,
                                    window_lossy, log_fn, viewer)
            if ckpt_manager is not None and (
                (step + 1) % cfg.checkpoint_every == 0 or step == steps - 1
            ):
                with span(ev, "ckpt"):
                    extra = {"k_tile": self._k_tile} if self._k_tile else None
                    ckpt_manager.save(step + 1, self.state, extra=extra)
        return last_metrics

    def _log_point(self, step: int, steps: int, start: int, t0: float,
                   last_metrics: dict, window_lossy: Optional[float],
                   log_fn, viewer) -> None:
        """A log point after its reads: the truncation guard, the history,
        ``log_fn`` and the viewer's status."""
        cfg = self.cfg
        last_metrics["step"] = step
        # truncation guard: when more than 0.5% of tiles (at least 2, at
        # most half) are capped and unsaturated on two consecutive log
        # windows — max over every step of the window — double the
        # per-tile entry cap
        rcfg = cfg.model.rasterize
        n_tiles = (-(-self.scene.cameras.width // rcfg.tile_w)
                   * -(-self.scene.cameras.height // rcfg.tile_h))
        if window_lossy is not None:
            last_metrics["lossy_tiles_window_max"] = window_lossy
        else:  # the scan path reports no truncation
            window_lossy = 0.0
        thr = min(max(0.005 * n_tiles, 2.0), 0.5 * n_tiles)
        if window_lossy > thr:
            self._lossy_streak += 1
        else:
            self._lossy_streak = 0
        cur_k = self._k_tile or rcfg.k_tile
        if self._lossy_streak >= 2 and cur_k < rcfg.k_tile_max_train:
            # clamped at the ceiling (ROADMAP.md C6; the JAX package
            # doubles unclamped, the same for power-of-two defaults)
            self._k_tile = min(cur_k * 2, rcfg.k_tile_max_train)
            self._lossy_streak = 0
            self.train_step = make_train_step(
                cfg, self.optimizer, k_tile=self._k_tile,
                events=self.events)
            last_metrics["k_tile_escalated_to"] = self._k_tile
        last_metrics["iters_per_sec"] = (
            (step + 1 - start) / (time.time() - t0))
        self.history.append(last_metrics)
        if log_fn:
            log_fn(last_metrics)
        if viewer is not None:
            viewer.update_status(
                step, last_metrics.get("loss", float("nan")),
                last_metrics.get("num_alive", 0),
                training=step < steps - 1)

    def render_view(self, view_idx: int, use_dense: bool = False):
        cam = self.scene.cameras.at(view_idx, self.device)
        if use_dense:
            with torch.no_grad():
                out, _ = render(self.state.params, cam, self.cfg.model,
                                active_sh_degree=self.cfg.model.sh_degree,
                                use_dense=True)
            return out
        from touchgs_torch.models.splatfacto import render_lossless

        # lossless: a trained model routinely exceeds the training k_tile
        return render_lossless(self.state.params, cam, self.cfg.model,
                               active_sh_degree=self.cfg.model.sh_degree)
