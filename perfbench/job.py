"""A training job run through the program's user entry,
``touchgs_torch.train.trainer.Trainer.run``: what the training drivers
(``perfbench/drivers/resumed_job.py``, ``new_job.py``) share.

A training traffic file (``perfbench/traffic/<mix>.json``) is data:

- ``driver``: the module of ``perfbench/drivers/`` that starts the job;
- ``start``: the driver's parameters of the job's start;
- ``period``: the steps of one ``Trainer.run`` call, the refine period;
- ``window_steps_per_s`` (optional): the window runs a fixed number of
  periods, ``--seconds`` times this rate (rounded to whole periods), so that
  a job whose work changes as it goes (growth, SH steps, refines) does the
  same work in every run whatever the program's speed; without it the
  window calls a period until ``--seconds`` have passed;
- ``check_steps``: the job's first steps, which the plain reference
  follows (``check.py``).

Set-up makes the scene from the seed, builds the ``Trainer``, lets the
driver make the start (``Job.start``) and runs the trainer in calls of a
period (the first call also records the check steps) so that every CUDA
graph the window replays at its start is captured before it.  Set-up
records the inputs and outputs of the job's first refine; the window those
of its first capacity growth and of the step after it, the first replay of
the graph captured at the new capacity.  The window counts every step of
every call and ends in a synchronisation; in a traced run the benchmark's
spans time the window's refines, and one more period, after the window,
runs under the profiler.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from perfbench import counts, trace
from perfbench.reference import splat
from perfbench.reference import train as ref
from perfbench.scene import analytic
from perfbench.scene import state as start_states

GROUPS = start_states.GROUPS
STATS = ("grad_accum", "grad_count", "max_radii")


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host(x):
    """A copy on the host of a tensor, or of the tensors of a dict."""
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    return x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x


def train_config(cfg: dict, seed: int):
    """The program's ``TrainConfig`` of a configuration file's ``train``
    section; the file's depth loss and split must be the program's preset
    of that name."""
    from touchgs_torch.config import (SCENE_PRESETS, DensifyConfig,
                                      DepthLossConfig, DepthLossType,
                                      ModelConfig, OptimConfig,
                                      RasterizeConfig, TrainConfig)

    t = cfg["train"]
    m = dict(t["model"], background=tuple(t["model"]["background"]))
    d = t["depth"]
    depth = DepthLossConfig(d["depth_loss_mult"],
                            DepthLossType(d["depth_loss_type"]),
                            d["uncertainty_weight"], d["uncertainty_form"])
    preset = SCENE_PRESETS[cfg["preset"]]
    if (preset.depth != depth or preset.train_split_fraction
            != cfg["scene"]["train_split_fraction"]):
        raise ValueError(f"{cfg['name']}: depth loss or split differ from "
                         f"the program's preset {cfg['preset']!r}")
    top = {k: v for k, v in t.items()
           if k not in ("model", "rasterize", "depth", "densify", "optim",
                        "adam")}
    return TrainConfig(**top, seed=seed,
                       model=ModelConfig(**m, rasterize=RasterizeConfig(
                           **t["rasterize"])),
                       depth=depth, densify=DensifyConfig(**t["densify"]),
                       optim=OptimConfig(**t["optim"]))


def program_scene(cfg: dict, sc: analytic.AnalyticScene):
    """The views as the program's ``Scene``, split as its loader splits."""
    from touchgs_torch.data.cameras import Cameras
    from touchgs_torch.data.scene import Scene
    from touchgs_torch.data.splits import linspace_split

    n = len(sc.c2w)
    fx, fy, cx, cy = (np.full((n,), v, np.float32) for v in sc.fxy)
    i_train, i_eval = linspace_split(n, cfg["scene"]["train_split_fraction"],
                                     variant="dataparser")
    return Scene(cameras=Cameras(fx=fx, fy=fy, cx=cx, cy=cy, c2w=sc.c2w,
                                 width=sc.width, height=sc.height),
                 images=sc.images, depths=sc.depths,
                 uncertainties=sc.uncertainties, i_train=i_train,
                 i_eval=i_eval, seed_points=sc.seed_points,
                 seed_colors=sc.seed_colors, scale_factor=1.0,
                 transform=np.eye(4)[:3], name=cfg["name"])


def trainer_seed(seed: int, start: int, i_train, n: int) -> int:
    """The smallest trainer seed from ``seed`` on whose first ``n`` steps
    from ``start`` (a ``Trainer.run`` call draws its views from
    ``default_rng(cfg.seed + start)``) train on ``n`` different views."""
    base = seed % (1 << 31)
    for k in range(10_000):
        rng = np.random.default_rng(base + k + start)
        if len({int(rng.choice(i_train)) for _ in range(n)}) == n:
            return base + k
    raise ValueError("no trainer seed gives distinct check views")


def program_state(st: dict):
    """A start state as the program's ``TrainState``."""
    from touchgs_torch.models.densify import DensifyState
    from touchgs_torch.models.gaussians import GaussianParams
    from touchgs_torch.train.optim import FusedAdamState
    from touchgs_torch.train.trainer import TrainState

    dev = st["params"]["means"].device
    return TrainState(
        params=GaussianParams(**st["params"]),
        opt_state=FusedAdamState(
            count=torch.tensor(st["count"], dtype=torch.int32, device=dev),
            mu=dict(st["mu"]), nu=dict(st["nu"])),
        densify=DensifyState(**st["stats"]), step=st["step"])


def state_dict(state, clone: bool = False) -> dict:
    """A program ``TrainState``'s tensors as the benchmark's state dict
    (copies on the device with ``clone``; Adam's count stays a tensor, so
    that taking the dict reads nothing back to the host)."""
    p, o = state.params, state.opt_state
    own = (lambda t: t.detach().clone()) if clone else (lambda t: t)
    return dict(
        params={f.name: own(getattr(p, f.name))
                for f in dataclasses.fields(p)},
        mu={k: own(o.mu[k]) for k in GROUPS},
        nu={k: own(o.nu[k]) for k in GROUPS},
        count=own(o.count), step=state.step,
        stats={k: own(getattr(state.densify, k)) for k in STATS})


@dataclasses.dataclass
class CheckRun:
    """What the program's check steps produced (host tensors): the views,
    each step's loss, Adam's first moments and the statistics after the
    first step, and the parameters and statistics after the last."""

    views: list
    losses: list
    mu1: dict
    stats1: dict
    params: dict
    stats: dict


@contextlib.contextmanager
def first_refine(keep: dict):
    """Keep the inputs and outputs of the first call of the trainer
    module's ``refine_state``, wrapped at the module attribute: the step
    it follows, a copy of the state it was given (it writes into it) and a
    copy of the state it returned."""
    from touchgs_torch.train import trainer as tmod

    plain = tmod.refine_state

    def wrapped(state, *args, **kw):
        if keep:
            return plain(state, *args, **kw)
        keep["step"] = state.step - 1
        keep["in"] = state_dict(state, clone=True)
        out = plain(state, *args, **kw)
        keep["out"] = state_dict(out, clone=True)
        return out

    tmod.refine_state = wrapped
    try:
        yield keep
    finally:
        tmod.refine_state = plain


@contextlib.contextmanager
def first_growth(trainer, grow: dict, grown: dict):
    """Keep the trainer's first capacity growth (``grow``: the state it
    was given, as it is, since ``grow_state`` makes a new one, and a copy
    of the grown state) and the train step after it (``grown``: its step,
    view and k_tile, a copy of the state it was given and of the state it
    left, and its loss).  The growth is wrapped at the trainer module's
    ``grow_state``, the step at ``GraphedStep.__call__`` (the trainer
    makes a new step object when its guard raises k_tile), the view at the
    trainer's ``view_index``."""
    from touchgs_torch.train import graphs
    from touchgs_torch.train import trainer as tmod

    plain_grow, plain_call = tmod.grow_state, graphs.GraphedStep.__call__
    plain_view = trainer.view_index
    last_view = [None]

    def wrapped_grow(state, *args, **kw):
        if grow:
            return plain_grow(state, *args, **kw)
        grow["step"] = state.step - 1
        grow["in"] = state_dict(state)
        out = plain_grow(state, *args, **kw)
        grow["out"] = state_dict(out, clone=True)
        return out

    def view(v):
        last_view[0] = int(v)
        return plain_view(v)

    def call(self, state, *args):
        if not grow or grown:
            return plain_call(self, state, *args)
        grown.update(step=state.step, view=last_view[0],
                     k_tile=trainer._k_tile
                     or trainer.cfg.model.rasterize.k_tile,
                     **{"in": state_dict(state, clone=True)})
        state, metrics = plain_call(self, state, *args)
        grown["loss"] = metrics["loss"].detach().clone()
        grown["out"] = state_dict(state, clone=True)
        return state, metrics

    tmod.grow_state, graphs.GraphedStep.__call__ = wrapped_grow, call
    trainer.view_index = view
    try:
        yield
    finally:
        tmod.grow_state, graphs.GraphedStep.__call__ = plain_grow, plain_call
        del trainer.view_index


class Job:
    """A training job: ``setup``, ``window``, ``report``, ``free``, then
    ``readings`` (the check's numbers) and, in a traced run, ``work``.  A
    driver subclasses it with ``start``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.trainer = None
        self.trainer_seed = None
        self.scene = None
        self.start_host = None
        self.check_run = None
        self.call_starts = []   # the first step of every Trainer.run call
        self.refine = {}        # the set-up's first refine
        self.grow = {}          # the window's first growth
        self.grown = {}         # the step after it
        # the per-tile cap of the check steps (a driver's start may raise
        # it, as a resumed job's checkpoint does)
        self.k_tile = cfg["train"]["rasterize"]["k_tile"]

    def start(self, say) -> int:
        """Make the job's start state in ``self.trainer`` and keep it in
        ``self.start_host`` (host tensors); returns the step set-up trains
        to (exclusive)."""
        raise NotImplementedError

    def check_start(self) -> dict:
        """The state the reference starts the check steps from."""
        return self.start_host

    def _call(self, max_steps: int) -> None:
        self.call_starts.append(self.trainer.state.step)
        self.trainer.run(max_steps=max_steps)

    # -- set-up -------------------------------------------------------------
    def setup(self, log=None) -> None:
        from touchgs_torch.train.trainer import Trainer

        cfg, tr = self.cfg, self.traffic
        say = log or (lambda msg: None)
        t0 = time.perf_counter()
        self.scene = analytic.make_scene(cfg, self.seed, self.device)
        scene = program_scene(cfg, self.scene)
        say(f"set-up: scene {time.perf_counter() - t0:.3f} s")
        self.trainer_seed = trainer_seed(self.seed, tr["start"].get("step", 0),
                                         scene.i_train, tr["check_steps"])
        t1 = time.perf_counter()
        self.trainer = Trainer(scene, train_config(cfg, self.trainer_seed),
                               self.device)
        say(f"set-up: Trainer {time.perf_counter() - t1:.3f} s")
        t1 = time.perf_counter()
        until = self.start(say)
        step0 = self.trainer.state.step
        say(f"set-up: start state {time.perf_counter() - t1:.3f} s")
        t1 = time.perf_counter()
        with first_refine(self.refine):
            self.check_run = self._first_call(tr["check_steps"], tr["period"])
            while self.trainer.state.step < until:
                self._call(min(until, self.trainer.state.step + tr["period"]))
        sync(self.device)
        say(f"set-up: {self.trainer.state.step - step0} steps "
            f"{time.perf_counter() - t1:.3f} s")
        self.refine = host(self.refine)

    def _first_call(self, n: int, period: int) -> CheckRun:
        """The set-up's first ``Trainer.run`` call, of one period (or the
        check steps, where they are more), keeping its first ``n`` steps'
        views (at ``Trainer.view_index``), losses, Adam's first moments
        after the first and the parameters and statistics after the last
        (at the trainer's ``train_step``)."""
        t = self.trainer
        views, losses, kept = [], [], {}
        plain_view, plain_step = t.view_index, t.train_step

        def view(v):
            if len(views) < n:
                views.append(int(v))
            return plain_view(v)

        def step(state, *args):
            state, metrics = plain_step(state, *args)
            if len(losses) < n:
                losses.append(metrics["loss"].detach().clone())
                if len(losses) == 1:
                    kept["mu1"] = {k: state.opt_state.mu[k].detach().clone()
                                   for k in GROUPS}
                    kept["stats1"] = {k: getattr(state.densify, k).clone()
                                      for k in STATS}
                if len(losses) == n:
                    kept["params"] = {k: getattr(state.params, k).clone()
                                      for k in GROUPS}
                    kept["stats"] = {k: getattr(state.densify, k).clone()
                                     for k in STATS}
            return state, metrics

        t.view_index, t.train_step = view, step
        try:
            self._call(t.state.step + max(n, period))
        finally:
            del t.view_index
            if t.train_step is step:
                t.train_step = plain_step
        return CheckRun(views=views, losses=[float(x) for x in losses],
                        mu1=host(kept["mu1"]), stats1=host(kept["stats1"]),
                        params=host(kept["params"]),
                        stats=host(kept["stats"]))

    # -- window -------------------------------------------------------------
    def window(self, seconds: float, record=None) -> dict:
        """Call ``Trainer.run`` a period at a time, for the traffic's fixed
        number of periods or until ``seconds`` have passed.  With a
        ``record`` (a traced run) the benchmark's spans time the window's
        refines and growths, and the period after the window runs under
        the profiler.  Returns the steps, the wall seconds, the events and
        the start on the host clock."""
        t = self.trainer
        period = self.traffic["period"]
        rate = self.traffic.get("window_steps_per_s")
        n_calls = (max(1, int(seconds * rate / period + 0.5)) if rate
                   else None)
        ev0 = dict(t.events)
        step0 = t.state.step
        spans = (trace.spans(record, self.device) if record is not None
                 else contextlib.nullcontext())
        sync(self.device)
        with spans, first_growth(t, self.grow, self.grown):
            t0 = time.perf_counter()
            calls = 0
            while ((calls < n_calls) if n_calls
                   else (time.perf_counter() - t0 < seconds or calls == 0)):
                self._call(t.state.step + period)
                calls += 1
            sync(self.device)
            t1 = time.perf_counter()
        win = dict(steps=t.state.step - step0, seconds=t1 - t0,
                   events={k: t.events[k] - ev0.get(k, 0) for k in t.events},
                   t0=t0)
        if record is not None:
            self._profile(record)
        self.grow, self.grown = host(self.grow), host(self.grown)
        return win

    def _profile(self, record: dict) -> None:
        """One period after the window under the profiler, with its views
        and the state its steps train on (a refine comes after its step, so
        the period's own refine changes none of them)."""
        t = self.trainer
        views, plain = [], t.view_index

        def rec(v):
            views.append(int(v))
            return plain(v)

        snap = {k: getattr(t.state.params, k).detach().to("cpu", copy=True)
                for k in GROUPS + ("alive",)}
        record["profiled_state"] = dict(
            params=snap, step=t.state.step,
            k_tile=t._k_tile or self.cfg["train"]["rasterize"]["k_tile"])
        t.view_index = rec
        try:
            record["_prof"], record["traced_s"] = trace.profile_call(
                lambda: self._call(t.state.step + self.traffic["period"]),
                self.device)
        finally:
            del t.view_index
        record.update(profiled_steps=len(views), profiled_views=views)

    def report(self, log) -> None:
        """Lines on the trainer after the window."""
        from touchgs_torch.ops import rasterize_cuda

        st = self.trainer.state
        print(f"check steps: views {self.check_run.views}, program losses "
              f"{self.check_run.losses}", file=log)
        print(f"K1-K3 launches: {rasterize_cuda.launches}", file=log)
        print(f"after the window: step {st.step}, {int(st.params.num_alive)} "
              f"live of {st.params.capacity}, k_tile "
              f"{self.trainer._k_tile or self.k_tile}", file=log)
        if self.refine:
            print(f"first refine (after step {self.refine['step']}): "
                  f"{int(self.refine['in']['params']['alive'].sum())} live "
                  f"before, {int(self.refine['out']['params']['alive'].sum())}"
                  " after", file=log)
        if self.grow:
            print(f"first growth after step {self.grow['step']}; step "
                  f"{self.grown.get('step')} after it checked", file=log)

    def free(self) -> None:
        """Drop the program's trainer and its graphs."""
        self.trainer = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -- after the window ---------------------------------------------------
    def readings(self, device) -> dict:
        from perfbench import check

        return check.program_readings(self, device)

    def work(self, record: dict, device) -> dict:
        """The profiled steps' needed work, by the reference's binning and
        compositing pass over the lists of each step's view: the entries
        each tile needs before its last pixel's transmittance is under 1e-4
        (or its list ends), times the tile's pixels in the image; the
        kernels' least seconds and the steps' useful operations."""
        cfg = self.cfg
        ps = record.pop("profiled_state")
        rc = ref.raster_consts(cfg["train"], ps["params"]["means"].shape[0],
                               ps["k_tile"])
        p = {k: v.to(device) for k, v in ps["params"].items()}
        active = min(ps["step"] // cfg["train"]["sh_degree_interval"],
                     cfg["train"]["model"]["sh_degree"])
        live = int(p["alive"].sum())
        tile_px = rc["tile_h"] * rc["tile_w"]
        per_view = {}
        out = dict(pairs=0.0, entries=0.0, k2_bound_s=0.0, k3_bound_s=0.0,
                   ops=0.0, live=live)
        with torch.no_grad():
            for v in record["profiled_views"]:
                if v not in per_view:
                    cam, _ = self.scene.view(v, device)
                    attr, proj = splat.attributes(p, cam, rc, active)
                    lists, cnt = splat.bin_tiles(proj, cam["width"],
                                                 cam["height"], rc)
                    need = splat.needed_entries(attr, lists, cnt,
                                                cam["width"], cam["height"],
                                                rc).cpu()
                    pix = splat.tile_pixels_in_image(cam["width"],
                                                     cam["height"], rc)
                    per_view[v] = (float((need * pix).sum()),
                                   float(need.sum()), len(need),
                                   cam["width"] * cam["height"])
                pairs, entries, n_tiles, pixels = per_view[v]
                out["pairs"] += pairs
                out["entries"] += entries
                out["k2_bound_s"] += counts.composite_bound_s(
                    entries, pairs, n_tiles, tile_px, counts.K2_OPS_PER_PAIR)
                out["k3_bound_s"] += counts.composite_bound_s(
                    entries, pairs, n_tiles, tile_px, counts.K3_OPS_PER_PAIR,
                    passes=2)
                out["ops"] += counts.step_ops(pairs, live, pixels)
        return out
