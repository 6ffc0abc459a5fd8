"""The comparison that decides ``correct``: what the program's timed path
produced against the plain reference (``reference/``), from the same
start.

The check steps are the first steps of the set-up's first ``Trainer.run``
call, the window's own call, on the trainer the window then drives.  The
reference follows them from the benchmark's own start state (a new job's
start it works out itself from the seed points) over the same views, once
the window has closed and the program's state is freed.  Compared, over
the Gaussians live at the start:

- ``loss_gap``: each step's loss, the largest |program − reference| over
  |reference|;
- ``grad_gap``: the first step's gradient as Adam received it, worked out
  from its first moments after that step (g = (m₁ − β₁m₀) / (1 − β₁)), by
  parameter group: the worst group's |‖g‖ − ‖g_ref‖| over the larger of
  its reference norm and the median group's;
- ``change_gap``: the same of each group's change over the steps, leaving
  out groups whose reference gradient is under a thousandth of the median
  group's (they move by round-off alone under Adam);
- ``stats_gap``: the same of the densification statistics' change.

``first_loss_gap``, ``median_change_gap`` and ``first_stats_gap`` are the
first step's loss, the median group's change and the statistics after the
first step: a new job's first Adam steps are the signs of its gradients,
and a gradient at round-off flips its sign between any two computations,
so over three steps the worst group and the last statistics read that
noise and not the program (PERF.md).  A cell's limits file names the
numbers it compares; every number is printed.

A new job also has its first refine checked, from the program's own state
before it (the reference cannot follow the program's hundreds of set-up
steps; the start and the steps after it are checked apart), with the
split noise drawn as the trainer draws it, from its seed and the call's
first step; and its first capacity growth in the window, and the step
after it, the first replay of the graph captured at the new capacity,
from the program's state before that step:

- ``refine_gap``: the worst group's ‖program − reference‖ over
  ‖reference‖ after the refine, of every row, and ``refine_rows``: the rows
  whose ``alive`` differs;
- ``grow_diff``: the elements of the grown state that differ from the
  reference's (an exact comparison);
- ``grown_loss_gap``, ``grown_grad_gap``, ``grown_change_gap``,
  ``grown_stats_gap``: the numbers above of that one step, its change over
  the rows whose Adam moments are not zero at its start
  (``settled_rows``).

Each has a limit per cell (``limits/<cell>.json``), set between the
program's readings over a dozen seeds and the lowest of its control's (the
reference computed with TF32 matrix products) and of its faults'.
"""
from __future__ import annotations

import contextlib
import math

import torch

from perfbench.reference import densify as ref_densify
from perfbench.reference import train as ref


@contextlib.contextmanager
def tf32(on: bool):
    """Matrix products and convolutions in TF32 (on) or full float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def start_state(job) -> dict:
    """The check steps' start, as the job's driver makes it for the
    reference."""
    return job.check_start()


def reference_run(job, device, tf32_on: bool = False, fault=None) -> dict:
    """The reference's steps from the job's start over the program's
    views; ``fault`` (a name of ``FAULTS``) plants one in it."""
    with tf32(tf32_on), FAULTS.get(fault, contextlib.nullcontext)():
        return ref.steps(start_state(job), job.check_run.views, job.scene,
                         job.cfg["train"], device, job.k_tile)


def run_of_program(job) -> dict:
    """The program's check steps in the reference's terms."""
    cr = job.check_run
    return dict(rows=[{"loss": x} for x in cr.losses],
                grad1=first_gradient(cr.mu1, start_state(job)["mu"],
                                     job.cfg["train"]["adam"]["b1"]),
                stats1=cr.stats1, params=cr.params, stats=cr.stats)


def first_gradient(mu1: dict, mu0: dict, b1: float) -> dict:
    return {k: (mu1[k].double() - b1 * mu0[k].double()) / (1 - b1)
            for k in mu1}


def readings(run: dict, refr: dict, start: dict, change_rows=None) -> dict:
    """The step numbers of ``run`` (the program's, or a control's) against
    the reference's ``refr``, both from ``start``; the change over
    ``change_rows`` (a mask of rows) where given, else over the live
    rows."""
    losses = [(abs(a["loss"] - b["loss"]) / abs(b["loss"]))
              for a, b in zip(run["rows"], refr["rows"])]
    live = start["params"]["alive"]
    groups = ref.GROUPS
    g_run = ref.norms(run["grad1"], groups, live)
    g_ref = ref.norms(refr["grad1"], groups, live)
    grad_gap, grad_leaf = ref.gap(g_run, g_ref, groups)
    med = ref.median(g_ref.values())
    moved = [k for k in groups if g_ref[k] >= 1e-3 * med]
    p0 = start["params"]

    def change(params, keys, base):
        return {k: params[k].double() - base[k].double() for k in keys}

    rows = live if change_rows is None else change_rows
    c_run = ref.norms(change(run["params"], moved, p0), moved, rows)
    c_ref = ref.norms(change(refr["params"], moved, p0), moved, rows)
    change_gap, change_leaf = ref.gap(c_run, c_ref, moved)

    def stats_gap(key):
        s_run = ref.norms(change(run[key], ref.STATS, start["stats"]),
                          ref.STATS, live)
        s_ref = ref.norms(change(refr[key], ref.STATS, start["stats"]),
                          ref.STATS, live)
        return ref.gap(s_run, s_ref, ref.STATS)

    stats_last, stats_leaf = stats_gap("stats")
    return dict(loss_gap=max(losses), first_loss_gap=losses[0],
                grad_gap=grad_gap, change_gap=change_gap,
                median_change_gap=ref.median_gap(c_run, c_ref, moved),
                stats_gap=stats_last, first_stats_gap=stats_gap("stats1")[0],
                worst=dict(grad=grad_leaf, change=change_leaf,
                           stats=stats_leaf),
                loss_gaps=losses,
                left_out=[k for k in groups if k not in moved])


def _finite(x: torch.Tensor) -> torch.Tensor:
    """Rows whose values are not finite (a dead row's rotation after its
    first step) compare as zeros on both sides."""
    return torch.nan_to_num(x.double(), nan=0.0, posinf=0.0, neginf=0.0)


def reference_refine(job, device, tf32_on: bool = False, fault=None
                     ) -> dict:
    """The reference's refine of the program's state before its first
    refine, the split noise drawn from the trainer's seed (the first
    refine of the job is the first of its ``Trainer.run`` call);
    ``fault`` (a name of ``REFINE_FAULTS``) plants one in it."""
    kept = job.refine
    st = {k: ({n: v.to(device) for n, v in d.items()}
              if isinstance(d, dict) else d) for k, d in kept["in"].items()}
    # Trainer.run seeds its generator with cfg.seed + the call's first step
    call = max(c for c in job.call_starts if c <= kept["step"])
    g = torch.Generator(device=device)
    g.manual_seed(job.trainer_seed + call)
    C = st["params"]["means"].shape[0]
    d = job.cfg["train"]["densify"]
    noise = torch.randn((max(1, d["split_samples"]), C, 3), generator=g,
                        device=device)
    n_train = math.ceil(job.cfg["scene"]["views"]
                        * job.cfg["scene"]["train_split_fraction"])
    flags = ref_densify.schedule(kept["step"], n_train, d)
    with tf32(tf32_on), REFINE_FAULTS.get(fault, contextlib.nullcontext)():
        out = ref_densify.refine(st, flags, noise, d)
    return {k: ({n: v.cpu() for n, v in o.items()}) for k, o in out.items()}


def refine_readings(prog: dict, refr: dict) -> dict:
    """``refine_gap`` and ``refine_rows`` of a refine's output against the
    reference's."""
    worst = 0.0
    for part in ("params", "mu", "nu", "stats"):
        for k, r in refr[part].items():
            if k == "alive":
                continue
            a, b = _finite(prog[part][k]), _finite(r)
            worst = max(worst, float(torch.linalg.vector_norm(a - b))
                        / max(float(torch.linalg.vector_norm(b)), 1e-30))
    rows = int((prog["params"]["alive"] != refr["params"]["alive"]).sum())
    return dict(refine_gap=worst, refine_rows=rows)


def grow_readings(job) -> dict:
    """``grow_diff``: elements of the program's grown state that differ
    from the reference's pad of the state it was given."""
    kept = job.grow
    C = kept["out"]["params"]["means"].shape[0]
    want = ref_densify.grow(kept["in"], C)
    diff = 0
    for part in ("params", "mu", "nu", "stats"):
        for k, r in want[part].items():
            a, b = kept["out"][part][k], r
            same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
                if a.is_floating_point() else (a == b)
            diff += int((~same).sum())
    return dict(grow_diff=diff)


GROWN = ("loss_gap", "grad_gap", "change_gap", "stats_gap")


def settled_rows(start: dict):
    """The live rows whose Adam moments are not zero at ``start``: a row
    the refine before it wrote (its moments zeroed) takes Adam's first
    step, which moves each element by the sign of its gradient, and the
    sign of a gradient at round-off differs between any two computations
    (PERF.md)."""
    nu = start["nu"]["means"]
    return start["params"]["alive"] & (nu.reshape(len(nu), -1) != 0).any(-1)


def grown_run(job, device, tf32_on: bool = False, fault=None) -> dict:
    """The reference's step after the first growth, from the program's
    state before it, over the program's view."""
    k = job.grown
    with tf32(tf32_on), FAULTS.get(fault, contextlib.nullcontext)():
        return ref.steps(k["in"], [k["view"]], job.scene, job.cfg["train"],
                         device, k["k_tile"])


def grown_readings(job, refr: dict) -> dict:
    """The ``grown_*`` numbers of ``refr`` (the reference's step, or a
    control's) against the program's step, both from its state before
    it."""
    k = job.grown
    b1 = job.cfg["train"]["adam"]["b1"]
    run = dict(rows=[{"loss": float(k["loss"])}],
               grad1=first_gradient(k["out"]["mu"], k["in"]["mu"], b1),
               stats1=k["out"]["stats"], params=k["out"]["params"],
               stats=k["out"]["stats"])
    r = readings(run, refr, k["in"], settled_rows(k["in"]))
    return {f"grown_{n}": r[n] for n in GROWN}


def against_grown(job, run: dict, device) -> dict:
    """The ``grown_*`` numbers of a control's or a fault's step ``run``
    (the reference's terms) against the float32 reference's."""
    refr = grown_run(job, device)
    r = readings(run, refr, job.grown["in"], settled_rows(job.grown["in"]))
    return {f"grown_{n}": r[n] for n in GROWN}


def program_readings(job, device) -> dict:
    """Every number this job's check compares, from the program's run."""
    start = start_state(job)
    out = readings(run_of_program(job), reference_run(job, device), start)
    if job.refine:
        out.update(refine_readings(job.refine["out"],
                                   reference_refine(job, device)))
    if job.grow:
        out.update(grow_readings(job))
    if job.grown:
        out.update(grown_readings(job, grown_run(job, device)))
    return out


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value": v, "limit": l}}): each number the job
    produced at most its limit.  A number the cell's limits name and the
    run did not produce (a growth that did not come) fails."""
    shown = {k: {"value": values.get(k, math.inf), "limit": lim}
             for k, lim in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in shown.values())
    return ok, shown


@contextlib.contextmanager
def _half_batch():
    """Fault: the loss over the top half of each image alone."""
    plain = ref.losses

    def half(rgb, depth, image, target_depth, unc, train):
        h = rgb.shape[0] // 2
        cut = (lambda a: None if a is None else a[:h])
        return plain(rgb[:h], depth[:h], image[:h], cut(target_depth),
                     cut(unc), train)

    ref.losses = half
    try:
        yield
    finally:
        ref.losses = plain


@contextlib.contextmanager
def _altered_tile():
    """Fault: the first tile with any light composited to black."""
    plain = ref.splat.composite

    def altered(attr, lists, counts, tiles, n_tx, rc):
        out = plain(attr, lists, counts, tiles, n_tx, rc)
        lit = (out[:, 4].amax(-1) > 0).nonzero()
        if len(lit):
            keep = torch.ones_like(out)
            keep[int(lit[0]), :3] = 0
            out = out * keep
        return out

    ref.splat.composite = altered
    try:
        yield
    finally:
        ref.splat.composite = plain


FAULTS = {"half_batch": _half_batch, "altered_tile": _altered_tile}


@contextlib.contextmanager
def _moved_child():
    """Fault: the first row a refine fills gets its mean moved by its own
    scale."""
    plain = ref_densify.refine

    def moved(state, flags, noise, d):
        out = plain(state, flags, noise, d)
        born = (out["params"]["alive"] & ~state["params"]["alive"]).nonzero()
        if len(born):
            r = int(born[0])
            out["params"]["means"][r] += torch.exp(
                out["params"]["log_scales"][r])
        return out

    ref_densify.refine = moved
    try:
        yield
    finally:
        ref_densify.refine = plain


REFINE_FAULTS = {"moved_child": _moved_child}
