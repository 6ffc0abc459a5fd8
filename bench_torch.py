"""Benchmark of the port: steady-state training iterations/sec on the
flagship model, on one CUDA card (port of ``bench.py``).

    python3 bench_torch.py          # on the card
    python3 bench_torch.py --cpu    # on the CPU, only when asked

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": ..., "power_limit_w": N}
with a "note" when the timed steps did not all run.  Everything else goes
to stderr.

``vs_baseline`` is the rate over ``bench.py``'s anchor: splatfacto on an
NVIDIA A100 trains a Touch-GS-scale scene at roughly 20 iters/sec (30k
iterations in about 25 min).  It is a GPU proxy, not a TPU number.

The headline contract, as ``bench.py``'s: the JSON line is printed exactly
once before the process ends.
  * a watchdog thread prints the best-known headline and exits with status
    0 when 20 s of the budget (BENCH_BUDGET_S, default 420 s) remain;
  * the timed loop runs in windows of CHUNK steps, each ending in a host
    read of the loss (which waits for the card), and the headline, the
    median window rate, is updated after each, so a cut run still reports
    a rate;
  * the roofline report runs strictly after the headline is printed, and
    only while more than 60 s of the budget remain.

Where it differs from ``bench.py``:
  * the line also names the device (``torch.cuda.get_device_name(0)``, or
    "cpu") and the card's power limit in W (null where nvidia-smi cannot
    read it);
  * without a CUDA device and without ``--cpu`` it prints a line with
    value 0.0 and the note "no_cuda_device" and exits with status 1: it
    never falls back to the CPU;
  * a failure of the roofline report, or of anything before the headline,
    prints its traceback and exits with status 1, after the headline
    (``bench.py`` exits 0 after a failed report; ROADMAP C38);
  * the report's numbers, unrounded, follow it as ``roofline: {...}``,
    and the last line on stderr gives the kernels' launch counts, after
    the timed steps and at the end: ``launches: {"steps": {...}, "all":
    {...}}``.

On the card the step runs the tile kernels K1 (with rows), K2 and K3
(``use_pallas=True``) as a CUDA graph (``train/graphs.py``), as
``bench.py`` times a jitted step; on the CPU the scan path, eagerly, as
``bench.py`` picks Pallas on a TPU only.  K4 (``cuda_build.compile_smoke``)
is the build-and-launch check that runs first; the kernel build cache of
``ops/cuda_build.py`` plays the part of ``bench.py``'s XLA compile cache,
and the first step's time, printed as ``first step (capture)`` (the
warm-up, the capture and one replay), that of its first compile.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

# NVIDIA A100 splatfacto proxy (see the module docstring)
REFERENCE_ITERS_PER_SEC = 20.0

# the flagship scene (bench.py:40-45)
WIDTH, HEIGHT = 800, 800
N_GAUSSIANS = 100_000
CAPACITY = 131_072
SH_DEGREE = 3
WARMUP_STEPS = 5
TIMED_STEPS = 40
CHUNK = 10  # window size; headline = MEDIAN window rate (see timed loop)
# fp32 operations per scanned (entry, pixel) pair of K2 and K3 (the model
# of bench.py:273-280)
FWD_OPS_PER_PAIR, BWD_OPS_PER_PAIR = 34, 76

START = time.time()
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "420"))

_lock = threading.Lock()
_headline = {
    "metric": "train_iters_per_sec_800x800_100k_gaussians",
    "value": 0.0,
    "unit": "iters/sec",
    "vs_baseline": 0.0,
    "device": None,
    "power_limit_w": None,
}
_note: str | None = "build_did_not_finish"
_printed = threading.Event()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def remaining() -> float:
    return BUDGET_S - (time.time() - START)


def set_headline(iters_per_sec: float, note: str | None) -> None:
    global _note
    with _lock:
        _headline["value"] = round(iters_per_sec, 3)
        _headline["vs_baseline"] = round(
            iters_per_sec / REFERENCE_ITERS_PER_SEC, 3)
        _note = note


def set_device(name: str, power_limit_w: float | None) -> None:
    with _lock:
        _headline["device"] = name
        _headline["power_limit_w"] = power_limit_w


def emit() -> None:
    """Print the headline JSON exactly once (thread-safe)."""
    with _lock:
        if _printed.is_set():
            return
        _printed.set()
        h = dict(_headline)
        if _note:
            h["note"] = _note
        print(json.dumps(h), flush=True)


def _watchdog() -> None:
    wait = remaining() - 20.0
    if wait > 0:
        time.sleep(wait)
    if not _printed.is_set():
        log(f"bench watchdog: budget {BUDGET_S:.0f}s nearly spent — emitting "
            "best-known headline and exiting")
        emit()
        sys.stdout.flush()
        os._exit(0)


def power_limit_w() -> float | None:
    """The card's power limit (W) as nvidia-smi reports it; None where it
    cannot be read."""
    from touchgs_torch.utils.profiling import card

    try:
        return float(card().rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def launch_counts() -> dict:
    """The kernels' launch counters (``cuda_build.launches``), by key."""
    from touchgs_torch.ops import cuda_build

    return dict(cuda_build.launches)


def build_state_and_step(device="cuda", width: int = WIDTH,
                         height: int = HEIGHT, n: int = N_GAUSSIANS,
                         capacity: int = CAPACITY):
    """(cfg, state, step, cam, image, depth, unc) of ``bench.py:121-171``
    on ``device``: the tile kernels on CUDA, the scan path on the CPU."""
    from touchgs_torch.config import (
        DensifyConfig, DepthLossConfig, ModelConfig, OptimConfig,
        RasterizeConfig, TrainConfig,
    )
    from touchgs_torch.models.densify import DensifyState
    from touchgs_torch.models.gaussians import init_random
    from touchgs_torch.tools.pair_stats import bench_camera
    from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam
    from touchgs_torch.train.trainer import TrainState, make_train_step

    device = torch.device(device)
    cfg = TrainConfig(
        model=ModelConfig(max_gaussians=capacity, sh_degree=SH_DEGREE,
                          rasterize=RasterizeConfig(
                              use_pallas=(device.type == "cuda"))),
        depth=DepthLossConfig(),
        densify=DensifyConfig(),
        optim=OptimConfig(),
    )
    params = init_random(n=n, capacity=capacity, sh_degree=SH_DEGREE,
                         device=device)
    optimizer = FusedAdam(cfg.optim)
    state = TrainState(
        params=params,
        opt_state=optimizer.init({g: getattr(params, g)
                                  for g in PARAM_GROUPS}),
        densify=DensifyState.zeros(capacity, device),
        step=0,
    )
    cam = bench_camera(width, height, device)
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    image = f32(rng.uniform(0, 1, (height, width, 3)))
    depth = f32(rng.uniform(1.0, 3.0, (height, width)))
    unc = torch.ones((height, width), dtype=torch.float32, device=device)
    step = make_train_step(cfg, optimizer)
    return cfg, state, step, cam, image, depth, unc


def census(cfg, state, cam) -> dict:
    """The tile lists of the state's view as ``bench.py:176-231`` takes
    them: projection and binning of the state's parameters (colours
    |sh_dc|), then ``tile_census``."""
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops.projection import project_gaussians
    from touchgs_torch.ops.tiles import bin_gaussians

    rcfg = cfg.model.rasterize
    p = state.params
    with torch.no_grad():
        opac = p.opacities()
        proj = project_gaussians(
            p.means, p.quats, p.scales(), cam.w2c, cam.fx, cam.fy, cam.cx,
            cam.cy, cam.width, cam.height, rcfg, extra_valid=p.alive,
            opacities=opac)
        bins = bin_gaussians(proj, cam.width, cam.height, rcfg)
        attrs = rc._pack_attrs(proj, p.sh_dc.abs(), opac)
    c = tile_census(rcfg, bins, attrs)
    c["x"]["proj"] = proj
    return c


def tile_census(rcfg, bins, attrs) -> dict:
    """The census of one view's ``bins`` and packed ``attrs`` through K1
    with rows and K2 (their plain versions for CPU tensors): the pairs,
    those kept at ``rcfg.k_tile``, the entries K2 scanned
    (``chunks_done · k_chunk`` summed, from row 6 of its stack), the lossy
    tiles (capped, with more than 10% of their pixels at T > 1e-3 when
    the scan ended) and the distinct rows the lists name.  Also returns
    the kernels' inputs and outputs under "x" for the timings."""
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops import rasterize_plain as plain

    th, tw, k_tile, kc = rcfg.tile_h, rcfg.tile_w, rcfg.k_tile, rcfg.k_chunk
    n_tiles = bins.n_tiles_x * bins.n_tiles_y
    with torch.no_grad():
        capped = torch.clamp(bins.tile_counts, max=k_tile).contiguous()
        k1_args = (attrs, bins.sorted_gauss, bins.tile_starts, capped,
                   n_tiles, k_tile, attrs.shape[0] - plain.DEAD_SPREAD)
        gidx, rows = rc.slot_rows(*k1_args)
        n_chunks = ((capped + kc - 1) // kc).to(torch.int32)
        tids = torch.arange(n_tiles, dtype=torch.int32, device=attrs.device)
        geom = (th, tw, k_tile, kc, bins.n_tiles_x, rcfg)
        stack = rc.forward_tiles(n_chunks, tids, rows, *geom)
        counts = bins.tile_counts.cpu().numpy().astype(np.int64)
        done = stack[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
        unsat = (stack[:, plain.ROW_T] > 1e-3).float().mean(dim=-1)
        lossy = int(((bins.tile_counts > k_tile) & (unsat > 0.1)).sum())
        distinct = int(torch.unique(gidx).numel())
    return dict(
        k_tile=k_tile, n_tiles=n_tiles, total=int(counts.sum()),
        kept=int(np.minimum(counts, k_tile).sum()),
        scanned=int(done.sum()) * kc, lossy=lossy, mean=float(counts.mean()),
        distinct=distinct,
        x=dict(bins=bins, k1_args=k1_args, rows=rows, n_chunks=n_chunks,
               tids=tids, geom=geom, stack=stack, done=done))


def roofline_report(cfg, state, cam, dt_per_step: float) -> dict:
    """Per-stage roofline of the step at the bench's state
    (``bench.py:174-289``), printed to stderr and returned: the census,
    then CUDA-event times of K1 with rows, K2, K3 (with a ones gradient),
    the forward render, forward + backward of sum(rgb) + sum(depth) with
    respect to the means, projection, and binning as (project + bin) −
    project, each beside its bound on the port's ``H100`` spec.  K1 with
    rows has its own row: it writes the rows ``attrs[gidx]`` that
    ``bench.py`` gathers apart.  The render's bound is the sum of its
    stages' (each waits for the one before): projection, binning, K1 and
    K2, and for forward + backward also K3.  Binning's is the JAX
    package's model (``profiling.binning_cost``: merge passes over the
    capped pairs), which overstates the bytes of the card's radix sort."""
    from touchgs_torch.models.splatfacto import render
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops import rasterize_plain as plain
    from touchgs_torch.ops.projection import project_gaussians
    from touchgs_torch.ops.tiles import bin_gaussians
    from touchgs_torch.utils import profiling as prof

    rcfg = cfg.model.rasterize
    c = census(cfg, state, cam)
    x = c["x"]
    p = state.params
    th, tw, k_tile, kc, n_tx, _ = x["geom"]
    npix, n_tiles, slots = th * tw, c["n_tiles"], c["n_tiles"] * k_tile
    grad_stack = torch.ones_like(x["stack"])

    def k1(*args):
        return rc.slot_rows(*args)

    def k2(nc, tids, rows):
        return rc.forward_tiles(nc, tids, rows, *x["geom"])

    def k3(done, tids, rows, fs, gs):
        return rc.backward_tiles(done, tids, rows, fs, gs, *x["geom"])

    def proj_of(q, means=None):
        return project_gaussians(
            q.means if means is None else means, q.quats, q.scales(),
            cam.w2c, cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
            rcfg, extra_valid=q.alive, opacities=q.opacities())

    @torch.no_grad()
    def proj_only(q):
        return proj_of(q)

    @torch.no_grad()
    def prep(q):
        return bin_gaussians(proj_of(q), cam.width, cam.height, rcfg)

    @torch.no_grad()
    def fwd_only(q):
        out, _ = render(q, cam, cfg.model, active_sh_degree=SH_DEGREE)
        return out.rgb

    def fwd_bwd(q):
        means = q.means.detach().requires_grad_(True)
        out, _ = render(dataclasses.replace(q, means=means), cam, cfg.model,
                        active_sh_degree=SH_DEGREE)
        return torch.autograd.grad(out.rgb.sum() + out.depth.sum(), means)[0]

    t = {
        "slot_rows": prof.measure(k1, *x["k1_args"], iters=10),
        "composite_fwd": prof.measure(k2, x["n_chunks"], x["tids"],
                                      x["rows"], iters=10),
        "composite_bwd": prof.measure(k3, x["done"], x["tids"], x["rows"],
                                      x["stack"], grad_stack, iters=10),
        "render_fwd": prof.measure(fwd_only, p, iters=10),
        "render_fwd_bwd": prof.measure(fwd_bwd, p, iters=10),
        "projection": prof.measure(proj_only, p, iters=10),
    }
    t["binning"] = max(prof.measure(prep, p, iters=10) - t["projection"],
                       0.0)

    # projection: its inputs read once and its outputs written once
    proj_in = (p.means, p.quats, p.log_scales, p.logit_opacities, p.alive)
    proj_bytes = (sum(a.numel() * a.element_size() for a in proj_in)
                  + sum(a.numel() * a.element_size() for a in x["proj"]
                        if a is not None))
    row_bytes = plain.A * 4
    stages = [
        prof.StageCost("projection", 0.0, float(proj_bytes)),
        prof.binning_cost(p.capacity, rcfg.max_tiles_per_gaussian),
        # K1 with rows: the starts and counts, the listed indices and the
        # distinct rows they name read once; the lists and rows written
        prof.StageCost("slot_rows", 0.0, float(
            4 * (2 * n_tiles + c["kept"] + slots)
            + row_bytes * (c["distinct"] + slots))),
        prof.composite_cost(c["scanned"], npix, n_tiles, "composite_fwd",
                            FWD_OPS_PER_PAIR),
        prof.composite_cost(c["scanned"], npix, n_tiles, "composite_bwd",
                            BWD_OPS_PER_PAIR),
    ]
    log(prof.report(stages, t, prof.H100))
    bound_ms = {s.name: s.roofline_time(prof.H100) * 1e3 for s in stages}
    bound_ms["render_fwd"] = sum(bound_ms[k] for k in (
        "projection", "binning", "slot_rows", "composite_fwd"))
    bound_ms["render_fwd_bwd"] = (bound_ms["render_fwd"]
                                  + bound_ms["composite_bwd"])
    total, kept, scanned = c["total"], c["kept"], c["scanned"]
    log(f"tile lists: {total} pairs, mean {c['mean']:.0f}/tile"
        f", cap {k_tile} keeps {kept} "
        f"({100 * kept / max(total, 1):.1f}%); "
        f"kernels scanned {scanned} "
        f"({100 * scanned / max(total, 1):.1f}% — early exit); "
        f"lossy-truncated tiles (capped & unsaturated): "
        f"{c['lossy']}/{n_tiles}")
    log(f"render fwd: {t['render_fwd']*1e3:.2f} ms (bound "
        f"{bound_ms['render_fwd']:.3f}; kernel "
        f"{t['composite_fwd']*1e3:.2f})   render fwd+bwd: "
        f"{t['render_fwd_bwd']*1e3:.2f} ms (bound "
        f"{bound_ms['render_fwd_bwd']:.3f}; bwd kernel "
        f"{t['composite_bwd']*1e3:.2f})   full step: {dt_per_step*1e3:.2f} "
        f"ms (loss/opt tail: {(dt_per_step - t['render_fwd_bwd'])*1e3:.2f} "
        f"ms)")
    return dict(
        census={k: c[k] for k in ("k_tile", "n_tiles", "total", "kept",
                                  "scanned", "lossy", "distinct")},
        ms={k: v * 1e3 for k, v in t.items()},
        bound_ms=bound_ms, step_ms=dt_per_step * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (never chosen without this flag)")
    args = ap.parse_args(argv)
    threading.Thread(target=_watchdog, daemon=True).start()

    if args.cpu:
        device = torch.device("cpu")
        set_device("cpu", None)
    elif not torch.cuda.is_available():
        log("bench_torch: no CUDA device; nothing was timed (pass --cpu to "
            "run on the CPU)")
        set_headline(0.0, "no_cuda_device")
        emit()
        return 1
    else:
        device = torch.device("cuda")
        # the port's kernels and losses are fp32 without TF32 (ROADMAP C1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        set_device(torch.cuda.get_device_name(0), power_limit_w())
    log(f"device: {_headline['device']}, power limit "
        f"{_headline['power_limit_w']} W")

    # K4 once: fail fast if the kernels do not build or launch (on the
    # CPU its plain version runs)
    from touchgs_torch.ops import cuda_build

    t0 = time.time()
    x = torch.ones((8, 128), dtype=torch.float32, device=device)
    if not torch.equal(cuda_build.compile_smoke(x), x * 2.0):
        raise RuntimeError("K4 compile_smoke gave a wrong result")
    log(f"compile smoke OK on {device.type}: {time.time() - t0:.1f}s "
        f"(build and launch)")

    t0 = time.time()
    cfg, state, step, cam, image, depth, unc = build_state_and_step(
        device, WIDTH, HEIGHT, N_GAUSSIANS, CAPACITY)
    log(f"state and step built: {time.time() - t0:.1f}s")

    # on the card the first step warms up, captures the step as a CUDA
    # graph and replays it once (bench.py:309 compiles it there)
    t0 = time.time()
    state, metrics = step(state, cam, image, depth, unc, SH_DEGREE)
    loss = float(metrics["loss"])
    label = "first step (capture)" if device.type == "cuda" else "first step"
    log(f"{label}: {time.time() - t0:.3f} s loss={loss:.4f}")
    set_headline(0.0, "built_but_untimed")

    for _ in range(WARMUP_STEPS - 1):
        state, metrics = step(state, cam, image, depth, unc, SH_DEGREE)
    _ = float(metrics["loss"])

    # timed loop in fixed windows; every window ends in a host read of the
    # loss, which waits for every kernel queued before it.  The headline is
    # the MEDIAN window rate: robust to a one-off stall, not a cherry-picked
    # best.  Each window's rate includes its own read.
    done_steps = 0
    window_rates = []
    while done_steps < TIMED_STEPS:
        n = min(CHUNK, TIMED_STEPS - done_steps)
        tw0 = time.time()
        for _ in range(n):
            state, metrics = step(state, cam, image, depth, unc, SH_DEGREE)
        _ = float(metrics["loss"])
        window_rates.append(n / (time.time() - tw0))
        done_steps += n
        rate = float(np.median(window_rates))
        set_headline(rate, None if done_steps >= TIMED_STEPS
                     else f"partial_{done_steps}_steps")
    step_counts = launch_counts()
    iters_per_sec = float(np.median(window_rates))
    dt = TIMED_STEPS / iters_per_sec
    log(f"window rates: {[round(r, 2) for r in window_rates]} it/s")
    mpix_per_sec = iters_per_sec * WIDTH * HEIGHT / 1e6
    log(f"{TIMED_STEPS} steps in {dt:.2f}s -> {iters_per_sec:.2f} it/s, "
        f"{mpix_per_sec:.1f} Mpix/s rasterized (fwd+bwd), "
        f"loss={float(metrics['loss']):.4f}")

    emit()  # headline is on stdout before any diagnostics run

    rc = 0
    if device.type != "cuda":
        log("roofline skipped: it times the card")
    elif remaining() > 60:
        try:
            report = roofline_report(cfg, state, cam, dt / TIMED_STEPS)
            log("roofline: " + json.dumps(report))
        except Exception:  # noqa: BLE001  (reported, and the exit is 1)
            traceback.print_exc()
            log("roofline report failed")
            rc = 1
    else:
        log(f"roofline skipped: only {remaining():.0f}s of budget left")
    log("launches: " + json.dumps({"steps": step_counts,
                                   "all": launch_counts()}))
    return rc


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001  (the headline still goes out)
        traceback.print_exc()
        code = 1
    emit()
    # the watchdog thread is daemonic; make the exit explicit and immediate
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
