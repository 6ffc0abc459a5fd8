"""The port's benchmark, ``bench_torch.py``, and its tile-list tool,
``touchgs_torch/tools/pair_stats.py``, against ``bench.py`` and the JAX
package, on the CPU.

``bench.py``'s module constants are patched to 64x64, 500 Gaussians in a
capacity of 1024; ``bench_torch`` takes the same sizes as arguments.  The
JAX bench's state is carried across with ``trainer.state_from_numpy``;
both packages then take 3 steps on the scan path (what the bench picks on
the CPU) and on the kernel path (JAX: Pallas in interpret mode; the port:
the plain versions of K1-K3).  The headline contract is checked in
subprocesses: ``bench_torch`` is never run in this process, because its
watchdog exits the process when its budget runs out.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
from touchgs_tpu.ops import rasterize_pallas as rp
from touchgs_tpu.ops.projection import project_gaussians as j_project
from touchgs_tpu.ops.tiles import bin_gaussians as j_bin
from touchgs_tpu.train import trainer as jtr
from touchgs_tpu.train.optim import make_optimizer
from touchgs_torch.tools import pair_stats
from touchgs_torch.train import trainer as ttr
from touchgs_torch.train.optim import FusedAdam

ROOT = Path(__file__).resolve().parents[1]
W = H = 64
N, CAP = 500, 1024
SMALL = dict(WIDTH=W, HEIGHT=H, N_GAUSSIANS=N, CAPACITY=CAP)
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one intra-op thread for this module (restored after it),
    the faster choice when the suite runs several workers on the same
    cores (ROADMAP.md C18)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_bench():
    """``bench.build_state_and_step()`` at the small size."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SMALL.items():
            mp.setattr(bench, k, v)
        return bench.build_state_and_step()


def _leaves(state) -> dict:
    """The JAX TrainState's leaves as numpy copies."""
    opt = state.opt_state
    return {
        "params": {f.name: np.array(getattr(state.params, f.name))
                   for f in dataclasses.fields(state.params)},
        "count": int(opt.count),
        "mu": {k: np.array(v) for k, v in opt.mu.items()},
        "nu": {k: np.array(v) for k, v in opt.nu.items()},
        "densify": {f.name: np.array(getattr(state.densify, f.name))
                    for f in dataclasses.fields(state.densify)},
        "step": int(state.step),
    }


def _torch_leaves(state) -> dict:
    """The port's TrainState laid out as ``_leaves``."""
    opt = state.opt_state
    return {
        "params": {f.name: getattr(state.params, f.name).numpy()
                   for f in dataclasses.fields(state.params)},
        "count": int(opt.count),
        "mu": {k: v.numpy() for k, v in opt.mu.items()},
        "nu": {k: v.numpy() for k, v in opt.nu.items()},
        "densify": {f.name: getattr(state.densify, f.name).numpy()
                    for f in dataclasses.fields(state.densify)},
        "step": state.step,
    }


def _assert_leaves_equal(got: dict, want: dict, path=""):
    assert set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_leaves_equal(got[k], w, f"{path}{k}.")
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=path + k)
            assert np.asarray(got[k]).dtype == np.asarray(w).dtype, path + k


def _fields(cfg) -> dict:
    """A config's fields as plain values (each package has its own enum
    classes)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg),
                                 default=lambda e: e.value))


def _with_kernels(cfg, **rasterize):
    """``cfg`` with the tile kernels on (and ``rasterize``'s fields)."""
    r = dataclasses.replace(cfg.model.rasterize, use_pallas=True, **rasterize)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rasterize=r))


def _steps(jstep, jstate, jbatch, tstep, tstate, tbatch) -> tuple:
    """STEPS steps of each package; each step's loss and PSNR agree
    within rtol 1e-3 (``tests/test_torch_train.py``'s tolerance).
    Returns both final states."""
    got, want = [], []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, *jbatch, jnp.int32(3))
        tstate, tm = tstep(tstate, *tbatch, 3)
        want.append([float(jm["loss"]), float(jm["psnr"])])
        got.append([float(tm["loss"]), float(tm["psnr"])])
        assert ("lossy_tiles" in jm) == ("lossy_tiles" in tm)
        if "lossy_tiles" in jm:
            assert int(tm["lossy_tiles"]) == int(jm["lossy_tiles"])
    print(f"loss, psnr by step: port {got}, JAX {want}")
    np.testing.assert_allclose(got, want, rtol=1e-3)
    return jstate, tstate


@pytest.fixture(scope="module")
def port_bench():
    return bench_torch.build_state_and_step("cpu", W, H, N, CAP)


def test_state_and_scan_steps_match_bench(port_bench):
    """``build_state_and_step`` against ``bench.py``'s: the same config;
    the JAX state carried across equals the port's own bit for bit (the
    init is numpy in both); camera, image, depth and uncertainty equal bit
    for bit; 3 scan-path steps agree."""
    cfg, jstate, jstep, *jbatch = _jax_bench()
    tcfg, tstate, tstep, *tbatch = port_bench
    assert not cfg.model.rasterize.use_pallas
    assert _fields(tcfg) == _fields(cfg)
    leaves = _leaves(jstate)
    _assert_leaves_equal(_torch_leaves(tstate), leaves)
    carried = ttr.state_from_numpy(leaves, "cpu")
    _assert_leaves_equal(_torch_leaves(carried), leaves)

    jcam, tcam = jbatch[0], tbatch[0]
    assert (tcam.width, tcam.height) == (jcam.width, jcam.height) == (W, H)
    for f in ("fx", "fy", "cx", "cy", "c2w"):
        want = np.asarray(getattr(jcam, f))
        got = getattr(tcam, f).numpy()
        assert got.dtype == want.dtype == np.float32, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for name, j, t in zip(("image", "depth", "unc"), jbatch[1:], tbatch[1:]):
        assert t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)

    _steps(jstep, jstate, jbatch, tstep, carried, tbatch)


def test_kernel_path_steps_match_bench(port_bench):
    """The same 3 steps with ``use_pallas=True`` on both sides, built from
    the bench's config: JAX's Pallas kernels in interpret mode, the port's
    K1-K3 wrappers on their plain versions (CPU tensors)."""
    cfg, jstate, _, *jbatch = _jax_bench()
    tcfg, _, _, *tbatch = port_bench
    jcfg, tcfg = _with_kernels(cfg), _with_kernels(tcfg)
    jstep = jtr.make_train_step(jcfg, make_optimizer(jcfg.optim))
    tstep = ttr.make_train_step(tcfg, FusedAdam(tcfg.optim))
    carried = ttr.state_from_numpy(_leaves(jstate), "cpu")
    _steps(jstep, jstate, jbatch, tstep, carried, tbatch)


@pytest.fixture(scope="module")
def trained():
    """The JAX bench's state after 3 scan-path steps, its config and camera,
    and the port's copy of that state."""
    cfg, jstate, jstep, *jbatch = _jax_bench()
    for _ in range(STEPS):
        jstate, _ = jstep(jstate, *jbatch, jnp.int32(3))
    return cfg, jstate, jbatch[0], ttr.state_from_numpy(_leaves(jstate),
                                                        "cpu")


def _jax_census(cfg, p, cam) -> dict:
    """``bench.py:182-231``'s census with the kernels in interpret mode
    (``bench.py`` hard-codes ``interpret=False``, so its arithmetic is
    repeated here)."""
    rcfg = cfg.model.rasterize
    proj = j_project(p.means, p.quats, p.scales(), cam.w2c, cam.fx, cam.fy,
                     cam.cx, cam.cy, W, H, rcfg, extra_valid=p.alive,
                     opacities=p.opacities())
    bins = j_bin(proj, W, H, rcfg)
    n_tx, n_ty = int(bins.n_tiles_x), int(bins.n_tiles_y)
    n_tiles = n_tx * n_ty
    k_tile, kc = rcfg.k_tile, rcfg.k_chunk
    counts = np.asarray(bins.tile_counts, dtype=np.int64)
    attrs = rp._pack_attrs(proj, jnp.abs(p.sh_dc), p.opacities())
    capped = jnp.minimum(bins.tile_counts, k_tile)
    gidx = rp._slot_lists(bins.sorted_gauss, bins.tile_starts, capped,
                          n_tiles, k_tile, proj.means2d.shape[0], True)
    nc = ((capped + kc - 1) // kc).astype(jnp.int32)
    tids = jnp.arange(n_tiles, dtype=jnp.int32)
    stack = rp._forward_tiles(nc, tids, attrs[gidx], rcfg.tile_h,
                              rcfg.tile_w, k_tile, kc, n_tx, rcfg, True)
    done = np.asarray(stack[:, rp._ROW_DONE, 0], dtype=np.int64)
    unsat = np.asarray((stack[:, rp._ROW_T] > 1e-3).mean(axis=-1))
    return dict(k_tile=k_tile, n_tiles=n_tiles, total=int(counts.sum()),
                kept=int(np.minimum(counts, k_tile).sum()),
                scanned=int(done.sum()) * kc,
                lossy=int(((counts > k_tile) & (unsat > 0.1)).sum()))


@pytest.mark.parametrize("k_tile", [128, 512])
def test_census_matches_jax(trained, port_bench, k_tile):
    """The roofline report's census of the trained state (pairs, kept at
    the cap, entries K2 scanned, lossy tiles) equals the JAX package's
    exactly.  At k_tile 128 every tile is capped and unsaturated; at the
    default 512 none is capped."""
    cfg, jstate, jcam, tstate = trained
    want = _jax_census(_with_kernels(cfg, k_tile=k_tile), jstate.params,
                       jcam)
    tcfg = _with_kernels(port_bench[0], k_tile=k_tile)
    got = bench_torch.census(tcfg, tstate, port_bench[3])
    assert {k: got[k] for k in want} == want
    print(f"census at k_tile {k_tile}: {want}")
    lossy = want["n_tiles"] if k_tile == 128 else 0
    assert want["lossy"] == lossy and want["kept"] <= want["total"]


def _run(args, env=None, code=None, timeout=120):
    cmd = [sys.executable] + (["-c", code] if code else
                              [str(ROOT / "bench_torch.py")]) + args
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=dict(os.environ, **(env or {})))


def _headline(r) -> dict:
    lines = r.stdout.splitlines()
    assert len(lines) == 1, r.stdout
    h = json.loads(lines[0])
    assert h["metric"] == "train_iters_per_sec_800x800_100k_gaussians"
    assert h["unit"] == "iters/sec"
    # the program rounds the raw rate r twice (value = round(r, 3),
    # vs_baseline = round(r / 20, 3)), so vs_baseline is round(r / 20, 3)
    # for some r that rounds to value
    lo = round((h["value"] - 5e-4) / 20.0, 3)
    hi = round((h["value"] + 5e-4) / 20.0, 3)
    assert lo <= h["vs_baseline"] <= hi, h
    return h


def test_watchdog_prints_one_line_and_exits_0():
    """With 21 s of budget the watchdog fires 1 s after import, during the
    full-size set-up on the CPU: one line with the best-known rate (none
    yet) and a note, exit 0.  Without the watchdog the run would take
    minutes on the CPU; the bound leaves room for the interpreter's start
    and the torch import before the budget's clock starts."""
    t0 = time.time()
    r = _run(["--cpu"], env={"BENCH_BUDGET_S": "21"})
    elapsed = time.time() - t0
    assert r.returncode == 0, r.stderr[-2000:]
    h = _headline(r)
    assert h["value"] == 0.0 and h["note"] and h["device"] == "cpu"
    assert h["power_limit_w"] is None
    assert "bench watchdog" in r.stderr
    assert elapsed < 60, elapsed


def test_no_card_exits_nonzero_without_a_rate():
    """Without ``--cpu`` and with no card visible it never falls back to
    the CPU: exit 1, value 0.0 and a note naming the missing card."""
    r = _run([], env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1
    h = _headline(r)
    assert h["value"] == 0.0 and h["note"] == "no_cuda_device"
    assert "no CUDA device" in r.stderr


def test_emit_prints_once_from_two_threads():
    code = ("import threading, bench_torch as b\n"
            "go = threading.Barrier(2)\n"
            "def f():\n"
            "    go.wait()\n"
            "    b.emit()\n"
            "ts = [threading.Thread(target=f) for _ in range(2)]\n"
            "[t.start() for t in ts]\n"
            "[t.join(timeout=30) for t in ts]\n"
            "assert not any(t.is_alive() for t in ts)\n"
            "b.emit()\n")
    r = _run([], code=code)
    assert r.returncode == 0, r.stderr[-2000:]
    h = _headline(r)
    assert h["note"] == "build_did_not_finish"


def test_main_on_cpu_end_to_end():
    """``main(["--cpu"])`` at the small size with 2 warm-up and 4 timed
    steps in windows of 2: one line with a positive rate and no note, the
    roofline skipped (it times the card), the launch line last on stderr
    with no kernel launched (the CPU runs the plain versions)."""
    code = ("import sys, bench_torch as b\n"
            "b.WIDTH = b.HEIGHT = 64; b.N_GAUSSIANS = 500; b.CAPACITY = 1024\n"
            "b.WARMUP_STEPS, b.TIMED_STEPS, b.CHUNK = 2, 4, 2\n"
            "sys.exit(b.main(['--cpu']))\n")
    r = _run([], code=code, env={"OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    h = _headline(r)
    assert h["value"] > 0 and "note" not in h and h["device"] == "cpu"
    assert "roofline skipped: it times the card" in r.stderr
    last = r.stderr.strip().splitlines()[-1]
    assert last.startswith("launches: ")
    counts = json.loads(last[len("launches: "):])
    assert set(counts) == {"steps", "all"}
    assert all(v == 0 for c in counts.values() for v in c.values()), counts


def test_pair_stats_match_jax(trained, capsys):
    """``pair_stats.main`` at the small size: the per-tile counts, radii
    and cull radii equal the JAX package's ``project_gaussians`` and
    ``bin_gaussians`` on the same initial state, and so do the printed
    statistics."""
    cfg, _, jcam, _ = trained
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SMALL.items():
            mp.setattr(bench, k, v)
        p = bench.build_state_and_step()[1].params
    rcfg = type(cfg.model.rasterize)()
    proj = j_project(p.means, p.quats, p.scales(), jcam.w2c, jcam.fx,
                     jcam.fy, jcam.cx, jcam.cy, W, H, rcfg,
                     extra_valid=p.alive, opacities=p.opacities())
    counts = np.asarray(j_bin(proj, W, H, rcfg).tile_counts, np.int64)
    valid = np.asarray(proj.valid)
    k_tile = 256
    got = pair_stats.main(k_tile, "cpu", W, H, N, CAP)
    np.testing.assert_array_equal(got["tile_counts"], counts)
    np.testing.assert_array_equal(got["radii"], np.asarray(proj.radii))
    np.testing.assert_array_equal(got["cull_radii"],
                                  np.asarray(proj.cull_radii))
    kept = int(np.minimum(counts, k_tile).sum())
    assert (got["total"], got["kept"], got["dropped"], got["max"]) == (
        int(counts.sum()), kept, int(counts.sum()) - kept, int(counts.max()))
    assert got["valid"] == int(valid.sum()) == N
    assert got["mean_radius"] == float(np.asarray(proj.radii)[valid].mean())
    assert f"total pairs: {counts.sum()}" in capsys.readouterr().out
    if not torch.cuda.is_available():  # it never falls back to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            pair_stats.main(k_tile, "cuda", W, H, N, CAP)
