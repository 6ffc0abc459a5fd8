"""The readers of the deep-tile metrics (``tile_fill_pct``,
``raster_bwd_ms``) on a synthetic window, on a program that keeps no such
account (they read nothing and raise nothing) and on a CPU window of a tiny
cut of ``bunny_real_1m``; and the configuration against the program's
preset."""
import json

import pytest
import torch

from conftest import ROOT, LIMITS, add_cell, polish, tiny_config

NEW = ("tile_fill_pct", "raster_bwd_ms")


def _reader(name):
    from perfbench import harness

    return harness.Bench(ROOT).reader(name)


def _record(events: dict, steps: int = 200) -> dict:
    return {"window": {"steps": steps, "seconds": 2.0, "events": events,
                       "t0": 0.0}}


def test_readers_of_a_synthetic_window():
    """Fill: entries over slots, in percent; the nested stage: its
    milliseconds over the stage samples, whatever the stages' sum."""
    ev = {"stage_samples": 4, "stage_loss_ms": 0.8, "stage_backward_ms": 20.0,
          "nested_raster_bwd_ms": 12.0, "tile_entries": 5_632_000,
          "tile_slots": 4 * 625 * 8192, "tile_samples": 4}
    r = _record(ev)
    assert _reader("tile_fill_pct")(r) == pytest.approx(27.5)
    assert _reader("raster_bwd_ms")(r) == pytest.approx(3.0)
    # the nested stage is left out of the stages' sum
    assert _reader("graph_step_ms")(r) == pytest.approx(20.8 / 4)
    assert _reader("backward_ms")(r) == pytest.approx(5.0)


def test_readers_of_a_program_without_the_account():
    """A program before these counters (the parent's events): None."""
    r = _record({"grow": 0, "capture": 0, "stage_samples": 3,
                 "stage_backward_ms": 12.0})
    assert {n: _reader(n)(r) for n in NEW} == dict.fromkeys(NEW)
    # no replay sampled, no slot counted: nothing to read
    r = _record({"stage_samples": 0, "nested_raster_bwd_ms": 0.0,
                 "tile_entries": 0, "tile_slots": 0, "tile_samples": 0})
    assert {n: _reader(n)(r) for n in NEW} == dict.fromkeys(NEW)


def test_config_loads_as_the_programs_preset():
    """``bunny_real_1m``: the program's ``bunny_real`` preset (depth
    ×0.005, uncertainty-weighted, weight 0.01, split 0.08), 1,000,000
    live of 1,048,576, and the guard's cap equal to its ceiling, so that no
    escalation, and no capture, falls in a window."""
    from perfbench import harness, job

    b = harness.Bench(ROOT)
    cfg = b.config("bunny_real_1m")
    tc = job.train_config(cfg, 7)
    assert tc.depth.depth_loss_mult == 0.005
    assert tc.depth.depth_loss_type.value == "DEPTH_UNCERTAINTY_WEIGHTED_LOSS"
    assert tc.depth.uncertainty_weight == 0.01
    assert cfg["scene"]["train_split_fraction"] == 0.08
    assert (cfg["state"]["live_gaussians"], tc.model.max_gaussians) == (
        1_000_000, 1_048_576)
    r = tc.model.rasterize
    assert r.k_tile == r.k_tile_max_train > 4096
    assert cfg["reduced"] == []
    assert b.cell("real1m.polish")["chips"] == 1
    assert set(b.limits("real1m.polish")) == {
        "loss_gap", "grad_gap", "change_gap", "stats_gap"}
    bad = json.loads(json.dumps(cfg))
    bad["train"]["depth"]["depth_loss_mult"] = 0.2
    with pytest.raises(ValueError):
        job.train_config(bad, 7)


def test_readers_on_a_cpu_window_of_a_tiny_real_cell(checkout):
    """A tiny cut of ``bunny_real_1m`` (fused depth, uncertainty weight
    0.01) through the polish driver on the CPU: correct, and the tile
    lists of each log point counted (no replay, so no stage sample and no
    nested stage)."""
    from perfbench import harness

    torch.set_num_threads(2)
    cfg = tiny_config("tinyr", "bunny_real_1m")
    cfg["scene"]["views"] = 50         # 4 train views at 0.08
    cell = add_cell(checkout, "tinyr", cfg, "quick3", polish(), LIMITS)
    r = harness.run_cell(checkout, cell, 2**33 + 21, 0.1, False, "cpu")
    assert r["correct"], r["compared"]
    b = harness.Bench(checkout)
    run = b.driver("resumed_job").setup(b.config("tinyr"), polish(), 5,
                                        torch.device("cpu"))
    win = run.window(0.2)
    ev = win["events"]
    fill = b.reader("tile_fill_pct")({"window": win})
    assert ev["tile_samples"] >= 1
    # 64x48 in 32x32 tiles: 4 tiles, at the k_tile of the mix's checkpoint
    assert ev["tile_slots"] == ev["tile_samples"] * 4 * 1024
    assert 0 < fill < 100
    assert b.reader("raster_bwd_ms")({"window": win}) is None
