"""The readers of the program's own account (``Trainer.events`` diffed over
the window): the stage metrics, the capture, stall and read metrics, on a
synthetic record, on a program that keeps no such account (they read
nothing and raise nothing), and on a CPU window of the tiny cell."""
import pytest
import torch

from conftest import ROOT

STAGES = ("shade", "bin", "composite", "loss", "backward", "adam", "stats")
NEW = ("graph_step_ms", "shade_ms", "bin_ms", "composite_ms", "loss_ms",
       "backward_ms", "adam_ms", "capture_ms", "host_stall_ms",
       "host_reads_per_step")


def _reader(name):
    from perfbench import harness

    return harness.Bench(ROOT).reader(name)


def _record(events: dict, steps: int = 200) -> dict:
    return {"window": {"steps": steps, "seconds": 2.0, "events": events,
                       "t0": 0.0}}


def test_readers_of_a_synthetic_window():
    ms = dict(zip(STAGES, (0.5, 0.25, 1.0, 1.5, 4.5, 0.5, 0.25)))
    ev = {"grow": 1, "refine": 2, "reset_opacity": 0, "capture": 4,
          "capture_ms": 600.0, "host_reads": 50, "stage_samples": 4,
          **{f"stage_{s}_ms": 4 * v for s, v in ms.items()},
          "host_fetch_ms": 10.0, "host_dispatch_ms": 1500.0,
          "host_read_ms": 300.0, "host_refine_ms": 14.0,
          "host_grow_ms": 6.0, "host_reset_ms": 2.0, "host_log_ms": 8.0,
          "host_ckpt_ms": 0.0}
    r = _record(ev)
    got = {n: _reader(n)(r) for n in NEW}
    assert got["graph_step_ms"] == pytest.approx(sum(ms.values()))
    for s in ("shade", "bin", "composite", "loss", "backward", "adam"):
        assert got[f"{s}_ms"] == pytest.approx(ms[s]), s
    # the seven stages add up to the step
    assert (sum(got[f"{s}_ms"] for s in STAGES[:-1]) + ms["stats"]
            == pytest.approx(got["graph_step_ms"]))
    assert got["capture_ms"] == pytest.approx(150.0)
    assert got["host_stall_ms"] == pytest.approx((14 + 6 + 2 + 8 + 600) / 200)
    assert got["host_reads_per_step"] == pytest.approx(0.25)


def test_readers_of_a_program_without_the_account():
    """The counts alone, as a program before the account reports: every
    new reader returns None."""
    r = _record({"grow": 0, "refine": 0, "reset_opacity": 0, "capture": 0})
    assert {n: _reader(n)(r) for n in NEW} == dict.fromkeys(NEW)
    # a window without a sampled replay or a capture reads nothing there
    r = _record({"capture": 0, "capture_ms": 0.0, "stage_samples": 0,
                 "stage_shade_ms": 0.0})
    assert _reader("graph_step_ms")(r) is None
    assert _reader("shade_ms")(r) is None
    assert _reader("capture_ms")(r) is None


def test_readers_on_a_cpu_window(checkout):
    """The tiny cell's window on the CPU: no replay, so no stage sample;
    the reads of each call's log point counted; the host spans cover the
    window's wall time."""
    from perfbench import harness

    torch.set_num_threads(2)
    b = harness.Bench(checkout)
    w = b.cell("tiny.quick")
    tr = b.traffic(w["traffic"])
    run = b.driver(tr["driver"]).setup(b.config(w["config"]), tr, 2**33 + 9,
                                       torch.device("cpu"))
    win = run.window(0.2)
    r = {"window": win}
    assert _reader("graph_step_ms")(r) is None
    assert _reader("capture_ms")(r) is None
    # a call of two steps ends in a log point: 7 metrics and the guard's max
    assert _reader("host_reads_per_step")(r) >= 8 / tr["period"]
    assert _reader("host_stall_ms")(r) > 0
    spans = sum(v for k, v in win["events"].items()
                if k.startswith("host_") and k.endswith("_ms"))
    assert 0.9 <= spans / (1e3 * win["seconds"]) <= 1.0, win
