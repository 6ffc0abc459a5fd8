"""A cell, a traffic mix, a kind of traffic and a per-layer metric come in
as new files and new entries of BENCHMARK.json, with no edit to a file
already there."""
import json

import torch

from conftest import (GROWTH_LIMITS, LIMITS, add_cell, add_growth_cell,
                      polish, tiny_config)

TOY_DRIVER = '''"""A kind of traffic of its own: sums of rows of a random matrix, a
fixed number of them, against numpy."""
import time

import numpy as np
import torch


class Toy:
    def __init__(self, traffic, seed, device):
        g = torch.Generator(device=device).manual_seed(seed)
        n = traffic["rows"]
        self.a = torch.rand((n, traffic["width"]), generator=g,
                            device=device, dtype=torch.float64)
        self.host = self.a.cpu().numpy()
        self.traffic, self.sums = traffic, []

    def window(self, seconds, record=None):
        t0 = time.perf_counter()
        for i in range(self.traffic["rows"]):
            self.sums.append(float(self.a[i].sum()))
        return dict(steps=len(self.sums), seconds=time.perf_counter() - t0,
                    events={}, t0=t0)

    def report(self, log):
        print(f"toy: {len(self.sums)} sums", file=log)

    def free(self):
        self.a = None

    def readings(self, device):
        want = self.host.sum(axis=1)
        return {"toy_gap": float(np.abs(np.array(self.sums) - want).max())}

    def work(self, record, device):
        return None


def setup(cfg, traffic, seed, device, log=None):
    return Toy(traffic, seed, device)
'''


def test_new_cell_runs_on_the_cpu(checkout):
    from perfbench import harness

    torch.set_num_threads(2)
    r = harness.run_cell(checkout, "tiny.quick", 2**33 + 5, 0.2, False,
                         "cpu")
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 2
    assert set(r["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert list(r)[-1] == "compared"
    assert set(r["compared"]) == set(LIMITS)


def test_new_mirror_cell_and_traffic(checkout):
    """A second configuration (the mirror preset's fused depth and
    uncertainty) and a second traffic file, both new."""
    from perfbench import harness

    torch.set_num_threads(2)
    cell = add_cell(checkout, "tinym", tiny_config("tinym", "mirror_1280x720"),
                    "quick2", polish(), LIMITS)
    r = harness.run_cell(checkout, cell, 11, 0.1, False, "cpu")
    assert r["correct"], r["compared"]


def test_new_kind_of_traffic_with_its_own_driver(checkout):
    """A driver module of its own (its own set-up, window and check) and a
    traffic file that names it, added beside the others."""
    from perfbench import harness

    (checkout / "perfbench" / "drivers" / "toy_sums.py").write_text(
        TOY_DRIVER)
    cell = add_cell(checkout, "toycfg", {"name": "toycfg"}, "toy",
                    {"driver": "toy_sums", "rows": 40, "width": 1000},
                    {"toy_gap": 1e-9})
    r = harness.run_cell(checkout, cell, 2**32 + 3, 0.1, False, "cpu")
    assert r["correct"], r["compared"]
    assert r["attempted"] == 40
    assert set(r["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert r["compared"]["toy_gap"]["value"] < 1e-9


def test_new_metric_is_found_by_name(checkout):
    from perfbench import harness

    (checkout / "perfbench" / "metrics" / "steps_seen.py").write_text(
        "def read(record):\n    return record['window']['steps']\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "steps_seen", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "Training loop and refine",
        "moves": "train_steps_per_s", "workloads": ["tiny.quick"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    b = harness.Bench(checkout)
    assert [m["name"] for m in b.metrics("tiny.quick", True)] == ["steps_seen"]
    assert b.reader("steps_seen")({"window": {"steps": 7}}) == 7


def test_every_metric_has_a_reader():
    from perfbench import harness
    from conftest import ROOT

    b = harness.Bench(ROOT)
    for kind in ("end_to_end", "per_layer"):
        for m in b.spec[kind]:
            assert callable(b.reader(m["name"]))
    for w in b.spec["workloads"]:
        b.config(w["config"]), b.limits(w["name"])
        assert callable(b.driver(b.traffic(w["traffic"])["driver"]).setup)


def test_new_job_cell_runs_on_the_cpu(checkout):
    """The densify cell's driver at a tiny size: set-up through a refine
    (checked), then a window of a fixed number of periods."""
    from perfbench import harness

    torch.set_num_threads(2)
    cfg = tiny_config("tinyd")
    cfg["train"]["densify"].update(warmup_steps=4, refine_every=2)
    limits = {"first_loss_gap": 1e-4, "grad_gap": 1e-4,
              "median_change_gap": 1e-2, "first_stats_gap": 1e-4,
              "refine_gap": 1e-5, "refine_rows": 0}
    cell = add_cell(checkout, "tinyd", cfg, "grow",
                    {"driver": "new_job", "start": {"setup_until": 5},
                     "window_steps_per_s": 20, "period": 2,
                     "check_steps": 3}, limits)
    r = harness.run_cell(checkout, cell, 2**31 + 9, 0.2, False, "cpu")
    assert r["correct"], r["compared"]
    assert r["attempted"] == 4


def test_new_job_growth_and_the_step_after_it_are_checked(checkout):
    """A growth in the window: the grown state is compared exactly, and
    the step after it against the reference from the state before it."""
    from perfbench import harness

    torch.set_num_threads(2)
    cell = add_growth_cell(checkout)
    r = harness.run_cell(checkout, cell, 77, 0.2, False, "cpu")
    assert r["correct"], r["compared"]
    assert set(r["compared"]) == set(GROWTH_LIMITS)


def test_polish_warmup_steps_come_before_the_window(checkout):
    """``warmup_steps`` in a polish mix's start: set-up trains that many
    steps past its first period, and the window starts after them."""
    from perfbench import harness

    torch.set_num_threads(2)
    b = harness.Bench(checkout)
    tr = polish()
    tr["start"]["warmup_steps"] = 4
    run = b.driver("resumed_job").setup(b.config("tiny"), tr, 7, "cpu")
    assert run.trainer.state.step == 15000 + tr["period"] + 4
    # the first call runs the check steps (3), then periods of 2
    assert run.call_starts == [15000, 15003, 15005]
    assert len(run.check_run.losses) == tr["check_steps"]
