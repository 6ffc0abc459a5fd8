"""Shared pieces of the benchmark's CPU tests: a checkout copy with a tiny
cell added as new files and entries, and the ``cuda`` marker's fixture."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    """The CUDA device; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def tiny_config(name: str, base: str = "bunny_blender_800") -> dict:
    """A configuration file's contents cut to 64x48 and 1500 Gaussians."""
    c = json.loads((ROOT / "perfbench" / "configs" / f"{base}.json")
                   .read_text())
    c["name"] = name
    c["scene"].update(width=64, height=48, views=24, seed_points=500)
    cam = c["scene"]["camera"]
    if "focal_frac" in cam:
        cam["focal_frac"] = 1.0
    else:
        cam.update(fx=60.0, fy=60.0, cx=31.5, cy=20.0)
    c["state"].update(live_gaussians=1500)
    c["train"]["rasterize"]["k_tile"] = 512
    c["train"]["model"]["max_gaussians"] = 2048
    c["train"]["view_cache_bytes"] = 1 << 28
    return c


def polish(period: int = 2) -> dict:
    """A polish traffic mix: resumed at step 15000 at the k_tile the tiny
    configuration composites at."""
    return {"driver": "resumed_job",
            "start": {"step": 15000, "adam_nu": 1e-6, "k_tile": 1024},
            "period": period, "check_steps": 3}


LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-3,
          "stats_gap": 1e-4}


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark beside the program, with a tiny polish cell
    (``tiny.quick``) added only as new files and new entries."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "touchgs_torch").symlink_to(ROOT / "touchgs_torch")
    add_cell(tmp_path, "tiny", tiny_config("tiny"), "quick",
             polish(), LIMITS)
    return tmp_path


def add_cell(root: Path, config: str, cfg: dict, traffic: str, tr: dict,
             limits: dict) -> str:
    """Add a configuration, a traffic mix and a cell as new files and new
    entries of ``BENCHMARK.json``; returns the cell's name."""
    pb = root / "perfbench"
    (pb / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    (pb / "traffic" / f"{traffic}.json").write_text(json.dumps(tr))
    cell = f"{config}.{traffic}"
    (pb / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": config, "source": "test",
                             "file": f"perfbench/configs/{config}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


GROWTH_LIMITS = {"first_loss_gap": 1e-4, "grow_diff": 0,
                 "grown_loss_gap": 1e-4, "grown_grad_gap": 1e-4,
                 "grown_change_gap": 1e-3, "grown_stats_gap": 1e-4}


def add_growth_cell(root: Path) -> str:
    """A tiny new job whose capacity grows at the window's first refine
    (320 seed points in 512 slots)."""
    cfg = tiny_config("tinyg")
    cfg["scene"]["seed_points"] = 320
    cfg["train"].update(init_capacity=512)
    cfg["train"]["densify"].update(warmup_steps=4, refine_every=2)
    return add_cell(root, "tinyg", cfg, "grow",
                    {"driver": "new_job", "start": {"setup_until": 3},
                     "window_steps_per_s": 20, "period": 2,
                     "check_steps": 3}, GROWTH_LIMITS)
