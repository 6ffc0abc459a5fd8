"""Checkpoint/resume (port of ``touchgs_tpu/train/checkpoint.py``).

Run-dir layout mirrors nerfstudio's
``outputs/<scene>/<method>/<timestamp>/`` contract
(``experiment_utils/run_eval.py:28-43``): each run dir holds ``config.json``,
the ``capacities.json`` sidecar and the step checkpoints;
``latest_run``/``load_run`` resolution is newest-first like run_eval.py:28-37.
The two JSON files are written as the JAX package writes them.

A step checkpoint is one ``torch.save`` file, ``checkpoints/<step>.pt``,
of plain dicts of tensors and ints (no pickled dataclass), so
``torch.load(..., weights_only=True)`` reads it.  The JAX package saves
orbax checkpoints instead: neither package reads the other's (ROADMAP.md
C19); ``.ply`` exports (``data/ply.py``) carry trained Gaussians across.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import warnings
from pathlib import Path
from typing import Optional

import torch

METHOD_NAME = "depth-gaussian-splatting"


def restore_trainer(trainer, mgr: "CheckpointManager",
                    step: Optional[int] = None) -> None:
    """Restore ``trainer.state`` from ``mgr``, growing the template first if
    the checkpoint was saved at a larger progressive capacity (the normal
    case after any densify-driven growth — a fresh Trainer starts small).
    Also restores host-side trainer knobs from the sidecar: an escalated
    truncation-guard k_tile would otherwise silently revert to the config
    cap on resume and train lossy again."""
    from touchgs_torch.train.trainer import grow_state, make_train_step

    cap = mgr.saved_capacity(step)
    if cap is not None and cap > trainer.state.params.capacity:
        trainer.state = grow_state(trainer.state, cap)
    trainer.state = mgr.restore(trainer.state, step)
    if mgr.saved_extra(step).get("densify_units") != "normalized":
        # checkpoint predates the pixel→normalized max_radii unit change:
        # pixel-unit radii fed into the normalized screen-size gates would
        # mass-cull live gaussians on the first refine.  Zeroing the
        # accumulated radii is safe — they rebuild within one refine window.
        trainer.state.densify.max_radii.zero_()
    k_tile = mgr.saved_extra(step).get("k_tile")
    if k_tile and k_tile != trainer._k_tile:
        trainer._k_tile = int(k_tile)
        trainer.train_step = make_train_step(
            trainer.cfg, trainer.optimizer, k_tile=trainer._k_tile,
            events=trainer.events)


def make_run_dir(output_root: str | Path, scene_name: str) -> Path:
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
    run_dir = Path(output_root) / scene_name / METHOD_NAME / stamp
    run_dir.mkdir(parents=True, exist_ok=True)
    return run_dir


def latest_run_dir(output_root: str | Path, scene_name: str,
                   past_n: int = 0) -> Optional[Path]:
    """Newest-first run-dir resolution (run_eval.py:28-37)."""
    base = Path(output_root) / scene_name / METHOD_NAME
    if not base.exists():
        return None
    runs = sorted((d for d in base.iterdir() if d.is_dir()), reverse=True)
    return runs[past_n] if past_n < len(runs) else None


def _config_to_jsonable(cfg) -> dict:
    def enc(o):
        if dataclasses.is_dataclass(o):
            return {k: enc(v) for k, v in dataclasses.asdict(o).items()}
        if isinstance(o, dict):
            return {k: enc(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [enc(v) for v in o]
        if hasattr(o, "value"):  # enums
            return o.value
        return o

    return enc(cfg)


def _state_to_dict(state) -> dict:
    """A `TrainState` as nested dicts of tensors and ints."""
    def fields(obj):
        return {f.name: getattr(obj, f.name)
                for f in dataclasses.fields(obj)}

    opt = state.opt_state
    return {
        "params": fields(state.params),
        "opt_state": {"count": opt.count, "mu": dict(opt.mu),
                      "nu": dict(opt.nu)},
        "densify": fields(state.densify),
        "step": int(state.step),
        "pose_deltas": state.pose_deltas,
    }


def _check_like(saved: dict, like: dict, where: str) -> None:
    """The saved tensors must have the template's keys and shapes, as
    orbax's restore into a template demands."""
    if set(saved) != set(like):
        raise ValueError(f"checkpoint {where}: keys {sorted(saved)}, the "
                         f"trainer's {sorted(like)}")
    for k, v in saved.items():
        if isinstance(v, dict):
            _check_like(v, like[k], f"{where}.{k}")
        elif torch.is_tensor(v) or torch.is_tensor(like[k]):
            def desc(t):
                return (tuple(t.shape), t.dtype) if torch.is_tensor(t) else t

            if desc(v) != desc(like[k]):
                raise ValueError(f"checkpoint {where}.{k}: {desc(v)}, the "
                                 f"trainer's {desc(like[k])}")


class CheckpointManager:
    def __init__(self, run_dir: str | Path, cfg=None, max_to_keep: int = 3):
        self.run_dir = Path(run_dir)
        self.ckpt_dir = self.run_dir / "checkpoints"
        self.max_to_keep = max_to_keep
        if cfg is not None:
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
            (self.run_dir / "config.json").write_text(
                json.dumps(_config_to_jsonable(cfg), indent=2, default=str)
            )

    def _path(self, step: int) -> Path:
        return self.ckpt_dir / f"{step}.pt"

    def all_steps(self) -> list[int]:
        if not self.ckpt_dir.exists():
            return []
        return sorted(int(p.stem) for p in self.ckpt_dir.glob("*.pt")
                      if p.stem.isdigit())

    def save(self, step: int, state, extra: Optional[dict] = None) -> None:
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        # atomic replace: a crash mid-write leaves the previous checkpoints
        tmp = self._path(step).with_suffix(".pt.tmp")
        torch.save(_state_to_dict(state), tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            self._path(old).unlink()
        # sidecar per-step index: restore() needs a template whose tensors
        # match the SAVED shapes, but progressive capacity growth
        # (trainer.grow_capacity) means a fresh Trainer's tensors are usually
        # smaller than what was saved — record capacity (and host-side
        # trainer knobs like the escalated k_tile) per step so
        # restore_trainer() can rebuild the exact training configuration
        cap = getattr(getattr(state, "params", None), "capacity", None)
        if cap is not None or extra:
            entry = dict(extra or {})
            # stats-unit version marker: restore_trainer zeroes max_radii for
            # checkpoints that predate the normalized-unit densify stats
            entry.setdefault("densify_units", "normalized")
            if cap is not None:
                entry["capacity"] = int(cap)
            idx_path = self.run_dir / "capacities.json"
            idx = {}
            if idx_path.exists():
                try:
                    idx = json.loads(idx_path.read_text())
                except (OSError, json.JSONDecodeError):
                    warnings.warn(
                        f"corrupt sidecar {idx_path}; rebuilding from this "
                        "step (earlier steps lose their k_tile/capacity "
                        "extras)")
                    idx = {}
            idx[str(step)] = entry
            # atomic replace: a crash mid-write must not corrupt the index
            # (saved_extra would silently lose the escalated k_tile and a
            # resumed run would train lossy again)
            tmp = idx_path.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(idx))
            os.replace(tmp, idx_path)

    def _sidecar_entry(self, step: Optional[int]) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            return {}
        idx_path = self.run_dir / "capacities.json"
        if not idx_path.exists():
            return {}
        try:
            entry = json.loads(idx_path.read_text()).get(str(step))
        except (OSError, json.JSONDecodeError):
            warnings.warn(
                f"sidecar {idx_path} exists but failed to parse — restored "
                "run may lose host-side knobs (escalated k_tile)")
            return {}
        if isinstance(entry, dict):
            return entry
        if entry:  # older format: bare capacity int
            return {"capacity": int(entry)}
        return {}

    def _load(self, step: int, device) -> dict:
        return torch.load(self._path(step), map_location=device,
                          weights_only=True)

    def saved_capacity(self, step: Optional[int] = None) -> Optional[int]:
        """Capacity of the Gaussian tensors in the checkpoint at ``step``
        (sidecar index first, the checkpoint's own means as fallback)."""
        cap = self._sidecar_entry(step).get("capacity")
        if cap:
            return int(cap)
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return int(self._load(step, "cpu")["params"]["means"].shape[0])

    def saved_extra(self, step: Optional[int] = None) -> dict:
        """Host-side trainer knobs recorded alongside the checkpoint
        (e.g. the truncation-guard's escalated k_tile)."""
        return {k: v for k, v in self._sidecar_entry(step).items()
                if k != "capacity"}

    def restore(self, state_like, step: Optional[int] = None):
        """A `TrainState` of the checkpoint at ``step`` (the latest by
        default) on ``state_like``'s device, whose keys and shapes it must
        have."""
        from touchgs_torch.models.densify import DensifyState
        from touchgs_torch.models.gaussians import GaussianParams
        from touchgs_torch.train.optim import FusedAdamState
        from touchgs_torch.train.trainer import TrainState

        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.ckpt_dir}")
        d = self._load(step, state_like.params.means.device)
        _check_like(d, _state_to_dict(state_like), "state")
        opt = d["opt_state"]
        return TrainState(
            params=GaussianParams(**d["params"]),
            opt_state=FusedAdamState(count=opt["count"], mu=opt["mu"],
                                     nu=opt["nu"]),
            densify=DensifyState(**d["densify"]),
            step=int(d["step"]),
            pose_deltas=d["pose_deltas"],
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self):
        """Nothing to release (the JAX package's manager holds orbax's)."""
