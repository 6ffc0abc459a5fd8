"""Evaluation runner + aggregator (port of ``touchgs_tpu/eval/runner.py``).

``evaluate_scene`` renders a split losslessly and averages the per-view
metrics (ns-eval); ``compute_averages`` is ``experiment_utils/
get_results.py``'s mean±std over trials.  The JSON layout matches
ns-eval's: ``{"experiment_name": ..., "results": {psnr, ssim, lpips, ...}}``.
Renders and metrics run on the parameters' device.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from touchgs_torch.config import TrainConfig
from touchgs_torch.data.png import write_png
from touchgs_torch.data.scene import Scene
from touchgs_torch.eval.metrics import eval_metrics
from touchgs_torch.models.gaussians import GaussianParams
from touchgs_torch.models.splatfacto import render_lossless


def evaluate_scene(
    params: GaussianParams,
    scene: Scene,
    cfg: TrainConfig,
    split: str = "eval",
    gt_depths: Optional[np.ndarray] = None,
    object_masks: Optional[np.ndarray] = None,
    is_real_world: bool = True,
    render_dir: Optional[str] = None,
) -> dict:
    """Render the split and average per-view metrics (ns-eval equivalent).

    ``gt_depths`` is the ground-truth depth stack (real sensor or sim),
    distinct from ``scene.depths`` which is the fused supervision signal.
    """
    dev = params.means.device
    indices = scene.i_eval if split == "eval" else scene.i_train
    if len(indices) == 0:
        indices = scene.i_train

    def up(stack, i):
        return None if stack is None else torch.as_tensor(stack[i],
                                                          device=dev)

    per_view = []
    renders = []
    for i in indices:
        cam = scene.cameras.at(int(i), dev)
        # lossless: eval must not inherit the training-path k_tile cap
        out = render_lossless(params, cam, cfg.model,
                              active_sh_degree=cfg.model.sh_degree)
        m = eval_metrics(
            out.rgb, out.depth, up(scene.images, i),
            supervision_depth=up(scene.depths, i),
            gt_depth=up(gt_depths, i),
            object_mask=up(object_masks, i),
            is_real_world=is_real_world,
        )
        per_view.append(m)
        if render_dir is not None:
            renders.append((int(i), out.rgb.cpu().numpy(),
                            out.depth.cpu().numpy()))

    keys = per_view[0].keys()
    results = {k: float(np.mean([m[k] for m in per_view])) for k in keys}

    if render_dir is not None:
        rd = Path(render_dir)
        rd.mkdir(parents=True, exist_ok=True)
        for i, rgb, depth in renders:
            write_png(rd / f"{i:05d}_rgb.png",
                      (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
            d = depth / max(float(depth.max()), 1e-9)
            write_png(rd / f"{i:05d}_depth.png", (d * 255).astype(np.uint8))
    return results


def write_eval_json(results: dict, output_path: str | Path,
                    experiment_name: str = "touchgs_torch") -> None:
    """ns-eval-compatible JSON (consumed by get_results.py:33-52)."""
    payload = {"experiment_name": experiment_name, "results": results}
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    Path(output_path).write_text(json.dumps(payload, indent=2))


def compute_averages(json_files: list[str | Path]) -> dict:
    """get_results.py equivalent: mean±std across trial JSONs."""
    collected: dict[str, list[float]] = {}
    for fp in json_files:
        results = json.loads(Path(fp).read_text())["results"]
        for k, v in results.items():
            collected.setdefault(k, []).append(v)
    out = {}
    for k, vals in collected.items():
        out[k] = {"mean": float(np.mean(vals)), "std": float(np.std(vals))}
    return out
