"""Evaluation metrics — the fork's ns-eval JSON contract (port of
``touchgs_tpu/eval/metrics.py``).

Emits exactly the keys ``experiment_utils/get_results.py:33-52`` consumes:
``psnr``, ``ssim``, ``lpips`` always; ``depth_mse``, ``supervised_depth_mse``,
``gt_depth_mse``, ``gt_object_depth_mse`` when the corresponding maps exist.

LPIPS: without pretrained weights, `lpips_distance` computes the LPIPS
statistic (normalized deep-feature L2, averaged over layers) over the JAX
package's fixed random conv stack, rebuilt here from the same numpy seed,
so the two packages score the same.  ``TOUCHGS_LPIPS_WEIGHTS`` naming an
``.npz`` of LPIPS-VGG weights selects the architecture-exact LPIPS
(`lpips_vgg`); any other ``.npz`` replaces the random stack's weights.
Convolutions and matmuls run in full float32 (`fp32`).
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from touchgs_torch.eval.lpips_vgg import (
    _nchw,
    _oihw,
    fp32,
    is_lpips_params,
    load_lpips_params,
    lpips_vgg,
)
from touchgs_torch.ops.ssim import ssim


def psnr(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img0 - img1) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


# --- LPIPS-style perceptual distance ---------------------------------------

_LAYER_WIDTHS = (32, 64, 128, 256)


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """NCHW conv with XLA's "SAME" padding: the total pad
    max((ceil(n / s) − 1)·s + k − n, 0) splits with the smaller half first,
    so a stride-2 3x3 pads (0, 1) on an even size and (1, 1) on an odd one,
    where ``conv2d(padding=1)`` would pad (1, 1) on both."""
    pads = []
    for n, k in ((x.shape[3], w.shape[3]), (x.shape[2], w.shape[2])):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, stride=stride)


def _feature_stack_params(seed: int = 0) -> list:
    """Fixed random conv weights (He init, HWIO) — deterministic across
    runs, the JAX package's to the bit."""
    rng = np.random.default_rng(seed)
    params = []
    cin = 3
    for width in _LAYER_WIDTHS:
        fan_in = 3 * 3 * cin
        w = rng.normal(0, np.sqrt(2.0 / fan_in), (3, 3, cin, width))
        params.append(w.astype(np.float32))
        cin = width
    return params


@functools.lru_cache(maxsize=1)
def _lpips_vgg_params():
    """Ported real LPIPS-VGG weights (tools/port_weights.py npz), or None."""
    path = os.environ.get("TOUCHGS_LPIPS_WEIGHTS", "")
    if path and os.path.exists(path) and is_lpips_params(path):
        return load_lpips_params(path)
    return None


@functools.lru_cache(maxsize=1)
def _lpips_params() -> list:
    path = os.environ.get("TOUCHGS_LPIPS_WEIGHTS", "")
    if path and os.path.exists(path) and _lpips_vgg_params() is None:
        with np.load(path) as data:
            return [data[k] for k in sorted(data.files)]
    return _feature_stack_params()


def lpips_distance(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """Perceptual distance between (H, W, 3) images in [0, 1].

    With ported torch-lpips VGG weights (``TOUCHGS_LPIPS_WEIGHTS``) this is
    the architecture-exact LPIPS; otherwise the random-feature fallback."""
    vgg = _lpips_vgg_params()
    if vgg is not None:
        return lpips_vgg(vgg, img0, img1)
    weights = [_oihw(w, img0.device) for w in _lpips_params()]

    def features(img):
        x = _nchw((img - 0.5) * 2.0)  # [-1, 1]
        feats = []
        for i, w in enumerate(weights):
            x = torch.relu(_conv_same(x, w, stride=1 if i == 0 else 2))
            # channel-normalize (the LPIPS unit-normalize step)
            norm = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True) + 1e-10)
            feats.append(x / norm)
        return feats

    with fp32():
        f0 = features(img0)
        f1 = features(img1)
    dists = [torch.mean(torch.sum((a - b) ** 2, dim=1)) for a, b in zip(f0, f1)]
    return torch.mean(torch.stack(dists))


def _masked_mse(a: torch.Tensor, b: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    n = torch.clamp(mask.sum(), min=1)
    return torch.sum(torch.where(mask, (a - b) ** 2,
                                 torch.zeros_like(a))) / n


def eval_metrics(
    rendered_rgb: torch.Tensor,
    rendered_depth: torch.Tensor,
    gt_rgb: torch.Tensor,
    supervision_depth: Optional[torch.Tensor] = None,  # fused depth map
    gt_depth: Optional[torch.Tensor] = None,           # sensor/sim ground truth
    object_mask: Optional[torch.Tensor] = None,
    is_real_world: bool = True,
) -> dict:
    """Per-view metric dict with the fork's exact key names."""
    out = {
        "psnr": float(psnr(rendered_rgb, gt_rgb)),
        "ssim": float(ssim(rendered_rgb, gt_rgb)),
        "lpips": float(lpips_distance(rendered_rgb, gt_rgb)),
    }
    if supervision_depth is not None:
        mask = supervision_depth > 0
        mse = float(_masked_mse(rendered_depth, supervision_depth, mask))
        out["depth_mse"] = mse
        out["supervised_depth_mse"] = mse
    if gt_depth is not None and is_real_world:
        mask = gt_depth > 0
        out["gt_depth_mse"] = float(_masked_mse(rendered_depth, gt_depth, mask))
        if object_mask is not None:
            out["gt_object_depth_mse"] = float(
                _masked_mse(rendered_depth, gt_depth, mask & object_mask)
            )
    return out
