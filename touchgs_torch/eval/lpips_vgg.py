"""Faithful LPIPS (VGG-16 backbone) in PyTorch (port of
``touchgs_tpu/eval/lpips_vgg.py``).

- ScalingLayer: input in [-1, 1], normalized by the LPIPS shift/scale
  constants (the ImageNet statistics expressed in [-1, 1] space).
- VGG-16 features with taps after relu1_2 / relu2_2 / relu3_3 / relu4_3 /
  relu5_3 (torchvision ``features`` indices 3, 8, 15, 22, 29).
- Per layer: channel-unit-normalize both feature maps, squared difference,
  1x1 ``lin`` conv (no bias), spatial average; sum over the five layers.

Params are a flat torch-named dict in the JAX package's layout: conv
weights HWIO, as ``tools/port_weights.py`` writes them; `_oihw` is the one
place that turns them into PyTorch's OIHW.  ``load_lpips_params``
normalizes the lpips package's names (``net.sliceK.I.*`` →
``features.I.*``).  The convolutions run in full float32 (`fp32`).
"""
from __future__ import annotations

import contextlib
import zipfile
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

# LPIPS ScalingLayer constants (shift/scale in [-1, 1] input space)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# torchvision vgg16.features conv indices per block, and the relu tap indices
VGG16_CONVS = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
VGG16_CHANNELS = (64, 128, 256, 512, 512)


@contextlib.contextmanager
def fp32():
    """Convolutions and matmuls in full float32 inside the block, whatever
    the caller set: PyTorch lets cuDNN convolve in TF32 by default, and the
    JAX package's metrics are float32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _oihw(w, device) -> torch.Tensor:
    """An HWIO conv weight (numpy or tensor) as PyTorch's OIHW on ``device``."""
    return torch.as_tensor(w, dtype=torch.float32,
                           device=device).permute(3, 2, 0, 1)


def _nchw(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) → (1, C, H, W)."""
    return img.permute(2, 0, 1)[None]


def vgg16_taps(p, x: torch.Tensor, convs: Sequence[Sequence[int]] = VGG16_CONVS
               ) -> list:
    """(1, 3, H, W) scaled input → the 5 tapped relu feature maps (NCHW)."""
    taps = []
    for bi, block in enumerate(convs):
        for ci in block:
            b = torch.as_tensor(p[f"features.{ci}.bias"], dtype=torch.float32,
                                device=x.device)
            x = torch.relu(F.conv2d(x, _oihw(p[f"features.{ci}.weight"],
                                             x.device), b, padding=1))
        taps.append(x)
        if bi < len(convs) - 1:
            x = F.max_pool2d(x, 2)  # 2x2 "VALID"
    return taps


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    n = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True))
    return x / (n + eps)


def lpips_vgg(p, img0: torch.Tensor, img1: torch.Tensor,
              convs=VGG16_CONVS) -> torch.Tensor:
    """LPIPS distance between two (H, W, 3) images in [0, 1]."""
    dev = img0.device
    # upload the weights once a call, not once a use
    p = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
         for k, v in p.items()}
    shift = torch.as_tensor(_SHIFT, device=dev)
    scale = torch.as_tensor(_SCALE, device=dev)

    def scaled(img):
        return _nchw((img.float() * 2.0 - 1.0 - shift) / scale)

    with fp32():
        f0 = vgg16_taps(p, scaled(img0), convs)
        f1 = vgg16_taps(p, scaled(img1), convs)
        total = torch.zeros((), device=dev)
        for k, (a, b) in enumerate(zip(f0, f1)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            val = F.conv2d(d, _oihw(p[f"lin{k}.model.1.weight"], dev))
            total = total + torch.mean(val[:, 0])
    return total


def load_lpips_params(path) -> dict:
    """Load a ported npz as numpy arrays, normalizing lpips-package names
    (``net.sliceK.I.*`` → ``features.I.*``)."""
    out = {}
    with np.load(path) as data:
        for k in data.files:
            name = k
            if name.startswith("net.slice"):
                name = "features." + name.split(".", 2)[2]
            out[name] = data[k]
    return out


def is_lpips_params(path) -> bool:
    try:
        with np.load(path) as data:
            return any(k.startswith(("lin0.model", "features.0.weight",
                                     "net.slice1")) for k in data.files)
    except (OSError, ValueError, zipfile.BadZipFile):
        return False
