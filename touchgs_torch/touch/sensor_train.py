"""Training steps for the DenseTact sensor nets (port of
``touchgs_tpu/touch/sensor_train.py``).

The depth net trains with the reference's ``prev_net_loss`` combination
(SSIM + gradient + θ·L1, ``Img2Depth/utils.py:189-210``) or pure silog; the
force net with ``rmseloss`` (``utils.py:243-250``), both from
`touch.losses`.  A step is a function over the net (an ``nn.Module``) and
its ``torch.optim`` optimizer: it runs the batch through the net at once
(the JAX step vmaps over the images), takes one optimizer step and returns
the JAX step's metrics dict.  ``optax.adam(lr)`` is
``torch.optim.Adam(params, lr, eps=1e-8)``.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from touchgs_torch.eval.lpips_vgg import fp32
from touchgs_torch.touch.losses import (densetact_depth_loss, rmse_loss,
                                        silog_loss)


def make_depth_train_step(net: nn.Module, optimizer: torch.optim.Optimizer,
                          loss: str = "densetact",
                          variance_focus: float = 0.85,
                          theta: float = 0.2) -> Callable:
    """``step(images (B, H, W, 3), depths (B, H, W)) → {"loss", "l1"}``.
    ``loss``: "densetact" (SSIM + ∇ + θ·L1) or "silog" (zero-depth pixels
    masked, as the reference's silog mask does)."""

    def step(images: torch.Tensor, depths: torch.Tensor) -> dict:
        with fp32():
            preds = net(images)
            if loss == "silog":
                value = silog_loss(preds, depths, depths > 0,
                                   variance_focus=variance_focus)
            else:
                value = densetact_depth_loss(preds, depths, theta=theta)
            optimizer.zero_grad(set_to_none=True)
            value.backward()
            optimizer.step()
        return {"loss": value.detach(),
                "l1": torch.mean(torch.abs(preds.detach() - depths))}

    return step


def make_force_train_step(net: nn.Module,
                          optimizer: torch.optim.Optimizer) -> Callable:
    """``step(images (B, H, W, 3), forces (B, 6) normalized) → {"loss"}``:
    the reference's rmseloss on the head's normalized output."""

    def step(images: torch.Tensor, forces: torch.Tensor) -> dict:
        with fp32():
            value = rmse_loss(net(images), forces)
            optimizer.zero_grad(set_to_none=True)
            value.backward()
            optimizer.step()
        return {"loss": value.detach()}

    return step
