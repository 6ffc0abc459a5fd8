"""DenseTact sensor-net training losses (port of
``touchgs_tpu/touch/losses.py``).

The reference trains its tactile image→depth and image→force nets with
(``Img2Depth/utils.py:81-250``, ``networks/DenseNet_loss.py:23-105``):

- the scale-invariant log loss ``silog_loss`` (×10), the log-RMS and the
  force RMSE;
- the DenseDepth combination: gaussian-window SSIM + image-gradient edge
  term + θ·L1 (``prev_net_loss``);
- the depth and force eval metrics ``compute_errors*`` (silog ×100).

Quirks kept as the JAX package keeps them: the SSIM's C1 = 0.01² and
C2 = 0.03² are not scaled by the dynamic range; its window is clipped to
``min(11, H, W)`` and the map zero-padded; the gradients are zero-padded
back to the input's shape.  Masks are weights (no boolean indexing, no
host sync), so every function runs on the device and differentiates.
Tensors are (..., H, W).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-8


def _weights(d: torch.Tensor, mask) -> torch.Tensor:
    return torch.ones_like(d) if mask is None else mask.to(d.dtype)


def _log_diff(depth_est: torch.Tensor, depth_gt: torch.Tensor):
    return (torch.log(torch.clamp(depth_est, min=_EPS))
            - torch.log(torch.clamp(depth_gt, min=_EPS)))


def silog_loss(depth_est: torch.Tensor, depth_gt: torch.Tensor,
               mask: torch.Tensor | None = None,
               variance_focus: float = 0.85) -> torch.Tensor:
    """``sqrt(E[d²] − λ·E[d]²) · 10`` with ``d = log(pred) − log(gt)`` over
    the masked pixels (``utils.py:171-178``)."""
    d = _log_diff(depth_est, depth_gt)
    w = _weights(d, mask)
    n = torch.clamp(w.sum(), min=1.0)
    m2 = (w * d * d).sum() / n
    m1 = (w * d).sum() / n
    return torch.sqrt(torch.clamp(m2 - variance_focus * m1 * m1,
                                  min=0.0)) * 10.0


def rmslog_loss(depth_est: torch.Tensor, depth_gt: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Root-mean-square log loss (``utils.py:234-241``)."""
    d = _log_diff(depth_est, depth_gt)
    w = _weights(d, mask)
    return torch.sqrt((w * d * d).sum() / torch.clamp(w.sum(), min=1.0))


def rmse_loss(est: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Force-net RMSE (``utils.py:243-250`` ``rmseloss``)."""
    return torch.sqrt(torch.mean((gt - est) ** 2))


def _gaussian_window(window_size: int, sigma: float,
                     device=None) -> torch.Tensor:
    x = (torch.arange(window_size, dtype=torch.float32, device=device)
         - window_size // 2)
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable gaussian filter over the trailing (H, W) axes, zero padded
    by ``k // 2`` ("same" for an odd window): rows, then columns, each a
    grouped ``conv2d`` (the window is symmetric, so correlation is
    convolution)."""
    k = win.shape[0]
    pad = k // 2
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    x = F.conv2d(x, win.view(1, 1, 1, k), padding=(0, pad))
    x = F.conv2d(x, win.view(1, 1, k, 1), padding=(pad, 0))
    return x.reshape(lead + (h, w))


def densetact_ssim(img1: torch.Tensor, img2: torch.Tensor,
                   window_size: int = 11) -> torch.Tensor:
    """The DenseNet_loss gaussian-window SSIM (``DenseNet_loss.py:23-75``),
    the mean over every pixel; C1, C2 unscaled."""
    win = _gaussian_window(min(window_size, *img1.shape[-2:]), 1.5,
                           img1.device)
    mu1 = _blur(img1, win)
    mu2 = _blur(img2, win)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, win) - mu1_sq
    sigma2_sq = _blur(img2 * img2, win) - mu2_sq
    sigma12 = _blur(img1 * img2, win) - mu12
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    score = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(score)


def image_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward differences zero-padded back to the input's shape
    (``DenseNet_loss.py:79-100``)."""
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1))


def gradient_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Edge term (``DenseNet_loss.py:102-105``): mean |∇pred − ∇true|."""
    dy_t, dx_t = image_gradients(y_true)
    dy_p, dx_p = image_gradients(y_pred)
    return torch.mean(torch.abs(dy_p - dy_t) + torch.abs(dx_p - dx_t))


def densetact_depth_loss(depth_est: torch.Tensor, depth_gt: torch.Tensor,
                         theta: float = 0.2) -> torch.Tensor:
    """``prev_net_loss`` (``utils.py:189-210``): clamp((1 − SSIM)·0.5, 0, 1)
    + ∇-edge term + θ·L1."""
    l1 = torch.mean(torch.abs(depth_est - depth_gt))
    ssim_term = torch.clamp(
        (1.0 - densetact_ssim(depth_est, depth_gt)) * 0.5, 0.0, 1.0)
    return ssim_term + theta * l1 + gradient_loss(depth_gt, depth_est)


def compute_depth_errors(gt: torch.Tensor, pred: torch.Tensor) -> dict:
    """``compute_errors`` (``utils.py:81-101``): silog, abs_rel, log10, rms,
    sq_rel, log_rms, d1, d2, d3."""
    gt = torch.clamp(gt, min=_EPS)
    pred = torch.clamp(pred, min=_EPS)
    thresh = torch.maximum(gt / pred, pred / gt)
    err = torch.log(pred) - torch.log(gt)
    return {
        "silog": torch.sqrt(torch.clamp(
            torch.mean(err ** 2) - torch.mean(err) ** 2, min=0.0)) * 100.0,
        "abs_rel": torch.mean(torch.abs(gt - pred) / gt),
        "log10": torch.mean(torch.abs(torch.log10(pred) - torch.log10(gt))),
        "rms": torch.sqrt(torch.mean((gt - pred) ** 2)),
        "sq_rel": torch.mean(((gt - pred) ** 2) / gt),
        "log_rms": torch.sqrt(torch.mean(err ** 2)),
        "d1": torch.mean((thresh < 1.25).float()),
        "d2": torch.mean((thresh < 1.25 ** 2).float()),
        "d3": torch.mean((thresh < 1.25 ** 3).float()),
    }


def compute_force_errors(gt: torch.Tensor, pred: torch.Tensor) -> dict:
    """``compute_errors_force`` (``utils.py:127-160``): RMSE and the mean
    |error| of each of the head's axes."""
    l1 = torch.abs(gt - pred)
    return {
        "rms": torch.sqrt(torch.mean((gt - pred) ** 2)),
        "l1_per_axis": torch.mean(l1.reshape(-1, l1.shape[-1]), dim=0),
    }
