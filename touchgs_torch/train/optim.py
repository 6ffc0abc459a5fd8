"""Per-group fused Adam (port of ``touchgs_tpu/train/optim.py``).

Six Adam groups with the splatfacto learning rates; the means group decays
exponentially.  Numerically the JAX package's fused Adam (itself identical
to ``optax.multi_transform`` of six ``optax.adam``): eps after the sqrt, and
the means learning rate evaluated at the PRE-increment count, written out
as optax's ``exponential_decay``.  All arithmetic is float32 on the
parameters' device; the update, the moments and the count change in
place, and no value comes from the host, so the step can run as a CUDA
graph (``train/graphs.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from touchgs_torch.config import OptimConfig

PARAM_GROUPS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
                "sh_rest")


@dataclasses.dataclass
class FusedAdamState:
    count: torch.Tensor   # shared step counter (int32 scalar)
    mu: dict
    nu: dict


class FusedAdam:
    def __init__(self, cfg: OptimConfig, b1: float = 0.9, b2: float = 0.999,
                 extra_lrs: dict | None = None):
        self.cfg = cfg
        self.b1 = b1
        self.b2 = b2
        self.fixed_lrs = {
            "quats": cfg.quats_lr,
            "log_scales": cfg.scales_lr,
            "logit_opacities": cfg.opacities_lr,
            "sh_dc": cfg.features_dc_lr,
            "sh_rest": cfg.features_rest_lr,
        }
        if extra_lrs:
            # e.g. {"pose_deltas": PoseOptConfig.lr} — any extra diff group
            self.fixed_lrs.update(extra_lrs)

    def init(self, params: dict) -> FusedAdamState:
        any_p = next(iter(params.values()))
        return FusedAdamState(
            count=torch.zeros((), dtype=torch.int32, device=any_p.device),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
        )

    def means_lr(self, count: torch.Tensor) -> torch.Tensor:
        """optax.exponential_decay(init, max_steps, final/init, final) at
        ``count``: init·rate^(count/steps), floored at the final value."""
        cfg = self.cfg
        rate = torch.full((), cfg.means_lr_final / cfg.means_lr_init,
                          dtype=torch.float32, device=count.device)
        p = count.float() / cfg.means_lr_max_steps
        decayed = torch.where(count <= 0,
                              torch.full_like(p, cfg.means_lr_init),
                              cfg.means_lr_init * torch.pow(rate, p))
        return torch.clamp(decayed, min=cfg.means_lr_final)

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: FusedAdamState) -> None:
        """Update ``params`` and ``state`` in place from ``grads``."""
        b1, b2 = self.b1, self.b2
        lrs = dict(self.fixed_lrs, means=self.means_lr(state.count))
        state.count += 1
        c = state.count.float()
        # optax.adam bias correction: m̂ = m/(1−b1^t), v̂ = v/(1−b2^t)
        bc1 = 1.0 - torch.pow(torch.full_like(c, b1), c)
        bc2 = 1.0 - torch.pow(torch.full_like(c, b2), c)
        for k, g in grads.items():
            # written into the moments' own tensors: a captured step keeps
            # reading the tensors it captured
            m = state.mu[k].copy_(b1 * state.mu[k] + (1.0 - b1) * g)
            v = state.nu[k].copy_(b2 * state.nu[k] + (1.0 - b2) * (g * g))
            update = (-lrs[k]) * (m / bc1) / (torch.sqrt(v / bc2)
                                              + self.cfg.eps)
            params[k].add_(update)


def reset_opt_slots(state: FusedAdamState, touched: torch.Tensor) -> None:
    """Zero the Adam moments of (re)written Gaussian slots, in place (the
    Gaussian groups only: the pose deltas' rows are cameras)."""
    for moments in (state.mu, state.nu):
        for k in PARAM_GROUPS:
            moments[k][touched] = 0.0
