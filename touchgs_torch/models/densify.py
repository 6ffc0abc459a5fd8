"""Adaptive density control over fixed-capacity masked tensors (port of
``touchgs_tpu/models/densify.py``).

Primitive counts never change: new Gaussians are written into dead slots
located with a stable argsort, clones and splits are scatters, prunes flip
the ``alive`` mask.  When free slots run out, the highest-gradient
candidates win.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from touchgs_torch.config import DensifyConfig
from touchgs_torch.models.gaussians import GaussianParams
from touchgs_torch.ops.projection import quat_to_rotmat
from touchgs_torch.utils import telemetry


@dataclasses.dataclass
class DensifyState:
    grad_accum: torch.Tensor   # (C,) accumulated screen-space grad norms
    grad_count: torch.Tensor   # (C,) number of steps each gaussian was visible
    max_radii: torch.Tensor    # (C,) max screen radius since last refine

    @staticmethod
    def zeros(capacity: int, device: torch.device | str = "cuda"
              ) -> "DensifyState":
        return DensifyState(*(torch.zeros((capacity,), device=device)
                              for _ in range(3)))


def update_stats(
    state: DensifyState,
    means2d_grad: torch.Tensor,  # (C, 2) grad of loss w.r.t. PIXEL positions
    radii: torch.Tensor,         # (C,)
    visible: torch.Tensor,       # (C,) bool
    width: int = 0,
    height: int = 0,
) -> DensifyState:
    """Accumulate positional-gradient stats in splatfacto's units: pixel
    gradients scaled by ``0.5·max(W, H)`` and radii as fractions of
    ``max(W, H)``; ``width/height = 0`` keeps raw pixel units.  The sums
    are written into ``state``'s own tensors, which it returns (the JAX
    package returns new arrays with the same values): a step captured as a
    CUDA graph keeps reading the tensors it captured."""
    g = torch.sqrt(torch.sum(means2d_grad * means2d_grad, dim=-1))
    r = radii
    if width or height:
        g = g * (0.5 * max(width, height))
        r = r / float(max(width, height))
    vis = visible.float()
    state.grad_accum.add_(g * vis)
    state.grad_count.add_(vis)
    torch.maximum(state.max_radii, r * vis, out=state.max_radii)
    return state


def _scatter_children(params: GaussianParams, child_slot, child_ok,
                      new_means, new_log_scales) -> GaussianParams:
    """Write child rank r (source gaussian r) into ``child_slot[r]`` where
    ``child_ok[r]``; everything but means and log-scales is inherited."""
    telemetry.count_read()   # nonzero reads its count back
    src = torch.nonzero(child_ok).squeeze(-1)
    dst = child_slot[src]

    def put(dest, vals):
        out = dest.clone()
        out[dst] = vals[src]
        return out

    return GaussianParams(
        means=put(params.means, new_means),
        quats=put(params.quats, params.quats),
        log_scales=put(params.log_scales, new_log_scales),
        logit_opacities=put(params.logit_opacities, params.logit_opacities),
        sh_dc=put(params.sh_dc, params.sh_dc),
        sh_rest=put(params.sh_rest, params.sh_rest),
        alive=put(params.alive, child_ok),
    )


def refine(
    params: GaussianParams,
    state: DensifyState,
    cfg: DensifyConfig,
    do_densify: bool = True,
    use_size_cull: bool = True,
    use_screen_size: bool = False,
    split_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> tuple[GaussianParams, DensifyState, torch.Tensor]:
    """One densify+prune pass.  Returns (params, reset stats, touched_mask).

    ``touched_mask`` marks slots whose parameters were (re)written; the
    trainer zeroes their optimizer moments.  ``split_noise`` is the
    (split_samples, C, 3) standard-normal noise of the split children;
    when None it is drawn from ``generator``.  The flags are splatfacto's
    step-dependent schedule (see ``touchgs_tpu/models/densify.py``).  Its
    reads back to the host are counted (``telemetry.count_read``).
    """
    C = params.capacity
    dev = params.means.device
    avg_grad = state.grad_accum / torch.clamp(state.grad_count, min=1.0)
    scale_max = torch.amax(params.scales(), dim=-1)

    dense_candidate = (avg_grad > cfg.grad_threshold) & params.alive
    if not do_densify:
        dense_candidate = torch.zeros_like(dense_candidate)
    split_by_size = scale_max > cfg.densify_size_threshold
    if use_screen_size:
        split_by_size = split_by_size | (state.max_radii > cfg.split_screen_size)
    do_split = dense_candidate & split_by_size
    do_clone = dense_candidate & ~do_split

    # children per source: clone→1, split→split_samples
    n_children = (do_clone.to(torch.int32)
                  + do_split.to(torch.int32) * cfg.split_samples)

    # free slots, stable order (dead first)
    dead_first = torch.argsort(params.alive.to(torch.int32), stable=True)
    telemetry.count_read()
    n_free = C - int(params.alive.sum())

    # priority: higher-gradient sources allocate first when slots are scarce
    neg_inf = torch.full_like(avg_grad, float("-inf"))
    priority = torch.argsort(-torch.where(n_children > 0, avg_grad, neg_inf),
                             stable=True)
    n_children_sorted = n_children[priority]
    offsets_sorted = (torch.cumsum(n_children_sorted, 0, dtype=torch.int32)
                      - n_children_sorted)
    offsets = torch.zeros((C,), dtype=torch.int32, device=dev)
    offsets[priority] = offsets_sorted

    max_k = max(1, cfg.split_samples)
    if split_noise is None:
        split_noise = torch.randn((max_k, C, 3), generator=generator,
                                  device=dev)
    touched = torch.zeros((C,), dtype=torch.bool, device=dev)
    new_params = params
    R = quat_to_rotmat(params.quats)
    for k in range(max_k):
        want = n_children > k
        slot_rank = offsets + k
        ok = want & (slot_rank < n_free)
        child_slot = dead_first[torch.clamp(slot_rank, 0, C - 1).long()]
        # clones stay at the source; splits sample the gaussian's ellipsoid
        offset_world = torch.einsum("nij,nj->ni", R,
                                    split_noise[k] * params.scales())
        split_means = params.means + offset_world
        child_means = torch.where(do_split[:, None], split_means, params.means)
        child_log_scales = torch.where(
            do_split[:, None],
            params.log_scales - math.log(cfg.split_scale_shrink),
            params.log_scales,
        )
        new_params = _scatter_children(new_params, child_slot, ok,
                                       child_means, child_log_scales)
        # a mask's index reads its count back; the fill copies nothing
        # from the host (an assigned True would, and wait for the queue)
        telemetry.count_read()
        touched.index_fill_(0, child_slot[ok], True)

    # split sources die (replaced by children)
    died_split = do_split & (offsets + cfg.split_samples - 1 < n_free)
    new_params = dataclasses.replace(new_params,
                                     alive=new_params.alive & ~died_split)

    # prune: low opacity and, after the first reset period, oversized in
    # world or screen units — judged on the post-scatter parameters
    prune = new_params.opacities() < cfg.prune_opacity_threshold
    if use_size_cull:
        toobig = torch.amax(new_params.scales(), dim=-1) > cfg.prune_scale_threshold
        if use_screen_size:
            # children have no screen-size history yet — exempt them
            max2d = torch.where(touched, torch.zeros_like(state.max_radii),
                                state.max_radii)
            toobig = toobig | (max2d > cfg.cull_screen_size)
        prune = prune | toobig
    new_params = dataclasses.replace(new_params,
                                     alive=new_params.alive & ~prune)
    return new_params, DensifyState.zeros(C, dev), touched


def reset_opacities(params: GaussianParams, value: float) -> GaussianParams:
    """Periodic opacity clamp-down (3DGS `reset_opacity`).  The cap is
    filled in on the device: no copy from the host waits for the queue."""
    cap = torch.log(torch.full((), value / (1.0 - value),
                               device=params.logit_opacities.device))
    return dataclasses.replace(
        params, logit_opacities=torch.minimum(params.logit_opacities, cap))
