"""Plain reference of a new job's start and of adaptive density control,
from splatfacto's description and the configuration's values, over the
fixed-capacity slots the port keeps (a Gaussian is a row; ``alive`` marks
the live ones):

- ``start_state``: Gaussians at the touch seed points, scaled by the mean
  distance to their 3 nearest neighbours among 4096 of the points drawn
  without replacement by numpy's ``default_rng(0)`` (all of them when
  fewer), identity rotations, the initial opacity, the DC band from the
  seed colours and zero higher bands; the rest of the capacity dead; Adam
  and the statistics at zero;
- ``refine``: a live Gaussian whose mean screen gradient exceeds the
  threshold is split (two children inside its ellipsoid, scales divided by
  1.6) when it is large in the world or on screen, else cloned; children
  fill dead rows in order, highest gradient first while rows last; a split
  source whose children all found rows dies; then Gaussians below the
  opacity threshold (and, after the first reset period, too large in the
  world, or on screen while the screen gates hold) are pruned; the
  statistics restart and the moments of rewritten rows are zeroed;
- ``grow``: the capacity doubled by rows that are dead, with a log-scale
  of −12.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.splat import SH_C0, rotation

GROUPS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
          "sh_rest")


def knn_scales(points: np.ndarray, k: int = 3, reference: int = 4096
               ) -> np.ndarray:
    """Mean distance of each point to its k nearest among ``reference`` of
    the points (drawn by ``default_rng(0)``), itself left out."""
    n = len(points)
    if n <= k:
        return np.full((n,), 0.02, np.float32)
    ref = points
    if n > reference:
        ref = points[np.random.default_rng(0).choice(n, reference,
                                                     replace=False)]
    p = torch.as_tensor(points, dtype=torch.float64)
    r = torch.as_tensor(ref, dtype=torch.float64)
    out = []
    for s in range(0, n, 4096):
        d = torch.cdist(p[s:s + 4096], r)
        d, _ = torch.topk(d, min(k + 1, len(ref)), largest=False)
        self_hit = (d[:, 0] == 0)
        pick = torch.where(self_hit[:, None], d[:, 1:k + 1], d[:, :k])
        out.append(pick.mean(-1))
    return np.maximum(torch.cat(out).numpy().astype(np.float32), 1e-7)


def start_state(points, colors, capacity: int, train: dict) -> dict:
    """A new job's state from its seed points (host tensors)."""
    m = train["model"]
    P = len(points)
    if P > capacity:
        raise ValueError("more seed points than capacity")
    K = (m["sh_degree"] + 1) ** 2
    scale = knn_scales(points.astype(np.float32), m["init_scale_knn"])

    def pad(a, fill=0.0):
        a = torch.as_tensor(a)
        extra = a.new_full((capacity - P,) + tuple(a.shape[1:]), fill)
        return torch.cat([a, extra])

    op = m["init_opacity"]
    params = dict(
        means=pad(points.astype(np.float32)),
        quats=pad(np.tile(np.float32([1, 0, 0, 0]), (P, 1))),
        log_scales=pad(np.log(scale)[:, None].repeat(3, 1)),
        logit_opacities=pad(np.full((P,), math.log(op / (1 - op)),
                                    np.float32)),
        sh_dc=pad(((colors.astype(np.float32) - 0.5) / SH_C0)),
        sh_rest=torch.zeros((capacity, K - 1, 3)),
        alive=pad(np.ones((P,), bool), False),
    )
    zeros = {g: torch.zeros_like(params[g]) for g in GROUPS}
    return dict(params=params, mu=dict(zeros),
                nu={g: torch.zeros_like(params[g]) for g in GROUPS},
                count=0, step=0,
                stats={k: torch.zeros((capacity,))
                       for k in ("grad_accum", "grad_count", "max_radii")})


def schedule(step: int, n_train: int, d: dict) -> tuple:
    """(densify, size cull, screen gates) of a refine after ``step``."""
    pause = min(n_train + d["refine_every"], d["reset_opacity_every"] // 2)
    return ((step % d["reset_opacity_every"]) > pause,
            step > d["reset_opacity_every"],
            step < d["stop_screen_size_at"])


def refine(state: dict, flags: tuple, noise: torch.Tensor, d: dict) -> dict:
    """One densify and prune pass over ``state`` (tensors on one device);
    ``noise`` (2, C, 3) places the split children.  Returns the new state
    (parameters, moments, statistics)."""
    do_densify, size_cull, screen = flags
    p = {k: v.clone() for k, v in state["params"].items()}
    st = state["stats"]
    C = p["means"].shape[0]
    dev = p["means"].device
    alive = p["alive"]
    avg = st["grad_accum"] / torch.clamp(st["grad_count"], min=1.0)
    smax = torch.exp(p["log_scales"]).amax(-1)
    cand = (avg > d["grad_threshold"]) & alive
    if not do_densify:
        cand = torch.zeros_like(cand)
    big = smax > d["densify_size_threshold"]
    if screen:
        big = big | (st["max_radii"] > d["split_screen_size"])
    split, clone = cand & big, cand & ~big
    n_child = clone.long() + split.long() * d["split_samples"]

    free = torch.nonzero(~alive).squeeze(-1)          # dead rows in order
    n_free = len(free)
    has = n_child > 0
    src = torch.nonzero(has).squeeze(-1)
    order = src[torch.sort(-avg[src], stable=True).indices]
    first = torch.cumsum(n_child[order], 0) - n_child[order]
    touched = torch.zeros((C,), dtype=torch.bool, device=dev)
    out = {k: v.clone() for k, v in p.items()}
    R = rotation(p["quats"])
    scales = torch.exp(p["log_scales"])
    for k in range(max(1, d["split_samples"])):
        want = n_child[order] > k
        rank = first + k
        ok = want & (rank < n_free)
        s = order[ok]
        dst = free[rank[ok]]
        off = (R[s] @ (noise[k][s] * scales[s])[:, :, None])[:, :, 0]
        is_split = split[s]
        out["means"][dst] = torch.where(is_split[:, None], p["means"][s] + off,
                                        p["means"][s])
        out["log_scales"][dst] = torch.where(
            is_split[:, None],
            p["log_scales"][s] - math.log(d["split_scale_shrink"]),
            p["log_scales"][s])
        for g in ("quats", "logit_opacities", "sh_dc", "sh_rest"):
            out[g][dst] = p[g][s]
        out["alive"][dst] = True
        touched[dst] = True
    died = torch.zeros_like(split)
    died[order] = split[order] & (first + d["split_samples"] - 1 < n_free)
    out["alive"] &= ~died
    prune = torch.sigmoid(out["logit_opacities"]) < d["prune_opacity_threshold"]
    if size_cull:
        too_big = torch.exp(out["log_scales"]).amax(-1) \
            > d["prune_scale_threshold"]
        if screen:
            too_big |= torch.where(touched, torch.zeros_like(st["max_radii"]),
                                   st["max_radii"]) > d["cull_screen_size"]
        prune |= too_big
    out["alive"] &= ~prune
    mu = {g: torch.where(_rows(touched, v), torch.zeros_like(v), v)
          for g, v in state["mu"].items()}
    nu = {g: torch.where(_rows(touched, v), torch.zeros_like(v), v)
          for g, v in state["nu"].items()}
    return dict(params=out, mu=mu, nu=nu,
                stats={k: torch.zeros_like(v) for k, v in st.items()})


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.view((-1,) + (1,) * (like.dim() - 1))


def grow(state: dict, capacity: int) -> dict:
    """``state`` with dead rows appended up to ``capacity``."""
    def pad(x, fill=0):
        extra = x.new_full((capacity - x.shape[0],) + tuple(x.shape[1:]),
                           fill)
        return torch.cat([x, extra])

    p = state["params"]
    params = {k: pad(v, -12.0 if k == "log_scales" else
                     False if k == "alive" else 0) for k, v in p.items()}
    return dict(params=params,
                mu={k: pad(v) for k, v in state["mu"].items()},
                nu={k: pad(v) for k, v in state["nu"].items()},
                stats={k: pad(v) for k, v in state["stats"].items()})
