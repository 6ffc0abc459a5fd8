"""Start states the benchmark makes from ``--seed`` on the device, in a few
large draws.

``surface_state``: a scene in its polish phase.  The configuration's
``state`` section places ``live_gaussians`` on the analytic surfaces
(``sphere_fraction`` of them on the sphere, the rest on the plane), each
``scale_mult`` times the spacing of its neighbours in size (log-normal,
``scale_spread``) with a random orientation, of an opacity uniform in
``opacity``, its DC colour the surface's texture and its higher bands
small; the rest of the capacity is dead.  Adam's count is the start step,
its first moments zero and its second moments ``adam_nu`` everywhere
(``traffic`` names the value), so that the first updates are proportional
to the gradients, as they are late in a job.
"""
from __future__ import annotations

import math

import torch

from perfbench.scene import analytic

SH_C0 = 0.28209479177387814
GROUPS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
          "sh_rest")


def surface_state(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """{params, mu, nu, count, step, stats} as tensors on ``device``, the
    field names and dtypes of the program's checkpoint."""
    m = cfg["train"]["model"]
    C, n = m["max_gaussians"], cfg["state"]["live_gaussians"]
    K = (m["sh_degree"] + 1) ** 2
    start = traffic["start"]
    g = torch.Generator(device=device)
    g.manual_seed((seed + 1) % (1 << 63))
    pts, cols, n_s = analytic.surface_points(n, g, device,
                                             cfg["state"]["sphere_fraction"])
    spacing = torch.cat([
        torch.full((n_s,), math.sqrt(4 * math.pi * analytic.SPHERE_R ** 2
                                     / n_s), device=device),
        torch.full((n - n_s,), math.sqrt((2 * analytic.PLANE_HALF) ** 2
                                         / (n - n_s)), device=device)])
    z = torch.randn((n, 4 + 3 + 45), generator=g, device=device)
    u = torch.rand((n,), generator=g, device=device)
    quats = z[:, :4] / torch.linalg.vector_norm(z[:, :4], dim=-1,
                                                keepdim=True)
    sc = cfg["state"]
    log_scales = (torch.log(sc["scale_mult"] * spacing)[:, None]
                  + sc["scale_spread"] * z[:, 4:7])
    lo, hi = sc["opacity"]
    op = lo + (hi - lo) * u
    sh_rest = 0.03 * z[:, 7:7 + 3 * (K - 1)].reshape(n, K - 1, 3)

    def pad(x, fill):
        extra = x.new_full((C - n,) + tuple(x.shape[1:]), fill)
        return torch.cat([x, extra]).contiguous()

    params = dict(
        means=pad(pts, 0.0),
        quats=pad(quats, 0.0),
        log_scales=pad(log_scales, -12.0),
        logit_opacities=pad(torch.log(op / (1 - op)), 0.0),
        sh_dc=pad((cols - 0.5) / SH_C0, 0.0),
        sh_rest=pad(sh_rest, 0.0),
        alive=pad(torch.ones((n,), dtype=torch.bool, device=device), False),
    )
    # dead slots carry the identity rotation: a zero quaternion's norm
    # has no gradient
    params["quats"][n:, 0] = 1.0
    step = start["step"]
    return dict(
        params=params,
        mu={k: torch.zeros_like(params[k]) for k in GROUPS},
        nu={k: torch.full_like(params[k], start["adam_nu"]) for k in GROUPS},
        count=step, step=step,
        stats={k: torch.zeros((C,), device=device)
               for k in ("grad_accum", "grad_count", "max_radii")},
    )

