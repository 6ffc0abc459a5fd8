"""Plain PyTorch reference of Touch-GS training steps: the render of
``splat.py``, the loss (L1 + SSIM + the preset's depth term), autograd
through compositing, projection and spherical harmonics, the screen-space
gradient statistics that densification reads, and Adam.

Written from the method's equations and the configuration file's values;
it imports nothing of the program under test and takes none of its
tensors: it starts from the benchmark's own state and scene.  The view is
composited in blocks of tiles with the forward pass repeated for the
backward (the image's gradient first, then each block's), so that a step
at 1280x720 fits beside nothing else on the card.

``torch.backends`` decide the precision of the matrix products (the
camera transform, the covariances, the SSIM window): the check runs the
reference with TF32 off, and the control with it on.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import splat

GROUPS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
          "sh_rest")
STATS = ("grad_accum", "grad_count", "max_radii")


def raster_consts(train: dict, capacity: int, k_tile: int = None) -> dict:
    """The rasterizer's constants of a configuration's ``train`` section,
    with the k_tile the program composites at this capacity (``k_tile``,
    where the job's truncation guard has raised it, else the section's)."""
    rc = dict(train["rasterize"])
    rc["k_tile"] = splat.fit_k_tile(k_tile or rc["k_tile"], rc["k_chunk"],
                                    capacity)
    return rc


def ssim(x: torch.Tensor, y: torch.Tensor, c1=0.01 ** 2, c2=0.03 ** 2
         ) -> torch.Tensor:
    """Mean SSIM of two (C, H, W) images: an 11x11 Gaussian window of σ 1.5,
    zero-padded at the borders and not renormalised there."""
    g = torch.exp(-(torch.arange(11, dtype=torch.float64) - 5) ** 2
                  / (2 * 1.5 ** 2))
    g = (g / g.sum()).float().to(x.device)
    win = (g[:, None] * g[None, :])[None, None]
    C = x.shape[0]
    st = torch.cat([x, y, x * x, y * y, x * y])[:, None]
    b = F.conv2d(st, win, padding=5)[:, 0]
    mu0, mu1 = b[:C], b[C:2 * C]
    s00 = b[2 * C:3 * C] - mu0 * mu0
    s11 = b[3 * C:4 * C] - mu1 * mu1
    s01 = b[4 * C:] - mu0 * mu1
    m = ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) / (
        (mu0 * mu0 + mu1 * mu1 + c1) * (s00 + s11 + c2))
    return m.mean()


def losses(rgb, depth, image, target_depth, unc, train: dict) -> dict:
    """Total loss (1 − λ)·L1 + λ·(1 − SSIM) + mult·depth term, and its
    parts.  The depth term is the mean |d − d*| over pixels with a target,
    weighted by 1 / (1 + w·σ) under DEPTH_UNCERTAINTY_WEIGHTED_LOSS."""
    lam = train["ssim_lambda"]
    dcfg = train["depth"]
    l1 = (rgb - image).abs().mean()
    s = ssim(rgb.permute(2, 0, 1), image.permute(2, 0, 1))
    total = (1 - lam) * l1 + lam * (1 - s)
    d_loss = torch.zeros((), device=rgb.device)
    if target_depth is not None:
        valid = target_depth > 0
        res = (depth - target_depth).abs()
        if (dcfg["depth_loss_type"] == "DEPTH_UNCERTAINTY_WEIGHTED_LOSS"
                and unc is not None):
            if dcfg["uncertainty_form"] != "inv":
                raise ValueError("the reference weighs by 1 / (1 + w·σ)")
            res = res / (1.0 + dcfg["uncertainty_weight"] * unc)
        d_loss = torch.where(valid, res, torch.zeros_like(res)).sum() \
            / torch.clamp(valid.sum(), min=1)
        total = total + dcfg["depth_loss_mult"] * d_loss
    return dict(loss=total, rgb_l1=l1, ssim_loss=1 - s, depth_loss=d_loss)


def loss_and_grads(params: dict, cam: dict, view: dict, train: dict,
                   active_sh: int, k_tile: int = None) -> tuple:
    """One view's losses, the gradients of every group of ``params``, the
    loss's gradient at each Gaussian's screen position (N, 2), and its
    projection."""
    rc = raster_consts(train, params["means"].shape[0], k_tile)
    W, H = cam["width"], cam["height"]
    th, tw = rc["tile_h"], rc["tile_w"]
    n_tx, n_ty = splat.tile_grid(W, H, rc)
    leaves = {g: params[g].detach().clone().requires_grad_(True)
              for g in GROUPS}
    p = dict(params, **leaves)
    attr_g, proj = splat.attributes(p, cam, rc, active_sh)
    lists, counts = splat.bin_tiles(proj, W, H, rc)
    attr = attr_g.detach().requires_grad_(True)
    bg = torch.tensor(train["model"]["background"], dtype=torch.float32,
                      device=attr.device)

    # the image's gradient, then each block's forward again with its part
    stack = splat.render_stack(attr, lists, counts, W, H, rc)
    stack.requires_grad_(True)
    rgb, depth, _ = splat.finish(stack, W, H, bg)
    out = losses(rgb, depth, view["image"], view["depth"], view["unc"],
                 train)
    out["loss"].backward()
    g_tiles = splat.unassemble(stack.grad, n_tx, n_ty, th, tw)
    B = splat.block_size(lists.shape[1], th * tw)
    for s, e in splat.tile_blocks(n_tx * n_ty, B):
        tiles = torch.arange(s, e, device=attr.device)
        blk = splat.composite(attr, lists[s:e], counts[s:e], tiles, n_tx, rc)
        blk.backward(g_tiles[s:e])
    attr_g.backward(attr.grad)
    grads = {g: leaves[g].grad for g in GROUPS}
    return ({k: float(v.detach()) for k, v in out.items()}, grads,
            attr.grad[:, :2].detach(), proj)


def update_stats(stats: dict, g2d, proj, W: int, H: int) -> None:
    """Screen-space statistics in splatfacto's units: the gradient norm at
    the pixel position times ½·max(W, H), the radius over max(W, H), for
    the Gaussians that projected."""
    m = float(max(W, H))
    vis = proj["valid"].float()
    g = torch.linalg.vector_norm(g2d, dim=-1) * (0.5 * m)
    stats["grad_accum"] += g * vis
    stats["grad_count"] += vis
    stats["max_radii"] = torch.maximum(stats["max_radii"],
                                       proj["radii"] / m * vis)


def adam(params: dict, grads: dict, opt: dict, train: dict) -> None:
    """Adam with bias correction and ε after the root, per group; the
    means' rate decays exponentially with the step count read before its
    increment (init·(final/init)^(count/steps), floored at final)."""
    o = train["optim"]
    b1, b2 = train["adam"]["b1"], train["adam"]["b2"]
    n = opt["count"]
    if n <= 0:
        lr_means = o["means_lr_init"]
    else:
        lr_means = max(o["means_lr_init"] * (o["means_lr_final"]
                                             / o["means_lr_init"])
                       ** (n / o["means_lr_max_steps"]), o["means_lr_final"])
    lrs = dict(means=lr_means, quats=o["quats_lr"], log_scales=o["scales_lr"],
               logit_opacities=o["opacities_lr"], sh_dc=o["features_dc_lr"],
               sh_rest=o["features_rest_lr"])
    n += 1
    opt["count"] = n
    bc1, bc2 = 1 - b1 ** n, 1 - b2 ** n
    for k, g in grads.items():
        opt["mu"][k] = b1 * opt["mu"][k] + (1 - b1) * g
        opt["nu"][k] = b2 * opt["nu"][k] + (1 - b2) * g * g
        params[k] = params[k] - lrs[k] * (
            opt["mu"][k] / bc1) / (torch.sqrt(opt["nu"][k] / bc2) + o["eps"])


def steps(state: dict, views: list, scene, train: dict, device,
          k_tile: int = None) -> dict:
    """Follow the program's first steps from the benchmark's own start
    ``state`` (host tensors: params, mu, nu, count, step, stats) over the
    views it chose (``scene.view(i, device)``).  Returns each step's
    losses, the gradient of the first step by group, the statistics after
    it, and the parameters and statistics after the last."""
    def own(d):
        return {k: v.to(device).clone() for k, v in d.items()}

    params = own(state["params"])
    opt = dict(count=int(state["count"]), mu=own(state["mu"]),
               nu=own(state["nu"]))
    stats = own(state["stats"])
    step = int(state["step"])
    rows, grad1, stats1 = [], None, None
    for view in views:
        cam, data = scene.view(view, device)
        active = min(step // train["sh_degree_interval"],
                     train["model"]["sh_degree"])
        out, grads, g2d, proj = loss_and_grads(params, cam, data, train,
                                               active, k_tile)
        rows.append(out)
        if grad1 is None:
            grad1 = {k: v.detach().to("cpu", copy=True) for k, v in grads.items()}
        with torch.no_grad():
            adam(params, grads, opt, train)
            update_stats(stats, g2d, proj, cam["width"], cam["height"])
        if stats1 is None:
            stats1 = {k: v.to("cpu", copy=True) for k, v in stats.items()}
        step += 1
        del grads, g2d, proj
    return dict(rows=rows, grad1=grad1, stats1=stats1,
                params={k: params[k].detach().to("cpu", copy=True) for k in GROUPS},
                stats={k: v.to("cpu", copy=True) for k, v in stats.items()})


def norms(tensors: dict, keys, rows=None) -> dict:
    """Each tensor's 2-norm in float64 over ``rows`` (a bool mask of the
    leading axis) where given."""
    out = {}
    for k in keys:
        t = tensors[k]
        if rows is not None:
            t = t[rows]
        out[k] = float(torch.linalg.vector_norm(t.double()))
    return out


def median(values) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's |‖prog‖ − ‖ref‖| over max(‖ref‖ of that leaf, the median
    leaf's ‖ref‖)."""
    med = median([ref[k] for k in keys])
    out = {}
    for k in keys:
        d = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        out[k] = d if math.isfinite(d) else math.inf
    return out


def median_gap(prog: dict, ref: dict, keys) -> float:
    """The median leaf's gap of ``leaf_gaps``."""
    return median(leaf_gaps(prog, ref, keys).values())


def gap(prog: dict, ref: dict, keys) -> tuple:
    """The worst leaf's gap of ``leaf_gaps``, and the leaf."""
    gaps = leaf_gaps(prog, ref, keys)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf
