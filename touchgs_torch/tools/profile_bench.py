"""Stage-by-stage timing of the flagship train step on the card (port of
``tools/profile_bench.py``).

Times the whole step and its pieces one by one, so that the kernel work can
be attributed before anything is optimised: the step run eagerly (the
graphed step's ``__wrapped__``), the step as a CUDA graph
(``train/graphs.py``, as ``make_train_step`` returns it on the card; its
capture is among the warm-up calls), the K_TILE = 1024 gather
``attrs[gidx]``, the forward render, forward + backward, SSIM and its
gradient, Adam, the gather's scatter-add backward, SH and its gradient, the
full loss and its gradient, projection and binning.  The flagship is
800x800 with 100k Gaussians in a capacity of 131072 and SH degree 3.

    python -m touchgs_torch.tools.profile_bench

Every time is ``utils.profiling.measure`` (CUDA events).  A stage that
raises is printed as FAILED and the script exits with status 1 at its end;
without a CUDA card it exits with status 1 at once.  ``build_stages`` takes
a ``device`` and sizes, so that the tests run each stage on the CPU.
"""
from __future__ import annotations

import dataclasses
import sys
import traceback

import numpy as np
import torch

from touchgs_torch.config import ModelConfig, RasterizeConfig, TrainConfig
from touchgs_torch.models.densify import DensifyState
from touchgs_torch.models.gaussians import init_random
from touchgs_torch.models.splatfacto import compute_losses, render
from touchgs_torch.ops.projection import project_gaussians
from touchgs_torch.ops.rasterize_cuda import _pack_attrs, rasterize_cuda
from touchgs_torch.ops.sh import eval_sh
from touchgs_torch.ops.ssim import ssim_cm
from touchgs_torch.ops.tiles import bin_gaussians
from touchgs_torch.tools.pair_stats import bench_camera
from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam
from touchgs_torch.train.trainer import TrainState, make_train_step
from touchgs_torch.utils.profiling import card, measure

WIDTH = HEIGHT = 800
N_GAUSSIANS, CAPACITY = 100_000, 131_072
K_TILE = 1024  # entries per tile of the isolated gather and scatter


def build_stages(device="cuda", width: int = WIDTH, height: int = HEIGHT,
                 n: int = N_GAUSSIANS, capacity: int = CAPACITY) -> list:
    """[(name, fn, args)] for the stages, in the order they are printed;
    ``fn(*args)`` runs one stage once."""
    rcfg = RasterizeConfig(use_pallas=True)
    cfg = TrainConfig(model=ModelConfig(max_gaussians=capacity, sh_degree=3,
                                        rasterize=rcfg))
    params = init_random(n=n, capacity=capacity, sh_degree=3, device=device)
    cam = bench_camera(width, height, device)

    def proj_of(p, means=None):
        return project_gaussians(
            p.means if means is None else means, p.quats, p.scales(),
            cam.w2c, cam.fx, cam.fy, cam.cx, cam.cy, width, height, rcfg,
            extra_valid=p.alive)

    @torch.no_grad()
    def f_project(p):
        return proj_of(p)

    @torch.no_grad()
    def f_bin(p):
        return bin_gaussians(proj_of(p), width, height, rcfg)

    opac = params.opacities().detach()
    colors = params.sh_dc.abs()

    @torch.no_grad()
    def f_fwd(p):
        return rasterize_cuda(proj_of(p), colors, opac, width, height,
                              rcfg).rgb

    def f_fwd_bwd(p):
        means = p.means.detach().requires_grad_(True)
        out = rasterize_cuda(proj_of(p, means), colors, opac, width, height,
                             rcfg)
        return torch.autograd.grad(out.rgb.sum() + out.depth.sum(), means)[0]

    rng = np.random.default_rng(0)
    image = torch.as_tensor(rng.uniform(0, 1, (height, width, 3))
                            .astype(np.float32), device=device)
    depth = torch.as_tensor(rng.uniform(1, 3, (height, width))
                            .astype(np.float32), device=device)
    unc = torch.ones((height, width), device=device)

    optimizer = FusedAdam(cfg.optim)
    # the step updates its state in place: give it copies, so the other
    # stages keep the initial parameters
    step_params = dataclasses.replace(
        params, **{f.name: getattr(params, f.name).clone()
                   for f in dataclasses.fields(params)})
    state = TrainState(
        params=step_params,
        opt_state=optimizer.init({g: getattr(step_params, g)
                                  for g in PARAM_GROUPS}),
        densify=DensifyState.zeros(capacity, device), step=0)
    train_step = make_train_step(cfg, optimizer)

    def f_step():
        return train_step.__wrapped__(state, cam, image, depth, unc, 3)

    def f_graphed():
        return train_step(state, cam, image, depth, unc, 3)

    # the gather attrs[gidx] and its scatter-add backward, alone
    proj0 = f_project(params)
    bins0 = f_bin(params)
    attrs0 = _pack_attrs(proj0, colors, opac)
    ks = torch.arange(K_TILE, device=device)
    m = bins0.sorted_gauss.shape[0]
    ptr = torch.clamp(bins0.tile_starts[:, None] + ks[None, :], 0, m - 1)
    in_list = ks[None, :] < torch.clamp(bins0.tile_counts, max=K_TILE)[:, None]
    gidx0 = torch.where(in_list, bins0.sorted_gauss[ptr],
                        torch.full_like(ptr, attrs0.shape[0] - 1))

    def f_gather(attrs):
        return attrs[gidx0]

    dattrs0 = f_gather(attrs0)

    def f_scatter(dat):
        # what autograd runs for the backward of attrs[gidx0]
        return torch.zeros_like(attrs0).index_put_((gidx0,), dat,
                                                    accumulate=True)

    def f_ssim_grad(img):
        img = img.detach().requires_grad_(True)
        s = ssim_cm(img.permute(2, 0, 1), image.permute(2, 0, 1))
        return torch.autograd.grad(s, img)[0]

    def f_sh_grad(dc, rest):
        dc = dc.detach().requires_grad_(True)
        rest = rest.detach().requires_grad_(True)
        sh = torch.cat([dc[:, None, :], rest], dim=1)
        dirs = params.means / (params.means.norm(dim=-1, keepdim=True) + 1e-9)
        return torch.autograd.grad(eval_sh(sh, dirs, 3, 3).sum(), (dc, rest))

    def f_full_loss_grad(p):
        diff = {g: getattr(p, g).detach().requires_grad_(True)
                for g in PARAM_GROUPS}
        off = torch.zeros((p.capacity, 2), device=device, requires_grad=True)
        out, _ = render(dataclasses.replace(p, **diff), cam, cfg.model,
                        active_sh_degree=3, means2d_offset=off)
        losses = compute_losses(out, image, depth, unc, cfg.depth, 0.2)
        return torch.autograd.grad(losses.total, list(diff.values()) + [off])

    adam_params = {g: getattr(params, g).detach().clone() for g in PARAM_GROUPS}
    adam_state = optimizer.init(adam_params)
    ones = {g: torch.ones_like(v) for g, v in adam_params.items()}

    def f_adam(p, opt_state):
        optimizer.step(p, ones, opt_state)
        return p

    return [
        ("step:", f_step, ()),
        ("graphed:", f_graphed, ()),
        ("gather:", f_gather, (attrs0,)),
        ("fwd:", f_fwd, (params,)),
        ("fwd+bwd:", f_fwd_bwd, (params,)),
        ("ssim+grad:", f_ssim_grad, (image,)),
        ("adam:", f_adam, (adam_params, adam_state)),
        ("scatter:", f_scatter, (dattrs0,)),
        ("sh+grad:", f_sh_grad, (params.sh_dc, params.sh_rest)),
        ("loss+grad:", f_full_loss_grad, (params,)),
        ("project:", f_project, (params,)),
        ("bin:", f_bin, (params,)),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_bench: needs a CUDA device; nothing was timed",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card(), flush=True)
    failed = []
    for name, fn, args in build_stages():
        try:
            ms = measure(fn, *args, iters=20) * 1e3
            print(f"{name:<10} {ms:8.3f} ms", flush=True)
        except Exception as e:  # noqa: BLE001  (reported, and exit is 1)
            failed.append(name)
            print(f"{name:<10} FAILED: {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
            traceback.print_exc()
    if failed:
        print(f"profile_bench: {len(failed)} stage(s) failed: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
