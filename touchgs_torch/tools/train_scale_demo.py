"""Full-scene quality demo at bench scale (port of
``tools/train_scale_demo.py``).

Builds a synthetic Blender-like scene with real geometry — a textured sphere
resting on a checkered ground plane, surface-sampled into 100k GT Gaussians
— renders ground-truth RGB + depth from a camera ring, then trains from
noisy sparse seeds at large capacity (densify/prune active) and reports
PSNR, SSIM, LPIPS, depth MAE and it/s.  On the card:

    python -m touchgs_torch.tools.train_scale_demo --steps 2000 --capacity 1048576

On CUDA every render goes through the tile kernels (``use_pallas=True``);
with ``--device cpu`` through the scan path, as the JAX demo does off the
TPU.  Writes its markdown to ``--out``, else ``scale_demo.md`` under
``--render-dir`` (default ``$TMPDIR/scale_demo``), beside the eval renders.
``main(argv)`` returns the summary it prints.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from touchgs_torch.config import (DensifyConfig, DepthLossConfig,
                                  DepthLossType, ModelConfig, OptimConfig,
                                  RasterizeConfig, TrainConfig)
from touchgs_torch.data.cameras import Camera, Cameras
from touchgs_torch.data.scene import Scene
from touchgs_torch.eval.runner import evaluate_scene
from touchgs_torch.models.gaussians import GaussianParams
from touchgs_torch.models.splatfacto import (_LOSSLESS_K, render,
                                             render_lossless)
from touchgs_torch.ops.sh import rgb_to_sh_dc
from touchgs_torch.train.trainer import Trainer


def build_gt_gaussians(n_sphere=60_000, n_plane=40_000, seed=0):
    """Surface-sampled GT: textured sphere (r=0.5 at origin) + checkered
    ground plane (z=-0.5), small isotropic splats.  numpy (means, quats,
    scales, colors, opacities), the JAX demo's to the bit."""
    rng = np.random.default_rng(seed)
    # sphere surface
    v = rng.normal(size=(n_sphere, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    sph = v * 0.5
    # procedural texture: bands + polka dots
    u = np.arctan2(sph[:, 1], sph[:, 0])
    lat = np.arcsin(np.clip(sph[:, 2] / 0.5, -1, 1))
    sph_col = np.stack([
        0.5 + 0.45 * np.sin(6 * u),
        0.5 + 0.45 * np.sin(8 * lat + 1.3),
        0.5 + 0.45 * np.sin(4 * u + 3 * lat),
    ], axis=1)
    # plane
    xy = rng.uniform(-1.6, 1.6, (n_plane, 2))
    pl = np.concatenate([xy, np.full((n_plane, 1), -0.5)], axis=1)
    checker = ((np.floor(xy[:, 0] * 2.5) + np.floor(xy[:, 1] * 2.5)) % 2)
    pl_col = np.stack([0.2 + 0.6 * checker, 0.25 + 0.5 * checker,
                       0.3 + 0.4 * (1 - checker)], axis=1)

    means = np.concatenate([sph, pl]).astype(np.float32)
    colors = np.concatenate([sph_col, pl_col]).astype(np.float32)
    n = len(means)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    scales = np.full((n, 3), 0.008, np.float32)
    opac = np.full((n,), 0.9, np.float32)
    return means, quats, scales, colors, opac


def look_at_camera(eye=(0.0, 0.0, 2.5), target=(0.0, 0.0, 0.0),
                   width: int = 160, height: int = 120, focal: float = 150.0,
                   device: torch.device | str = "cuda") -> Camera:
    """OpenGL-convention c2w camera looking at ``target`` from ``eye``."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    up_hint = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(fwd, up_hint)) > 0.99:
        up_hint = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up_hint)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = -fwd  # OpenGL: camera looks down -Z
    c2w[:3, 3] = eye

    def scalar(v):
        return torch.tensor(np.float32(v), device=device)

    return Camera(fx=scalar(focal), fy=scalar(focal), cx=scalar(width / 2),
                  cy=scalar(height / 2),
                  c2w=torch.as_tensor(c2w.astype(np.float32), device=device),
                  width=width, height=height)


def ring_cameras(n_views, width, height, radius=2.2, z=0.8, focal_mul=1.0,
                 device: torch.device | str = "cuda") -> list:
    cams = []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        cams.append(look_at_camera(
            eye=(radius * np.cos(a), radius * np.sin(a), z),
            target=(0, 0, -0.1), width=width, height=height,
            focal=focal_mul * 0.9 * width, device=device))
    return cams


def lossless_gt_raster(use_pallas: bool) -> RasterizeConfig:
    """Raster config for oracle GT renders, the JAX demo's: k_tile 8192 and
    32 tiles a Gaussian (the training-path cap of 512 truncates the GT,
    RESULTS_r04.md).  On an H100 every 800x800 view of the demo rendered
    with 0 lossy tiles; callers still check each render with
    ``assert_lossless``."""
    return RasterizeConfig(use_pallas=use_pallas, k_tile=8192,
                           max_tiles_per_gaussian=32)


def assert_lossless(out):
    if out.lossy_tiles is not None and int(out.lossy_tiles) != 0:
        raise RuntimeError(
            f"GT render truncated ({int(out.lossy_tiles)} lossy tiles): "
            "raise the GT k_tile")
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--capacity", type=int, default=2 ** 20)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--seed-points", type=int, default=30_000)
    ap.add_argument("--out", default=None,
                    help="output md; default scale_demo.md in --render-dir")
    ap.add_argument("--render-dir",
                    default=os.path.join(tempfile.gettempdir(), "scale_demo"),
                    help="eval renders (PNG); '' renders none")
    ap.add_argument("--densify-grad", type=float, default=0.0002,
                    help="positional-gradient densify threshold")
    ap.add_argument("--polish", type=int, default=300,
                    help="steps after densify stops")
    ap.add_argument("--sh-interval", type=int, default=0,
                    help="SH degree growth interval (0 = steps//3)")
    ap.add_argument("--reset-opacity-every", type=int, default=10 ** 9)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the tile kernels) or cpu (the scan path)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("train_scale_demo wants a CUDA device and none "
                               "is available; pass --device cpu for the CPU")
        from touchgs_torch.utils.profiling import card

        device_name = card()
    else:
        device_name = "cpu"
    use_pallas = dev.type == "cuda"
    print(f"device: {device_name}", flush=True)

    W, H = args.width, args.height
    means, quats, scales, colors, opac = build_gt_gaussians()
    G = means.shape[0]

    def t(a):
        return torch.as_tensor(a, device=dev)

    # sh_degree 1 with zero rest coefficients: flat colours, as in the JAX
    # demo (which avoids a degree-0 model's zero-size sh_rest)
    gt = GaussianParams(
        means=t(means), quats=t(quats), log_scales=t(np.log(scales)),
        logit_opacities=t(np.log(opac / (1 - opac))),
        sh_dc=t(rgb_to_sh_dc(colors)),
        sh_rest=torch.zeros((G, 3, 3), device=dev),
        alive=torch.ones((G,), dtype=torch.bool, device=dev))
    gt_cfg = ModelConfig(max_gaussians=G, sh_degree=1,
                         rasterize=lossless_gt_raster(use_pallas))
    cams = ring_cameras(args.views, W, H, device=dev)

    print("rendering GT views...", flush=True)
    images, depths, gt_lossy = [], [], []
    for cam in cams:
        with torch.no_grad():
            out = assert_lossless(render(gt, cam, gt_cfg,
                                         active_sh_degree=1)[0])
        images.append(out.rgb.cpu().numpy())
        depths.append(out.depth.cpu().numpy())
        if out.lossy_tiles is not None:
            gt_lossy.append(int(out.lossy_tiles))
        del out  # the k_tile 8192 rows go before the next view
    images = np.stack(images)
    depths = np.stack(depths)
    del gt

    rng = np.random.default_rng(1)
    take = rng.choice(G, size=args.seed_points, replace=False)
    seeds = means[take] + rng.normal(
        0, 0.01, (args.seed_points, 3)).astype(np.float32)
    seed_cols = colors[take]

    scene = Scene(
        cameras=Cameras(
            fx=np.array([float(c.fx) for c in cams], np.float32),
            fy=np.array([float(c.fy) for c in cams], np.float32),
            cx=np.array([float(c.cx) for c in cams], np.float32),
            cy=np.array([float(c.cy) for c in cams], np.float32),
            c2w=np.stack([c.c2w.cpu().numpy() for c in cams]),
            width=W, height=H),
        images=images, depths=depths,
        uncertainties=np.ones_like(depths),
        i_train=np.arange(0, args.views)[
            np.arange(args.views) % 4 != 3],     # 3/4 train
        i_eval=np.arange(0, args.views)[np.arange(args.views) % 4 == 3],
        seed_points=seeds, seed_colors=seed_cols,
        scale_factor=1.0, transform=np.eye(4)[:3], name="scale_demo")

    cfg = TrainConfig(
        max_steps=args.steps,
        model=ModelConfig(max_gaussians=args.capacity, sh_degree=2,
                          rasterize=RasterizeConfig(use_pallas=use_pallas)),
        depth=DepthLossConfig(0.1, DepthLossType.SIMPLE_LOSS, 0.0),
        densify=DensifyConfig(warmup_steps=300, refine_every=100,
                              stop_refine_at=max(args.steps - args.polish,
                                                 400),
                              grad_threshold=args.densify_grad,
                              reset_opacity_every=args.reset_opacity_every),
        optim=OptimConfig(means_lr_max_steps=args.steps),
        sh_degree_interval=args.sh_interval or max(args.steps // 3, 1),
        log_every=200,
    )
    trainer = Trainer(scene, cfg, device=dev)
    print(f"training: capacity={args.capacity} steps={args.steps} "
          f"seeds={args.seed_points} "
          f"({'tile kernels' if use_pallas else 'scan path'})", flush=True)
    t0 = time.time()
    trainer.run(log_fn=lambda m: print(m, flush=True))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.time() - t0
    ips = args.steps / train_s

    # eval: PSNR + depth MAE on held-out views
    results = evaluate_scene(trainer.state.params, scene, cfg,
                             gt_depths=depths, is_real_world=True,
                             render_dir=args.render_dir or None)
    alive = int(trainer.state.params.num_alive)

    # depth MAE (masked) on eval views
    maes = []
    for i in scene.i_eval:
        out = render_lossless(trainer.state.params,
                              scene.cameras.at(int(i), dev), cfg.model,
                              active_sh_degree=2)
        d = out.depth.cpu().numpy()
        m = depths[i] > 0
        maes.append(float(np.abs(d - depths[i])[m].mean()))
    depth_mae = float(np.mean(maes))

    hist = trainer.history
    summary = {
        "device": device_name, "steps": args.steps,
        "capacity": args.capacity, "views": args.views,
        "resolution": f"{W}x{H}",
        "rasterizer": "tile kernels" if use_pallas else "scan path",
        "final_alive_gaussians": alive,
        "train_iters_per_sec": round(ips, 2),
        "eval": {k: round(v, 4) for k, v in results.items()},
        "eval_depth_mae_m": round(depth_mae, 5),
        "events": dict(trainer.events),
        "k_tile_escalations": [[m["step"], m["k_tile_escalated_to"]]
                               for m in hist if "k_tile_escalated_to" in m],
        # lossy tiles of the GT renders, and at each log point the step's
        # and the window's (tile kernels only; the scan path has none)
        "lossy_census": {
            "gt_views": gt_lossy,
            "train": [[m["step"], m["lossy_tiles"],
                       m["lossy_tiles_window_max"]]
                      for m in hist if "lossy_tiles" in m],
            "eval_k_tile": _LOSSLESS_K.get(
                (trainer.state.params.capacity, W, H)),
        },
    }
    print(json.dumps(summary, indent=2), flush=True)

    md = (Path(args.out) if args.out
          else Path(args.render_dir) / "scale_demo.md" if args.render_dir
          else None)
    if md is not None:
        md.parent.mkdir(parents=True, exist_ok=True)
        md.write_text(f"""# Full-scene training at bench scale (PyTorch port)

Synthetic Blender-like scene (textured sphere + checkered plane, 100k GT
splats), {args.views} views at {W}x{H}, trained from {args.seed_points}
noisy seed points at capacity {args.capacity} with densify/clone/split/prune
active, on {device_name} ({summary['rasterizer']}).

| metric | value |
|---|---|
| train steps | {args.steps} |
| iters/sec (incl. host loop) | {ips:.2f} |
| final alive Gaussians | {alive} |
| eval PSNR | {results['psnr']:.2f} dB |
| eval SSIM | {results['ssim']:.4f} |
| eval LPIPS | {results['lpips']:.4f} |
| eval depth MAE | {depth_mae * 100:.2f} cm |
| gt_depth_mse | {results.get('gt_depth_mse', float('nan')):.5f} |
| refines, opacity resets, capacity growths | {trainer.events['refine']}, {trainer.events['reset_opacity']}, {trainer.events['grow']} |
| k_tile escalations (step, k_tile) | {summary['k_tile_escalations']} |

Renders: `{args.render_dir or 'none'}`.
Reproduce: `python -m touchgs_torch.tools.train_scale_demo --steps {args.steps} \\
    --capacity {args.capacity}`
""")
        print(f"wrote {md}", flush=True)
    return summary


if __name__ == "__main__":
    main()
    sys.exit(0)
