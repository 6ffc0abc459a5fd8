"""Hard-scene A/B: touch-dominant, vision-unreliable (port of
``tools/train_hard_scene.py``).

The synthetic analogue of the paper's mirror scene, end to end through the
port's touch pipeline:

- a textureless matte sphere on the textured checkered plane of the scale
  demo, so photometric supervision carries almost no geometry on the
  object;
- "vision" monodepth that reads the surface behind the object (the
  plane-only depth) there, with a global affine miscalibration;
- "touch": contact patches on the sphere, a GPIS fitted to their points and
  ray-marched into per-view depth and variance maps (``touch/gpis.py``);
- two-stage alignment, uncertainty synthesis and Bayesian fusion
  (``touch/fusion.py::fuse_view``), and touch seeding
  (``touch/pointcloud.py::seed_point_cloud``).

Arm A (Touch-GS) trains on the fused depth with the uncertainty-weighted
loss (mult 0.2, weight 1.0) from the scene seeds plus touch seeds; arm B
(vision-only DS-GS) on the stage-1-aligned vision depth with the simple
loss, from the scene seeds alone.  Everything else is the same.  On the
card:

    python -m touchgs_torch.tools.train_hard_scene --views 24 \\
        --touch-patches 60 --steps 6000 --sh-degree 0

On CUDA every render goes through the tile kernels (``use_pallas=True``),
as the JAX tool picks Pallas on the TPU; with ``--device cpu`` through the
scan path.  TF32 is off for every matmul, solve and Cholesky.  Writes its
markdown to ``--out`` (default ``hard_scene.md`` in the temporary
directory) and eval renders only with ``--render-dir``.  ``main(argv)``
returns both arms' rows and the stage times.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from touchgs_torch.config import (DensifyConfig, DepthLossConfig,
                                  DepthLossType, ModelConfig, OptimConfig,
                                  RasterizeConfig, TrainConfig)
from touchgs_torch.data.cameras import Cameras
from touchgs_torch.data.png import write_png
from touchgs_torch.data.scene import Scene
from touchgs_torch.eval.lpips_vgg import fp32
from touchgs_torch.models.gaussians import GaussianParams
from touchgs_torch.models.splatfacto import render, render_lossless
from touchgs_torch.ops.sh import rgb_to_sh_dc
from touchgs_torch.tools.train_scale_demo import (assert_lossless,
                                                  build_gt_gaussians,
                                                  lossless_gt_raster,
                                                  ring_cameras)
from touchgs_torch.touch.fusion import fuse_view
from touchgs_torch.touch.gpis import GPIS, fit_gpis, render_depth_var
from touchgs_torch.touch.pointcloud import backproject_depth, seed_point_cloud
from touchgs_torch.train.trainer import Trainer

N_SPHERE = 60_000     # the first build_gt_gaussians points are the sphere's
TOUCH_SEED_PERCENT = 5.0    # the mirror preset's --percent_take
SCENE_SEEDS = 20_000        # scene seeds backprojected from vision depth


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--capacity", type=int, default=2 ** 17)
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--touch-patches", type=int, default=30)
    ap.add_argument("--patch-radius", type=float, default=0.09)
    ap.add_argument("--sh-degree", type=int, default=2,
                    help="SH degree for both arms (0 = the view-dependence "
                         "ablation row)")
    ap.add_argument("--unc-form", default="inv_sq",
                    choices=["inv_sq", "inv", "exp"],
                    help="uncertainty weighting form for arm A")
    ap.add_argument("--no-gpis", action="store_true",
                    help="raw patch-only touch depth instead of the GPIS's "
                         "depth and variance")
    ap.add_argument("--gpis-max-points", type=int, default=512)
    ap.add_argument("--gpis-seed", type=int, default=0,
                    help="seed of the GPIS's draw of --gpis-max-points "
                         "contacts (0 as the JAX tool); ROADMAP C17's "
                         "spread runs vary it")
    ap.add_argument("--skip-baseline", action="store_true",
                    help="run only arm A (ablation rows)")
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(),
                                         "hard_scene.md"),
                    help="output markdown")
    ap.add_argument("--render-dir", default=None,
                    help="eval renders (PNG); none by default")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the tile kernels) or cpu (the scan path)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the streams the port draws its own way: "
                         "the fusion's 1%% masks, the trainer's views and "
                         "split noise (the scene and sensors stay); ROADMAP "
                         "C17's spread runs vary it")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def render_gt(views: int, size: int, dev: torch.device, use_pallas: bool
              ) -> dict:
    """GT and plane-only renders of the textureless sphere on the checkered
    plane from ``ring_cameras``; numpy (V, H, W[, 3]) stacks."""
    means, quats, scales, colors, opac = build_gt_gaussians()
    G = means.shape[0]
    flat = colors.copy()
    flat[:N_SPHERE] = (0.82, 0.82, 0.85)      # the uniform matte sphere

    def t(a):
        return torch.as_tensor(a, device=dev)

    gt = GaussianParams(
        means=t(means), quats=t(quats), log_scales=t(np.log(scales)),
        logit_opacities=t(np.log(opac / (1 - opac))),
        sh_dc=t(rgb_to_sh_dc(flat)), sh_rest=torch.zeros((G, 3, 3),
                                                         device=dev),
        alive=torch.ones((G,), dtype=torch.bool, device=dev))
    plane_alive = gt.alive.clone()
    plane_alive[:N_SPHERE] = False
    plane_only = dataclasses.replace(gt, alive=plane_alive)
    gt_cfg = ModelConfig(max_gaussians=G, sh_degree=1,
                         rasterize=lossless_gt_raster(use_pallas))
    cams = ring_cameras(views, size, size, device=dev)
    images, depths, plane_depths, lossy = [], [], [], []
    for cam in cams:
        with torch.no_grad():
            out = assert_lossless(render(gt, cam, gt_cfg,
                                         active_sh_degree=1)[0])
            plane = assert_lossless(render(plane_only, cam, gt_cfg,
                                           active_sh_degree=1)[0])
        images.append(out.rgb.cpu().numpy())
        depths.append(out.depth.cpu().numpy())
        plane_depths.append(plane.depth.cpu().numpy())
        lossy += [int(o.lossy_tiles) for o in (out, plane)
                  if o.lossy_tiles is not None]
        del out, plane
    return dict(cams=cams, images=np.stack(images), depths=np.stack(depths),
                plane_depths=np.stack(plane_depths), gt_lossy=lossy)


def intrinsics(cams) -> tuple:
    c = cams[0]
    return (float(c.fx), float(c.fy), float(c.cx), float(c.cy))


def synth_sensors(gt: dict, touch_patches: int, patch_radius: float,
                  dev: torch.device) -> dict:
    """The synthetic vision, grounded and touch sensors from one numpy
    stream (seed 3), as the JAX tool draws them: vision reads through the
    sphere with an affine miscalibration and noise; grounded is GT plus
    noise; touch contacts are the sphere's pixels within ``patch_radius``
    of random centers on it."""
    rng = np.random.default_rng(3)
    cvec = rng.normal(size=(touch_patches, 3))
    cvec /= np.linalg.norm(cvec, axis=1, keepdims=True)
    centers = cvec * 0.5
    intr = intrinsics(gt["cams"])
    H, W = gt["depths"].shape[1:]
    vision, grounded, sphere_masks, in_patches, contacts = [], [], [], [], []
    for v, cam in enumerate(gt["cams"]):
        gt_d = gt["depths"][v]
        pl_d = gt["plane_depths"][v]
        sph = (gt_d > 0) & (pl_d - gt_d > 1e-3)     # pixels on the sphere
        vis = np.where(sph, pl_d, gt_d)
        vis = vis / 0.97 - 0.02 + rng.normal(0, 0.01, gt_d.shape)
        vis = np.where(gt_d > 0, np.maximum(vis, 0.0), 0.0)
        with torch.no_grad():
            pts, _, _ = backproject_depth(
                torch.as_tensor(gt_d, device=dev),
                torch.as_tensor(gt["images"][v], device=dev), intr, cam.c2w)
        pts = pts.cpu().numpy().reshape(H, W, 3)
        d2 = ((pts[None, :, :, :] - centers[:, None, None, :]) ** 2).sum(-1)
        in_patch = (d2.min(axis=0) < patch_radius ** 2) & sph
        contacts.append(pts[in_patch])
        gnd = np.where(gt_d > 0, gt_d + rng.normal(0, 0.01, gt_d.shape), 0.0)
        vision.append(vis)
        grounded.append(gnd)
        sphere_masks.append(sph)
        in_patches.append(in_patch)
    return dict(vision=np.stack(vision), grounded=np.stack(grounded),
                sphere_masks=np.stack(sphere_masks),
                in_patches=np.stack(in_patches),
                contacts=np.concatenate(contacts))


def fit_touch_gpis(contacts: np.ndarray, patch_radius: float,
                   max_points: int, dev: torch.device, seed: int = 0) -> GPIS:
    """The GPIS on the contact points with their exact normals (the sphere
    is at the origin), lengthscale twice the patch radius, ε 0.05; above
    ``max_points`` contacts it keeps a draw seeded ``seed``."""
    return fit_gpis(
        contacts,
        normals=contacts / np.linalg.norm(contacts, axis=1, keepdims=True),
        lengthscale=2.0 * patch_radius, off_surface_eps=0.05,
        max_points=max_points, seed=seed, device=dev)


def march_range(depths: np.ndarray, sphere_masks: np.ndarray) -> tuple:
    sph_d = depths[sphere_masks]
    return float(sph_d.min()) - 0.15, float(sph_d.max()) + 0.15


def touch_maps(g: GPIS, cams, near: float, far: float
               ) -> tuple[np.ndarray, np.ndarray]:
    """Each view's GPIS depth and variance, marched at 96 samples with the
    tight support gate 0.15; no surface reads 0 and the variance is the
    touch σ the fusion weighs (at least 1e-4)."""
    touch, touch_sig = [], []
    for cam in cams:
        dep, var = render_depth_var(g, cam, near=near, far=far,
                                    n_samples=96, pixel_chunk=1024,
                                    support_var_frac=0.15)
        dep = np.nan_to_num(dep.cpu().numpy(), nan=0.0)
        var = np.nan_to_num(var.cpu().numpy(), nan=0.0)
        touch.append(np.where(dep > 0, dep, 0.0))
        touch_sig.append(np.where(dep > 0, np.maximum(var, 1e-4), 0.0))
    return np.stack(touch), np.stack(touch_sig)


def fuse_views(grounded, touch, vision, touch_sig, dev: torch.device,
               perms: Optional[list] = None, seed: int = 0) -> tuple:
    """``fuse_view`` per view; the 1% masks from ``perms`` (one LongTensor
    a view) or a generator on ``dev`` seeded ``seed``.  Returns numpy
    (fused depth, fused uncertainty, DS-GS depth) stacks."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    fused_d, fused_u, dsgs_d = [], [], []
    for v in range(len(vision)):
        def t(a):
            return torch.as_tensor(np.asarray(a[v], np.float32), device=dev)

        fv = fuse_view(gen, t(grounded), t(touch), t(vision), t(touch_sig),
                       use_uncertainty=True, is_real_world=True,
                       perm=None if perms is None else perms[v])
        fused_d.append(fv.fused_depth.cpu().numpy())
        fused_u.append(fv.fused_uncertainty.cpu().numpy())
        dsgs_d.append(fv.ds_gs_depth.cpu().numpy())
    return np.stack(fused_d), np.stack(fused_u), np.stack(dsgs_d)


def splits(views: int) -> tuple[np.ndarray, np.ndarray]:
    i_all = np.arange(views)
    return i_all[i_all % 4 != 3], i_all[i_all % 4 == 3]


def arm_seeds(dsgs_d, touch, images, intr, c2ws, i_train,
              dev: torch.device) -> dict:
    """Arm B's seeds backproject the aligned monodepth (right on the plane,
    through the object on the sphere), about SCENE_SEEDS of them; arm A's
    are the same plus TOUCH_SEED_PERCENT% of the touch pixels.  Views with
    fewer valid pixels than SCENE_SEEDS give all of them (the JAX tool asks
    for more than there are, and numpy raises)."""
    pt_b = min(100.0, 100.0 * SCENE_SEEDS
               / max((dsgs_d[i_train] > 0).sum(), 1))
    seeds_b, cols_b = seed_point_cloud(dsgs_d, images, intr, c2ws, i_train,
                                       percent_take=pt_b, seed=0,
                                       device=dev)
    touch_pts, touch_cols = seed_point_cloud(
        touch, images, intr, c2ws, i_train,
        percent_take=TOUCH_SEED_PERCENT, seed=0, device=dev)
    return dict(seeds_a=np.concatenate([seeds_b, touch_pts]),
                cols_a=np.concatenate([cols_b, touch_cols]),
                seeds_b=seeds_b, cols_b=cols_b, n_touch=len(touch_pts))


def arm_losses(unc_form: str) -> dict:
    """The mirror preset's depth losses: arm A 0.2 / UNCERT / 1.0, arm B
    0.2 / SIMPLE."""
    return {
        "touchgs": DepthLossConfig(
            0.2, DepthLossType.DEPTH_UNCERTAINTY_WEIGHTED_LOSS, 1.0,
            uncertainty_form=unc_form),
        "vision_only": DepthLossConfig(0.2, DepthLossType.SIMPLE_LOSS, 0.0),
    }


def arm_config(steps: int, capacity: int, sh_degree: int,
               depth: DepthLossConfig, use_pallas: bool) -> TrainConfig:
    """The JAX tool's schedule: refine from 300 to steps − 300, the
    periodic opacity reset at 3000, no capacity growth."""
    return TrainConfig(
        max_steps=steps,
        model=ModelConfig(max_gaussians=capacity, sh_degree=sh_degree,
                          rasterize=RasterizeConfig(use_pallas=use_pallas)),
        depth=depth,
        densify=DensifyConfig(warmup_steps=300, refine_every=100,
                              stop_refine_at=steps - 300,
                              reset_opacity_every=3000),
        optim=OptimConfig(means_lr_max_steps=steps),
        sh_degree_interval=max(steps // 3, 1),
        grow_capacity=False,
        log_every=250,
    )


def arm_scene(cameras: Cameras, images, depth_maps, unc_maps, seeds,
              seed_cols, i_train, i_eval, tag: str) -> Scene:
    return Scene(cameras=cameras, images=images, depths=depth_maps,
                 uncertainties=unc_maps, i_train=i_train, i_eval=i_eval,
                 seed_points=seeds, seed_colors=seed_cols / 255.0,
                 scale_factor=1.0, transform=np.eye(4)[:3],
                 name=f"hard_{tag}")


def evaluate_arm(params, cfg: TrainConfig, cameras: Cameras, images,
                 depths, sphere_masks, i_eval, sh_degree: int,
                 render_dir: Optional[Path], tag: str) -> dict:
    """Lossless eval renders: mean PSNR, depth MAE over valid GT depth and
    object depth MAE over the sphere's pixels."""
    dev = params.means.device
    psnrs, maes, obj_maes = [], [], []
    for i in i_eval:
        out = render_lossless(params, cameras.at(int(i), dev), cfg.model,
                              active_sh_degree=sh_degree)
        r = out.rgb.cpu().numpy()
        d = out.depth.cpu().numpy()
        if render_dir is not None:
            render_dir.mkdir(parents=True, exist_ok=True)
            write_png(render_dir / f"{tag}_eval_{i:02d}_pred_vs_gt.png",
                      (np.concatenate([r, images[i]], axis=1)
                       .clip(0, 1) * 255).astype(np.uint8))
        mse = float(((r - images[i]) ** 2).mean())
        psnrs.append(-10 * np.log10(max(mse, 1e-10)))
        m = depths[i] > 0
        maes.append(float(np.abs(d - depths[i])[m].mean()))
        om = sphere_masks[i]
        obj_maes.append(float(np.abs(d - depths[i])[om].mean()))
    return {"eval_psnr": float(np.mean(psnrs)),
            "depth_mae_cm": 100 * float(np.mean(maes)),
            "object_depth_mae_cm": 100 * float(np.mean(obj_maes))}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("train_hard_scene wants a CUDA device and "
                               "none is available; pass --device cpu for "
                               "the CPU")
        from touchgs_torch.utils.profiling import card

        device_name = card()
    else:
        device_name = "cpu"
    # fp32 for every matmul, solve and Cholesky on this path (ROADMAP C1);
    # the caller's TF32 flags come back on return
    with fp32():
        assert not (torch.backends.cuda.matmul.allow_tf32
                    or torch.backends.cudnn.allow_tf32)
        return run_ab(args, dev, device_name)


def run_ab(args: argparse.Namespace, dev: torch.device,
           device_name: str) -> dict:
    """Both arms from the GT renders on: ``main``'s work."""
    use_pallas = dev.type == "cuda"
    print(f"device: {device_name}", flush=True)
    stages: dict = {}

    def clock(name: str, t0: float, per: int = 1) -> None:
        _sync(dev)
        stages[name] = (time.perf_counter() - t0) / per

    W = H = args.size
    print("rendering GT + plane-only views...", flush=True)
    t0 = time.perf_counter()
    gt = render_gt(args.views, args.size, dev, use_pallas)
    clock("gt_render_s", t0)
    images, depths = gt["images"], gt["depths"]
    sensors = synth_sensors(gt, args.touch_patches, args.patch_radius, dev)
    sphere_masks = sensors["sphere_masks"]

    if args.no_gpis:
        # raw per-pixel touch depth inside the patches, constant σ
        touch = np.where(sensors["in_patches"], depths, 0.0)
        touch_sig = np.where(sensors["in_patches"], 0.05, 0.0)
    else:
        t0 = time.perf_counter()
        g = fit_touch_gpis(sensors["contacts"], args.patch_radius,
                           args.gpis_max_points, dev, args.gpis_seed)
        clock("gpis_fit_s", t0)
        t0 = time.perf_counter()
        touch, touch_sig = touch_maps(g, gt["cams"],
                                      *march_range(depths, sphere_masks))
        clock("march_s_per_view", t0, args.views)
        print(f"GPIS: {len(sensors['contacts'])} contacts -> "
              f"{min(len(sensors['contacts']), args.gpis_max_points)} pts, "
              f"{args.views} views marched in "
              f"{stages['march_s_per_view'] * args.views:.1f} s", flush=True)
    coverage = float((touch[sphere_masks] > 0).sum()
                     / max(sphere_masks.sum(), 1))
    print(f"touch coverage of sphere pixels: {coverage:.1%}", flush=True)

    print("fusing views (two-stage align + Bayesian fusion)...", flush=True)
    t0 = time.perf_counter()
    fused_d, fused_u, dsgs_d = fuse_views(
        sensors["grounded"], touch, sensors["vision"], touch_sig, dev,
        seed=args.seed)
    clock("fusion_s_per_view", t0, args.views)

    i_train, i_eval = splits(args.views)
    c2ws = np.stack([c.c2w.cpu().numpy() for c in gt["cams"]])
    intr = intrinsics(gt["cams"])
    t0 = time.perf_counter()
    seeds = arm_seeds(dsgs_d, touch, images, intr, c2ws, i_train, dev)
    clock("seeding_s", t0)
    print(f"seeds: vision={len(seeds['seeds_b'])} "
          f"+touch={seeds['n_touch']}", flush=True)

    cameras = Cameras(
        fx=np.array([intr[0]] * args.views, np.float32),
        fy=np.array([intr[1]] * args.views, np.float32),
        cx=np.array([intr[2]] * args.views, np.float32),
        cy=np.array([intr[3]] * args.views, np.float32),
        c2w=c2ws, width=W, height=H)
    losses = arm_losses(args.unc_form)
    render_dir = Path(args.render_dir) if args.render_dir else None

    def run(tag, depth_maps, unc_maps, seed_pts, seed_cols):
        scene = arm_scene(cameras, images, depth_maps, unc_maps, seed_pts,
                          seed_cols, i_train, i_eval, tag)
        cfg = dataclasses.replace(
            arm_config(args.steps, args.capacity, args.sh_degree,
                       losses[tag], use_pallas), seed=args.seed)
        tr = Trainer(scene, cfg, device=dev)
        t0 = time.perf_counter()
        tr.run(log_fn=lambda m: print(f"[{tag}] {m}", flush=True))
        _sync(dev)
        ips = args.steps / (time.perf_counter() - t0)
        row = {"tag": tag, "iters_per_sec": ips,
               "alive": int(tr.state.params.num_alive), "seeds": len(seed_pts),
               **evaluate_arm(tr.state.params, cfg, cameras, images, depths,
                              sphere_masks, i_eval, args.sh_degree,
                              render_dir, tag)}
        print(json.dumps(row), flush=True)
        return row

    a = run("touchgs", fused_d, fused_u, seeds["seeds_a"], seeds["cols_a"])
    b = None
    if not args.skip_baseline:
        b = run("vision_only", dsgs_d, np.zeros_like(fused_u),
                seeds["seeds_b"], seeds["cols_b"])
    for row in (a, b):
        if row is not None:
            stages[f"{row['tag']}_iters_per_sec"] = row["iters_per_sec"]

    summary = {
        "device": device_name, "steps": args.steps, "views": args.views,
        "resolution": f"{W}x{H}", "touch_patches": args.touch_patches,
        "sh_degree": args.sh_degree, "unc_form": args.unc_form,
        "seed": args.seed, "gpis_seed": args.gpis_seed,
        "capacity": args.capacity,
        "touch": "patch-only" if args.no_gpis else
                 f"GPIS ({args.gpis_max_points} pts)",
        "rasterizer": "tile kernels" if use_pallas else "scan path",
        "gt_lossy_tiles": gt["gt_lossy"],
        "contacts": int(len(sensors["contacts"])),
        "touch_coverage": coverage,
        "arms": {"touchgs": a, "vision_only": b},
        "stages": stages,
    }
    print(json.dumps(summary, indent=2), flush=True)

    md = Path(args.out)
    md.parent.mkdir(parents=True, exist_ok=True)
    rows = [(a, "Touch-GS (UNCERT 0.2/1.0)", "fused touch+vision",
             f"scene + touch ({len(seeds['seeds_a'])})")]
    if b is not None:
        rows.append((b, "vision-only (SIMPLE 0.2)", "aligned monodepth",
                     f"scene only ({len(seeds['seeds_b'])})"))
    table = "\n".join(
        f"| {name} | {sup} | {sd} | {r['eval_psnr']:.2f} dB | "
        f"{r['depth_mae_cm']:.2f} cm | {r['object_depth_mae_cm']:.2f} cm | "
        f"{r['alive']} | {r['iters_per_sec']:.2f} |"
        for r, name, sup, sd in rows)
    md.write_text(f"""# Hard scene (touch-dominant, vision-unreliable), PyTorch port

Textureless sphere on a textured checkered plane; vision depth reads
through the object; touch from {args.touch_patches} contact patches
({summary['touch']}) covers {coverage:.0%} of the sphere's pixels, fused by
`touch/fusion.py::fuse_view`.  {args.views} views at {W}x{H}, {args.steps}
steps, capacity {args.capacity}, sh_degree {args.sh_degree}, uncertainty
form {args.unc_form}, on {device_name} ({summary['rasterizer']}).

| config | depth supervision | seeds | eval PSNR | depth MAE | object depth MAE | alive | it/s |
|---|---|---|---|---|---|---|---|
{table}

Stage times (s): {json.dumps(stages)}
""")
    print(f"wrote {md}", flush=True)
    return summary


if __name__ == "__main__":
    main()
    sys.exit(0)
