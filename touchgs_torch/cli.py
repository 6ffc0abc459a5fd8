"""touchgs_torch command-line interface (port of ``touchgs_tpu/cli.py``).

Replaces the reference's bash-pipeline-of-scripts (SURVEY.md §2.1) with one
config-driven CLI.  Scene-preset hyperparameters reproduce the §2.1 matrix.

    python -m touchgs_torch.cli read-touch-depths --root DIR           # L4
    python -m touchgs_torch.cli gpis-render       --root DIR ...       # gpis/
    python -m touchgs_torch.cli fuse              --root_dir DIR ...   # L3
    python -m touchgs_torch.cli add-depth-paths   --root_dir DIR ...   # L2
    python -m touchgs_torch.cli seed              --root_dir DIR ...   # L2
    python -m touchgs_torch.cli train             --data DIR --preset bunny_real
    python -m touchgs_torch.cli eval              --data DIR --load-run DIR
    python -m touchgs_torch.cli render            --data DIR --load-run DIR
    python -m touchgs_torch.cli export-splat      --data DIR --load-run DIR
    python -m touchgs_torch.cli pipeline          --data DIR --preset mirror

Each subcommand's flags mirror the reference argparse surface where one exists
(e.g. ``fuse`` ≅ ``utils/fuse_touch_vision.py:391-428``, ``seed`` ≅
``utils/create_point_cloud_from_touches.py:201-244``).

Every subcommand that computes runs on the GPU unless ``--cpu`` is given;
without a GPU it raises (``read-touch-depths`` and ``add-depth-paths`` only
move files).  On the GPU ``train``, ``eval``, ``render`` and
``export-splat`` render through the tile kernels (``use_pallas=True``),
on the CPU through the scan path (ROADMAP.md C20); ``pipeline``'s
monocular-depth stage runs its net (``vision/monodepth.VisualPipeline``)
there too.  ``train --viewer`` serves the live browser viewer while it
trains, and ``viewer`` serves it on a trained run; on the GPU its frames
render through K1 and K2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch


def _device(args) -> torch.device:
    """The GPU, or the CPU when ``--cpu`` is given; never the CPU in place
    of a missing GPU."""
    if getattr(args, "cpu", False):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run "
                           "on the CPU")
    return torch.device("cuda")


# ---------------------------------------------------------------- L4 commands

def cmd_read_touch_depths(args):
    """GPIS npy outputs → uint16-mm touch_depth/ + touch_var/ PNGs
    (``utils/read_touch_depths.py`` equivalent)."""
    from touchgs_torch.data.depth_io import read_npy_depth, write_depth_mm

    root = Path(args.root)
    out_depth = root / "touch_depth"
    out_var = root / "touch_var"
    out_depth.mkdir(exist_ok=True)
    out_var.mkdir(exist_ok=True)
    imgs = sorted((root / "imgs").iterdir())
    for i, img in enumerate(imgs):
        num = img.stem
        d = read_npy_depth(root / "gpis_depth" / f"Image{i + 1}.npy")
        v = read_npy_depth(root / "gpis_var" / f"Image{i + 1}.npy")
        write_depth_mm(out_depth / f"{num}.png", d)
        write_depth_mm(out_var / f"{num}.png", v)
        print(f"wrote {out_depth}/{num}.png")


def cmd_read_realsense(args):
    """RealSense npy depth → remapped uint16-mm PNGs
    (``utils/read_realsense_depth.py:108-139`` equivalent)."""
    from touchgs_torch.data.realsense import process_realsense_dir

    n = process_realsense_dir(args.root, in_dir=args.in_dir,
                              out_dir=args.out_dir, device=_device(args))
    print(f"wrote {n} remapped depth maps → {args.root}/{args.out_dir}")


def cmd_gpis_render(args):
    """Fit a GPIS on a touch point cloud and render per-view gpis_depth/
    gpis_var npy maps (the gpis/ submodule's job, SURVEY.md §2.8)."""
    from touchgs_torch.data.scene import load_scene
    from touchgs_torch.touch.gpis import fit_gpis, render_depth_var

    dev = _device(args)
    root = Path(args.root)
    pts = np.load(args.points)
    normals = np.load(args.normals) if args.normals else None
    scene = load_scene(root, load_depth=False, load_uncertainty=False,
                       load_seed_points=False, auto_scale=False,
                       orientation_method="none", center_method="none")
    g = fit_gpis(pts, normals, lengthscale=args.lengthscale,
                 noise=args.noise, max_points=args.max_points, device=dev)
    (root / "gpis_depth").mkdir(exist_ok=True)
    (root / "gpis_var").mkdir(exist_ok=True)
    for i in range(scene.num_views):
        cam = scene.cameras.at(i, dev)
        depth, var = render_depth_var(g, cam, near=args.near, far=args.far,
                                      n_samples=args.samples)
        np.save(root / "gpis_depth" / f"Image{i + 1}.npy", depth.cpu().numpy())
        np.save(root / "gpis_var" / f"Image{i + 1}.npy", var.cpu().numpy())
        print(f"gpis view {i + 1}/{scene.num_views}")


# ---------------------------------------------------------------- L3 command

def cmd_fuse(args):
    """Per-view vision-touch fusion over a scene dir
    (``utils/fuse_touch_vision.py`` CLI contract).  Each view's 1% mask is
    drawn from one ``torch.Generator`` seeded with ``--seed`` (ROADMAP.md
    C13)."""
    from touchgs_torch.data.depth_io import read_depth_mm, write_depth_mm
    from touchgs_torch.data.png import resize_bilinear
    from touchgs_torch.touch import fusion

    dev = _device(args)
    root = Path(args.root_dir)
    grounded_dir = root / args.aligning_depths
    touch_dir = root / args.touch_depth
    var_dir = root / args.touch_var
    vision_dir = root / args.zoe_depth_path
    out_vision = root / args.vision_output_dir
    out_fused = root / args.fused_output_dir
    for d in (out_vision, Path(str(out_vision) + "_baseline"), out_fused,
              Path(str(out_fused) + "_uncertainty")):
        d.mkdir(exist_ok=True)

    grounded_files = sorted(grounded_dir.iterdir())
    touch_files = sorted(touch_dir.iterdir())
    vision_files = sorted(vision_dir.iterdir())
    generator = torch.Generator(device=dev)
    generator.manual_seed(args.seed)
    for idx, gfile in enumerate(grounded_files):
        img_number = touch_files[idx].stem
        grounded = read_depth_mm(gfile)
        touch = read_depth_mm(touch_files[idx])
        vision = read_depth_mm(vision_files[idx])
        tvar = read_depth_mm(var_dir / f"{img_number}.png")
        if not args.is_sim:
            grounded = resize_bilinear(grounded, vision.shape[1],
                                       vision.shape[0])
        out = fusion.fuse_view(
            generator, *(torch.as_tensor(a, device=dev)
                         for a in (grounded, touch, vision, tvar)),
            use_uncertainty=args.use_uncertainty,
            is_real_world=not args.is_sim,
        )
        write_depth_mm(out_vision / f"{img_number}.png",
                       out.vision_depth.cpu().numpy())
        write_depth_mm(Path(str(out_vision) + "_baseline") / f"{img_number}.png",
                       out.ds_gs_depth.cpu().numpy())
        write_depth_mm(out_fused / f"{img_number}.png",
                       out.fused_depth.cpu().numpy())
        write_depth_mm(
            Path(str(out_fused) + "_uncertainty") / f"{img_number}.png",
            out.fused_uncertainty.cpu().numpy())
        print(f"fused {img_number} ({idx + 1}/{len(grounded_files)})")


# ---------------------------------------------------------------- L2 commands

def cmd_add_depth_paths(args):
    """Add depth/uncertainty file paths to transforms.json
    (``utils/add_depth_file_path_to_transforms.py`` equivalent)."""
    root = Path(args.root_dir)
    tf_path = root / args.transforms
    meta = json.loads(tf_path.read_text())
    for frame in meta["frames"]:
        img_name = Path(frame["file_path"]).stem
        frame["depth_file_path"] = f"{args.fused_output_dir}/{img_name}.png"
        frame["uncertainty_file_path"] = (
            f"{args.fused_output_dir}_uncertainty/{img_name}.png"
        )
    tf_path.write_text(json.dumps(meta, indent=4))
    print(f"rewrote {tf_path} with depth/uncertainty paths")


def cmd_seed(args):
    """Touch point-cloud seeding
    (``utils/create_point_cloud_from_touches.py`` equivalent)."""
    from touchgs_torch.data.depth_io import read_depth_mm
    from touchgs_torch.data.png import read_rgb
    from touchgs_torch.data.splits import linspace_split
    from touchgs_torch.touch.pointcloud import (save_point_cloud,
                                                seed_point_cloud)

    dev = _device(args)
    root = Path(args.root_dir)
    meta = json.loads((root / args.transform_json_path).read_text())
    intr = [meta["fl_x"], meta["fl_y"], meta["cx"], meta["cy"]]
    img_files = sorted((root / args.image_dir).iterdir())
    depth_files = sorted((root / args.touch_depth_dir).iterdir())
    i_train, _ = linspace_split(len(img_files), args.train_split,
                                variant="seeding")
    c2w_by_stem = {
        Path(f["file_path"]).stem: np.array(f["transform_matrix"], np.float32)
        for f in meta["frames"]
    }
    depths, colors, c2ws = [], [], []
    for img_f, dep_f in zip(img_files, depth_files):
        depths.append(read_depth_mm(dep_f))
        colors.append(np.asarray(read_rgb(img_f), np.float32) / 255.0)
        c2ws.append(c2w_by_stem[img_f.stem])
    pts, cols = seed_point_cloud(
        np.stack(depths), np.stack(colors), intr, np.stack(c2ws),
        i_train, percent_take=args.percent_take, device=dev,
    )
    save_point_cloud(root, pts, cols)
    print(f"saved {len(pts)} seed points to {root}/points_touch.npy")


# ------------------------------------------------------------- train/eval

def _build_cfg(args, device: torch.device):
    """The preset's config with the flags' overrides; on CUDA the renders
    go through the tile kernels (ROADMAP.md C20)."""
    from touchgs_torch.config import (SCENE_PRESETS, DepthLossType,
                                      PoseOptConfig, TrainConfig,
                                      train_config_for_preset)

    if args.preset:
        preset = SCENE_PRESETS[args.preset]
        cfg = train_config_for_preset(preset)
        split = preset.train_split_fraction
    else:
        cfg = TrainConfig()
        split = 0.9
    if args.train_split_fraction is not None:
        split = args.train_split_fraction
    overrides = {}
    if args.max_steps is not None:
        overrides["max_steps"] = args.max_steps
    model = cfg.model
    if args.max_gaussians is not None:
        model = dataclasses.replace(model, max_gaussians=args.max_gaussians)
    if device.type == "cuda":
        model = dataclasses.replace(model, rasterize=dataclasses.replace(
            model.rasterize, use_pallas=True))
    if model != cfg.model:
        overrides["model"] = model
    depth_over = {}
    if args.depth_loss_mult is not None:
        depth_over["depth_loss_mult"] = args.depth_loss_mult
    if args.depth_loss_type is not None:
        depth_over["depth_loss_type"] = DepthLossType(args.depth_loss_type)
    if args.uncertainty_weight is not None:
        depth_over["uncertainty_weight"] = args.uncertainty_weight
    if depth_over:
        overrides["depth"] = dataclasses.replace(cfg.depth, **depth_over)
    if getattr(args, "camera_optimizer", None):
        # legacy/config_tactile.py:36-37 camera_optimizer mode="SO3xR3"
        overrides["pose_opt"] = PoseOptConfig(mode=args.camera_optimizer)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg, split


def cmd_train(args):
    """Train depth-gaussian-splatting on a scene (ns-train equivalent).
    Returns the trainer and its run directory."""
    from touchgs_torch.data.scene import load_scene
    from touchgs_torch.train.checkpoint import (CheckpointManager,
                                                make_run_dir, restore_trainer)
    from touchgs_torch.train.trainer import Trainer

    dev = _device(args)
    cfg, split = _build_cfg(args, dev)
    scene = load_scene(args.data, train_split_fraction=split,
                       downscale_factor=args.downscale_factor)
    print(f"scene {scene.name}: {scene.num_views} views "
          f"({len(scene.i_train)} train), depth={'yes' if scene.depths is not None else 'no'}, "
          f"seeds={'none' if scene.seed_points is None else len(scene.seed_points)}")
    trainer = Trainer(scene, cfg, device=dev)
    if args.load_run:  # resume (ns-train --load-dir equivalent)
        prev = CheckpointManager(Path(args.load_run))
        restore_trainer(trainer, prev)
        prev.close()
        print(f"resumed from {args.load_run} at step {trainer.state.step}")
    run_dir = make_run_dir(args.output_dir, scene.name)
    mgr = CheckpointManager(run_dir, cfg)
    print(f"run dir: {run_dir}")
    viewer = None
    if getattr(args, "viewer", False):
        from touchgs_torch.viewer import ViewerServer
        viewer = ViewerServer(trainer=trainer, port=args.viewer_port).start()
        print(f"live viewer at {viewer.url}")
    try:
        trainer.run(log_fn=lambda m: print(m), ckpt_manager=mgr,
                    viewer=viewer)
    finally:
        if viewer is not None:
            viewer.stop()
    mgr.close()
    print(f"training complete → {run_dir}")
    return trainer, run_dir


def _load_trained(args):
    from touchgs_torch.data.scene import load_scene
    from touchgs_torch.train.checkpoint import (CheckpointManager,
                                                latest_run_dir, restore_trainer)
    from touchgs_torch.train.trainer import Trainer

    dev = _device(args)
    cfg, split = _build_cfg(args, dev)
    scene = load_scene(args.data, train_split_fraction=split,
                       downscale_factor=args.downscale_factor)
    run_dir = (Path(args.load_run) if args.load_run
               else latest_run_dir(args.output_dir, scene.name))
    if run_dir is None:
        sys.exit("no run dir found; train first or pass --load-run")
    trainer = Trainer(scene, cfg, device=dev)
    mgr = CheckpointManager(run_dir)
    restore_trainer(trainer, mgr)
    mgr.close()
    return trainer, scene, cfg, run_dir


def _load_view_stack(directory, scene, is_mask=False):
    """Load a per-view stack (depth mm-PNG/npy or binary mask PNG) resized to
    the scene's image resolution, ordered like the scene's views (PIL's
    NEAREST sample positions, ``data/png.py``)."""
    from touchgs_torch.data.depth_io import read_depth_mm, read_npy_depth
    from touchgs_torch.data.png import read_gray, resize_nearest

    files = sorted(p for p in Path(directory).iterdir()
                   if p.suffix.lower() in (".png", ".npy"))
    if len(files) != scene.num_views:
        sys.exit(f"{directory}: {len(files)} files != {scene.num_views} views")
    H, W = scene.images.shape[1:3]
    stack = []
    for f in files:
        if is_mask:
            a = resize_nearest(read_gray(f), W, H) > 0
        else:
            a = read_npy_depth(f) if f.suffix == ".npy" else read_depth_mm(f)
            if a.shape != (H, W):
                a = resize_nearest(a, W, H)
        stack.append(a)
    return np.stack(stack)


def cmd_eval(args):
    """ns-eval equivalent: metrics JSON over the eval split.  Returns the
    results.

    ``--gt-depth-dir`` / ``--object-mask-dir`` add the fork's
    ``gt_depth_mse`` / ``gt_object_depth_mse`` metrics, gated on
    ``IS_REAL_WORLD`` semantics via ``--is-sim``
    (``experiment_utils/get_results.py:48-52``,
    ``scripts/train_bunny_real.sh:54``)."""
    from touchgs_torch.eval.runner import evaluate_scene, write_eval_json

    trainer, scene, cfg, run_dir = _load_trained(args)
    gt_depths = (_load_view_stack(args.gt_depth_dir, scene)
                 if getattr(args, "gt_depth_dir", None) else None)
    object_masks = (_load_view_stack(args.object_mask_dir, scene, is_mask=True)
                    if getattr(args, "object_mask_dir", None) else None)
    results = evaluate_scene(
        trainer.state.params, scene, cfg,
        gt_depths=gt_depths, object_masks=object_masks,
        is_real_world=not args.is_sim,
    )
    out = args.output_path or (run_dir / "eval.json")
    write_eval_json(results, out, experiment_name=scene.name)
    print(json.dumps(results, indent=2))
    print(f"wrote {out}")
    return results


def cmd_render(args):
    """ns-render dataset equivalent: render the eval split to PNGs."""
    from touchgs_torch.eval.runner import evaluate_scene

    trainer, scene, cfg, run_dir = _load_trained(args)
    render_dir = args.render_dir or (run_dir / "renders")
    evaluate_scene(trainer.state.params, scene, cfg, render_dir=render_dir)
    print(f"renders → {render_dir}")
    return Path(render_dir)


def cmd_export_splat(args):
    """ns-export gaussian-splat equivalent: trained run → standard 3DGS .ply.
    Returns the trainer and the file."""
    from touchgs_torch.data.ply import save_gaussians_ply

    trainer, scene, cfg, run_dir = _load_trained(args)
    out = Path(args.ply_path) if args.ply_path else (run_dir / "splat.ply")
    n = save_gaussians_ply(out, trainer.state.params)
    print(f"wrote {n} splats → {out}")
    return trainer, out


def cmd_viewer(args):
    """Serve the live browser viewer on a trained run (nerfstudio viewer
    equivalent) until interrupted.  Returns the stopped server."""
    import signal

    from touchgs_torch.viewer import ViewerServer

    trainer, scene, cfg, run_dir = _load_trained(args)
    srv = ViewerServer(trainer=trainer, port=args.port).start()
    st = trainer.state
    srv.update_status(int(st.step), float("nan"), int(st.params.num_alive),
                      training=False)
    print(f"viewer at {srv.url}  (run: {run_dir}; ctrl-c to stop)")
    try:
        signal.pause()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return srv


def cmd_pipeline(args):
    """Full scene pipeline (the scripts/train_*.sh equivalent, driven by the
    preset matrix): read-touch-depths → gpis-render (when raw touch points
    are given) → monocular depth → fuse → add-depth-paths → seed → train →
    eval, each stage skipped when its outputs already exist
    (``scripts/train_bunny_real.sh:1-57`` stage order).  Returns the eval
    results."""
    import argparse as _ap

    from touchgs_torch.config import SCENE_PRESETS

    root = Path(args.data)
    preset = SCENE_PRESETS[args.preset] if args.preset else None
    is_real = preset.is_real_world if preset else not args.is_sim
    split = (args.train_split_fraction
             if args.train_split_fraction is not None
             else (preset.train_split_fraction if preset else 0.9))
    percent_take = preset.percent_take if preset else 100.0
    cpu = getattr(args, "cpu", False)
    print(f"[pipeline] preset={args.preset} data={root} real={is_real}")

    # 1. GPIS render (gpis/ submodule stage) when raw touch points are given
    if args.touch_points and not (root / "gpis_depth").exists():
        print("[pipeline] gpis-render")
        cmd_gpis_render(_ap.Namespace(
            root=str(root), points=args.touch_points, normals=None,
            lengthscale=0.05, noise=1e-3, near=0.05, far=2.0, samples=128,
            max_points=2048, cpu=cpu))

    # 2. GPIS npy → touch_depth/touch_var PNGs (read_touch_depths.py)
    if (root / "gpis_depth").exists() and not (root / "touch_depth").exists():
        print("[pipeline] read-touch-depths")
        cmd_read_touch_depths(_ap.Namespace(root=str(root)))

    # 2b. RealSense npy → remapped PNGs (read_realsense_depth.py)
    if (root / "realsense_depth").exists() and not (
            root / "realsense_depths").exists():
        print("[pipeline] read-realsense")
        cmd_read_realsense(_ap.Namespace(
            root=str(root), in_dir="realsense_depth",
            out_dir="realsense_depths", cpu=cpu))

    # 3. monocular depth (run_zoe_depth.py), skipped if the dir exists
    zoe_dir = root / args.zoe_dir
    if not zoe_dir.exists():
        print(f"[pipeline] monodepth → {zoe_dir}")
        from touchgs_torch.vision.monodepth import VisualPipeline

        VisualPipeline(model_type="zoe", weights_path=args.zoe_weights,
                       device=_device(args)).predict(root / "imgs", zoe_dir)

    # 4. fusion (fuse_touch_vision.py; scripts pass --use_uncertainty always)
    fused_dir = root / "fused_output_dir"
    if not fused_dir.exists() and (root / "touch_depth").exists():
        aligning = "realsense_depths" if is_real else "sparse_depths"
        print(f"[pipeline] fuse (aligning={aligning})")
        cmd_fuse(_ap.Namespace(
            root_dir=str(root), aligning_depths=aligning,
            zoe_depth_path=args.zoe_dir, touch_depth="touch_depth",
            touch_var="touch_var", vision_output_dir="vision",
            fused_output_dir="fused_output_dir", use_uncertainty=True,
            is_sim=not is_real, seed=0, cpu=cpu))

    # 5. transforms.json depth/uncertainty paths
    if fused_dir.exists():
        meta = json.loads((root / "transforms.json").read_text())
        if "depth_file_path" not in meta["frames"][0]:
            print("[pipeline] add-depth-paths")
            cmd_add_depth_paths(_ap.Namespace(
                root_dir=str(root), transforms="transforms.json",
                fused_output_dir="fused_output_dir"))

    # 6. touch point-cloud seeding (create_point_cloud_from_touches.py)
    if (root / "touch_depth").exists() and not (root / "points_touch.npy").exists():
        print(f"[pipeline] seed (split={split}, percent_take={percent_take})")
        cmd_seed(_ap.Namespace(
            root_dir=str(root), image_dir="imgs",
            touch_depth_dir="touch_depth", touch_var_dir="touch_var",
            transform_json_path="transforms.json", train_split=split,
            percent_take=percent_take, cpu=cpu))

    # 7./8. train + eval (ns-train / run_eval.py)
    cmd_train(args)
    args.load_run = None
    return cmd_eval(args)


def _add_train_flags(p):
    p.add_argument("--data", required=True)
    p.add_argument("--preset", choices=["bunny_real", "bunny_blender",
                                        "mirror", "block"], default=None)
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--max-gaussians", type=int, default=None,
                   help="fixed Gaussian capacity (power of two recommended)")
    p.add_argument("--downscale-factor", type=int, default=1)
    p.add_argument("--train-split-fraction", type=float, default=None)
    p.add_argument("--depth-loss-mult", type=float, default=None)
    p.add_argument("--depth-loss-type", default=None,
                   choices=["SIMPLE_LOSS", "DEPTH_UNCERTAINTY_WEIGHTED_LOSS"])
    p.add_argument("--uncertainty-weight", type=float, default=None)
    p.add_argument("--is-sim", action="store_true")
    p.add_argument("--camera-optimizer", default=None,
                   choices=["off", "SO3xR3"],
                   help="per-camera SO3xR3 pose optimization "
                        "(legacy/config_tactile.py:36-37)")
    p.add_argument("--load-run", default=None)
    p.add_argument("--output-path", default=None)
    p.add_argument("--render-dir", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the GPU)")
    p.add_argument("--viewer", action="store_true",
                   help="serve the live browser viewer while training")
    p.add_argument("--viewer-port", type=int, default=7007)


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns what it returns."""
    parser = argparse.ArgumentParser(prog="touchgs_torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("read-touch-depths")
    p.add_argument("--root", required=True)
    p.set_defaults(fn=cmd_read_touch_depths)

    p = sub.add_parser("read-realsense")
    p.add_argument("--root", required=True)
    p.add_argument("--in_dir", default="realsense_depth")
    p.add_argument("--out_dir", default="realsense_depths")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(fn=cmd_read_realsense)

    p = sub.add_parser("gpis-render")
    p.add_argument("--root", required=True)
    p.add_argument("--points", required=True)
    p.add_argument("--normals", default=None)
    p.add_argument("--lengthscale", type=float, default=0.05)
    p.add_argument("--noise", type=float, default=1e-3)
    p.add_argument("--near", type=float, default=0.05)
    p.add_argument("--far", type=float, default=2.0)
    p.add_argument("--samples", type=int, default=128)
    p.add_argument("--max-points", type=int, default=2048)
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(fn=cmd_gpis_render)

    p = sub.add_parser("fuse")
    p.add_argument("--root_dir", required=True)
    p.add_argument("--aligning_depths", required=True)
    p.add_argument("--zoe_depth_path", required=True)
    p.add_argument("--touch_depth", required=True)
    p.add_argument("--touch_var", required=True)
    p.add_argument("--vision_output_dir", required=True)
    p.add_argument("--fused_output_dir", required=True)
    p.add_argument("--use_uncertainty", action="store_true")
    p.add_argument("--is_sim", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(fn=cmd_fuse)

    p = sub.add_parser("add-depth-paths")
    p.add_argument("--root_dir", required=True)
    p.add_argument("--transforms", default="transforms.json")
    p.add_argument("--fused_output_dir", required=True)
    p.set_defaults(fn=cmd_add_depth_paths)

    p = sub.add_parser("seed")
    p.add_argument("--root_dir", required=True)
    p.add_argument("--image_dir", default="imgs")
    p.add_argument("--touch_depth_dir", default="touch_depth")
    p.add_argument("--touch_var_dir", default="touch_var")
    p.add_argument("--transform_json_path", default="transforms.json")
    p.add_argument("--train_split", type=float, required=True)
    p.add_argument("--percent_take", type=float, default=100.0)
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(fn=cmd_seed)

    for name, fn in (("train", cmd_train), ("eval", cmd_eval),
                     ("render", cmd_render), ("pipeline", cmd_pipeline),
                     ("export-splat", cmd_export_splat),
                     ("viewer", cmd_viewer)):
        p = sub.add_parser(name)
        _add_train_flags(p)
        if name == "export-splat":
            p.add_argument("--ply-path", default=None,
                           help="output .ply (default <run>/splat.ply)")
        if name == "viewer":
            p.add_argument("--port", type=int, default=7007)
        if name in ("eval", "pipeline"):
            p.add_argument("--gt-depth-dir", default=None,
                           help="ground-truth depth dir → gt_depth_mse")
            p.add_argument("--object-mask-dir", default=None,
                           help="object mask dir → gt_object_depth_mse")
        if name == "pipeline":
            p.add_argument("--touch-points", default=None,
                           help="raw touch point cloud npy for gpis-render")
            p.add_argument("--zoe-dir", default="zoe_depth",
                           help="monocular-depth output dir name")
            p.add_argument("--zoe-weights", default=None,
                           help="monocular-depth weights: a ported "
                                "checkpoint npz or the compact trunk's")
        p.set_defaults(fn=fn)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
