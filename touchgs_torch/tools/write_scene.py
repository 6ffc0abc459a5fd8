"""Write a synthetic scene directory in the Touch-GS layout, from seeds.

    python -m touchgs_torch.tools.write_scene OUT_DIR [--views 12]
        [--size 800] [--seeds 30000] [--device cpu]

The scale demo's GT (``train_scale_demo.build_gt_gaussians``: a textured
sphere on a checkered plane) rendered losslessly from ``ring_cameras`` on
the device (on CUDA through the tile kernels), then written as a user's
capture is laid out (SURVEY.md §2.10): ``imgs/frame_XXXXX.png`` (8-bit
RGB), uint16-millimetre depth and uncertainty PNGs named by
``depth_file_path`` and ``uncertainty_file_path`` in ``transforms.json``,
and the touch seeds ``points_touch.npy`` / ``points_colors.npy`` (colours
0-255).  Every PNG goes through ``data/png.py``.  The command line and the
CLI (``python -m touchgs_torch.cli train --data OUT_DIR``) then train on it
as on a capture.  On CUDA a GT render that overflows the lossless k_tile
8192 raises (below about 320x320 its tiles hold more splats than that);
the CPU's scan path reports no truncation and keeps each tile's
front-most 8192.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from touchgs_torch.config import ModelConfig
from touchgs_torch.data.png import write_png
from touchgs_torch.models.gaussians import GaussianParams
from touchgs_torch.models.splatfacto import render
from touchgs_torch.ops.sh import rgb_to_sh_dc
from touchgs_torch.tools.train_scale_demo import (assert_lossless,
                                                  build_gt_gaussians,
                                                  lossless_gt_raster,
                                                  ring_cameras)

UNC_FRACTION = 0.01      # the uncertainty PNGs: 1% of the depth, >= 1 mm


def write_scene(root: str | Path, views: int = 12, size: int = 800,
                seeds: int = 30_000, device: torch.device | str = "cuda",
                seed: int = 1) -> dict:
    """Render and write the scene under ``root``; returns what was written
    (``images`` uint8, ``depth_mm`` and ``unc_mm`` uint16 stacks, ``c2w``,
    the seeds) and ``bytes``, ``render_s`` and ``write_s``."""
    dev = torch.device(device)
    root = Path(root)
    for sub in ("imgs", "depth", "uncertainty"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    means, quats, scales, colors, opac = build_gt_gaussians()
    G = means.shape[0]

    def t(a):
        return torch.as_tensor(a, device=dev)

    gt = GaussianParams(
        means=t(means), quats=t(quats), log_scales=t(np.log(scales)),
        logit_opacities=t(np.log(opac / (1 - opac))),
        sh_dc=t(rgb_to_sh_dc(colors)), sh_rest=torch.zeros((G, 3, 3),
                                                           device=dev),
        alive=torch.ones((G,), dtype=torch.bool, device=dev))
    cfg = ModelConfig(max_gaussians=G, sh_degree=1,
                      rasterize=lossless_gt_raster(dev.type == "cuda"))
    cams = ring_cameras(views, size, size, device=dev)
    t0 = time.perf_counter()
    images, depth_mm = [], []
    for cam in cams:
        with torch.no_grad():
            out = assert_lossless(render(gt, cam, cfg, active_sh_degree=1)[0])
        rgb = out.rgb.clamp(0, 1).mul(255).round().to(torch.uint8)
        mm = out.depth.mul(1000).round().clamp(0, 65535).to(torch.int32)
        images.append(rgb.cpu().numpy())
        depth_mm.append(mm.cpu().numpy().astype(np.uint16))
        del out
    render_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    frames = []
    unc_mm = []
    for i, (img, mm, cam) in enumerate(zip(images, depth_mm, cams)):
        name = f"frame_{i:05d}.png"
        unc = np.where(mm > 0, np.maximum(np.rint(UNC_FRACTION * mm), 1),
                       0).astype(np.uint16)
        unc_mm.append(unc)
        write_png(root / "imgs" / name, img)
        write_png(root / "depth" / name, mm)
        write_png(root / "uncertainty" / name, unc)
        frames.append({
            "file_path": f"imgs/{name}",
            "depth_file_path": f"depth/{name}",
            "uncertainty_file_path": f"uncertainty/{name}",
            "transform_matrix": cam.c2w.cpu().numpy().astype(
                np.float64).tolist(),
        })
    c = cams[0]
    meta = {"fl_x": float(c.fx), "fl_y": float(c.fy), "cx": float(c.cx),
            "cy": float(c.cy), "w": size, "h": size, "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta, indent=2))
    rng = np.random.default_rng(seed)
    take = rng.choice(G, size=seeds, replace=False)
    points = (means[take] + rng.normal(0, 0.01, (seeds, 3))).astype(
        np.float32)
    colors_255 = (colors[take] * 255.0).astype(np.float32)
    np.save(root / "points_touch.npy", points)
    np.save(root / "points_colors.npy", colors_255)
    write_s = time.perf_counter() - t0
    nbytes = sum(p.stat().st_size for p in root.rglob("*") if p.is_file())
    return dict(images=np.stack(images), depth_mm=np.stack(depth_mm),
                unc_mm=np.stack(unc_mm),
                c2w=np.stack([cm.c2w.cpu().numpy() for cm in cams]),
                points=points, colors_255=colors_255, bytes=nbytes,
                render_s=render_s, write_s=write_s)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--seeds", type=int, default=30_000)
    ap.add_argument("--device", default="cuda",
                    help="where the GT renders (default: the GPU)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    info = write_scene(args.out_dir, args.views, args.size, args.seeds,
                       args.device)
    print(f"wrote {args.views} views at {args.size}x{args.size} and "
          f"{args.seeds} seeds to {args.out_dir}: {info['bytes']} bytes, "
          f"render {info['render_s']:.2f} s, write {info['write_s']:.2f} s")
    return info


if __name__ == "__main__":
    main()
