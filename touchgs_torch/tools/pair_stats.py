"""Tile-list statistics of the bench scene (port of ``tools/pair_stats.py``):
entries per tile, their mean, maximum and percentiles, and the pairs kept
and dropped at a per-tile cap.

The scene is the bench's: 100k Gaussians from ``init_random`` in a capacity
of 131072, SH degree 3, seen at 800x800 from z = 2.5 with fx = fy = 0.9·W.
Only projection and binning run, so no kernel is on this path.

    python -m touchgs_torch.tools.pair_stats [k_tile] [--cpu]

It runs on the card unless given ``--cpu`` (``device="cpu"``), and raises
without one.  ``main`` returns the printed numbers, and the per-tile counts
and radii, as a dict.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from touchgs_torch.config import RasterizeConfig
from touchgs_torch.data.cameras import Camera
from touchgs_torch.models.gaussians import init_random
from touchgs_torch.ops.projection import project_gaussians
from touchgs_torch.ops.tiles import bin_gaussians

WIDTH = HEIGHT = 800
N_GAUSSIANS, CAPACITY = 100_000, 131_072
SCAN_CHUNK = 128  # the chunk of the scanned-entries estimate, as the JAX tool


def bench_camera(width: int, height: int, device) -> Camera:
    """The bench's camera (``bench.py:151-158``): fx = fy = 0.9·width, the
    principal point at the centre, at z = 2.5 looking down −z."""
    def f32(v):
        return torch.tensor(np.float32(v), device=device)

    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.5
    return Camera(fx=f32(0.9 * width), fy=f32(0.9 * width),
                  cx=f32(width / 2), cy=f32(height / 2),
                  c2w=torch.as_tensor(c2w, device=device), width=width,
                  height=height)


def main(k_tile: int = 1024, device="cuda", width: int = WIDTH,
         height: int = HEIGHT, n: int = N_GAUSSIANS,
         capacity: int = CAPACITY) -> dict:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pair_stats runs on a CUDA device and none is "
                           "available; pass device='cpu' (--cpu) for the CPU")
    rcfg = RasterizeConfig()
    params = init_random(n=n, capacity=capacity, sh_degree=3, device=device)
    cam = bench_camera(width, height, device)
    with torch.no_grad():
        proj = project_gaussians(
            params.means, params.quats, params.scales(), cam.w2c, cam.fx,
            cam.fy, cam.cx, cam.cy, width, height, rcfg,
            extra_valid=params.alive, opacities=params.opacities())
        bins = bin_gaussians(proj, width, height, rcfg)
    counts = bins.tile_counts.cpu().numpy().astype(np.int64)
    radii = proj.radii.cpu().numpy()
    cull_radii = proj.cull_radii.cpu().numpy()
    valid = proj.valid.cpu().numpy()
    total = int(counts.sum())
    kept = int(np.minimum(counts, k_tile).sum())
    pcts = np.percentile(counts, [50, 90, 99])
    print(f"tiles: {counts.size}  total pairs: {total}  "
          f"mean/tile: {counts.mean():.1f}  max/tile: {counts.max()}")
    print(f"p50/p90/p99 per tile: {pcts}")
    print(f"cap {k_tile}: kept {kept} ({100 * kept / max(total, 1):.2f}%)  "
          f"dropped {total - kept}")
    print(f"valid gaussians: {valid.sum()}  mean radius: "
          f"{radii[valid].mean():.2f}px  mean cull radius: "
          f"{cull_radii[valid].mean():.2f}px")
    # the JAX tool's estimate of the entries a chunked scan reads: one
    # chunk more a tile for the 128-alignment remainder of its start
    kc = SCAN_CHUNK
    scanned = int((((np.minimum(counts, k_tile) + kc - 1) // kc + 1)
                   * kc).sum())
    print(f"scanned entries (incl. rem+pad, approx): {scanned}  "
          f"waste vs real: {scanned / max(kept, 1):.2f}x")
    return dict(k_tile=k_tile, tiles=int(counts.size), total=total,
                mean=float(counts.mean()), max=int(counts.max()),
                p50=float(pcts[0]), p90=float(pcts[1]), p99=float(pcts[2]),
                kept=kept, dropped=total - kept, valid=int(valid.sum()),
                mean_radius=float(radii[valid].mean()),
                mean_cull_radius=float(cull_radii[valid].mean()),
                scanned_approx=scanned, tile_counts=counts, radii=radii,
                cull_radii=cull_radii)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    main(int(args[0]) if args else 1024,
         device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
