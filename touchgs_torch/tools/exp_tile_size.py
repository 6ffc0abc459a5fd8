"""Tile-size sweep of the kernel rasterizer on the card (port of
``tools/exp_tile_size.py``).

Bigger tiles cut the overscan of each Gaussian (a splat of radius r on an
s x s tile costs about (2r + s)² pixel evaluations a covered tile) and the
pairs to sort, at the price of a coarser early exit and larger per-tile
caps.  The 32x32 default was chosen on the JAX package's accelerator
(``BASELINE.md:55-61``); this sweep asks the question of the H100.

The scene is the bench's (800x800, 100k Gaussians from ``init_random`` in a
capacity of 131072, SH degree 3, ``pair_stats.bench_camera``, colours
|sh_dc|), through ``rasterize_cuda`` (K1 with rows, K2, K3; k_chunk 64).
For each of the JAX tool's five ``(th, tw, k_tile, max_tiles_per_gaussian)``
rows it prints the forward's ms (projection, binning, K1 and K2), the
forward plus backward's ms (the gradient with respect to the means of
Σrgb + Σdepth) and ``maxdiff_vs_32x32``, the largest rgb difference from
the first row's image, with the share of pixels that differ by more than
1e-3 and the render's lossy tiles; then the row's pairs, those its k_tile
keeps, and K2 and K3 held against their plain versions on that row's
tiles: K2's T row and ``chunks_done`` equal and its rgb and acc
within 3e-5 (depth 3e-4), K3 equal (``torch.equal``) on a seeded random
cotangent, and K2's and K3's ms a call on those tiles.

    python -m touchgs_torch.tools.exp_tile_size [--iters N]

It needs a CUDA card and exits with status 1 without one, or when a hold
fails.  Every time comes from ``utils.profiling.measure`` (CUDA events); a
row that raises prints ``FAILED`` with its reason.  The computing functions
take a ``device`` so that the tests drive them on the CPU at a small size.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

from touchgs_torch.config import RasterizeConfig
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.ops.projection import project_gaussians
from touchgs_torch.tools.exp_common import (CAPACITY, HEIGHT, N_GAUSSIANS,
                                            WIDTH, bench_params, bench_tiles,
                                            iters_arg, needs_card)
from touchgs_torch.tools.pair_stats import bench_camera
from touchgs_torch.utils.profiling import card, measure

ITERS = 15
K_CHUNK = 64  # rasterize_cuda's default, as rasterize_pallas's
# (tile_h, tile_w, k_tile, max_tiles_per_gaussian), tools/exp_tile_size.py:56-58
GEOMETRIES = ((32, 32, 512, 16), (32, 64, 1024, 12), (64, 64, 2048, 8),
              (64, 64, 1024, 8), (16, 32, 256, 24))
# a tile whose pixel count is not a multiple of 32 (held on the card by
# tests/test_torch_cuda.py::test_group_kernels_match_plain's 12x12 case)
ODD_GEOMETRY = (12, 12, 256, 24)


def config(th: int, tw: int, k_tile: int, tcap: int) -> RasterizeConfig:
    return dataclasses.replace(RasterizeConfig(use_pallas=True), tile_h=th,
                               tile_w=tw, k_tile=k_tile,
                               max_tiles_per_gaussian=tcap)


@dataclasses.dataclass
class Scene:
    params: object       # GaussianParams
    cam: object          # Camera
    width: int
    height: int

    @classmethod
    def bench(cls, device="cuda", width: int = WIDTH, height: int = HEIGHT,
              n: int = N_GAUSSIANS, capacity: int = CAPACITY) -> "Scene":
        return cls(bench_params(str(device), n, capacity),
                   bench_camera(width, height, device), width, height)

    def render(self, means, cfg: RasterizeConfig):
        p, cam = self.params, self.cam
        opac = p.opacities()
        proj = project_gaussians(means, p.quats, p.scales(), cam.w2c, cam.fx,
                                 cam.fy, cam.cx, cam.cy, self.width,
                                 self.height, cfg, extra_valid=p.alive,
                                 opacities=opac)
        return rc.rasterize_cuda(proj, p.sh_dc.abs(), opac, self.width,
                                 self.height, cfg, k_chunk=K_CHUNK)

    def fwd(self, means, cfg: RasterizeConfig) -> torch.Tensor:
        with torch.no_grad():
            return self.render(means, cfg).rgb

    def fwd_bwd(self, means, cfg: RasterizeConfig) -> torch.Tensor:
        means = means.detach().requires_grad_(True)
        out = self.render(means, cfg)
        return torch.autograd.grad(out.rgb.sum() + out.depth.sum(), means)[0]


def hold(scene: Scene, cfg: RasterizeConfig, iters: int = 0) -> dict:
    """K2 and K3 against their plain versions on the scene's tiles under
    ``cfg`` at k_chunk 64: K2's largest rgb/acc and depth errors and whether
    its T row and chunks_done are equal; K3's largest error on a seeded
    random cotangent and whether it is equal; ``ok`` when all hold.  With
    ``iters`` (on the card) also K2's and K3's ms a call on those tiles."""
    x = bench_tiles(scene.params.means.device, cfg, K_CHUNK, scene.width,
                    scene.height, params=scene.params)
    args = (x["nc"], x["tids"], x["at"], *x["geom"])
    fwd, fwd_p = rc.forward_tiles(*args), plain.forward_tiles_plain(*args)
    rgba = [0, 1, 2, 4]
    done = fwd[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
    gen = torch.Generator(device=fwd.device).manual_seed(0)
    g = torch.randn(fwd.shape, generator=gen, device=fwd.device)
    bargs = (done, x["tids"], x["at"], fwd, g, *x["geom"])
    d, d_p = rc.backward_tiles(*bargs), plain.backward_tiles_plain(*bargs)
    h = dict(
        k2_rgba=float((fwd[:, rgba] - fwd_p[:, rgba]).abs().max()),
        k2_depth=float((fwd[:, 3] - fwd_p[:, 3]).abs().max()),
        k2_t_done_equal=bool(
            torch.equal(fwd[:, plain.ROW_T], fwd_p[:, plain.ROW_T])
            and torch.equal(fwd[:, plain.ROW_DONE], fwd_p[:, plain.ROW_DONE])),
        k3=float((d - d_p).abs().max()), k3_equal=bool(torch.equal(d, d_p)),
        scanned=int(done.sum()) * K_CHUNK, n_tiles=x["n_tiles"],
        pairs=int(x["bins"].tile_counts.sum()), kept=int(x["k1"][2].sum()))
    h["ok"] = (h["k2_t_done_equal"] and h["k3_equal"]
               and h["k2_rgba"] <= 3e-5 and h["k2_depth"] <= 3e-4)
    if iters:
        h["k2_ms"] = measure(rc.forward_tiles, *args, iters=iters) * 1e3
        h["k3_ms"] = measure(rc.backward_tiles, *bargs, iters=iters) * 1e3
    return h


def print_hold(h: dict) -> None:
    print(f"  {h['n_tiles']} tiles, {h['pairs']} pairs, {h['kept']} kept "
          f"({100 * h['kept'] / max(h['pairs'], 1):.1f}%), {h['scanned']} "
          f"scanned entries; K2 vs "
          f"plain: rgb/acc {h['k2_rgba']:.3e}, depth {h['k2_depth']:.3e}, "
          f"T and chunks_done equal {h['k2_t_done_equal']}; K3 vs plain: "
          f"max abs {h['k3']:.3e}, equal {h['k3_equal']}"
          + ("" if h["ok"] else "  HOLD FAILED")
          + (f"; K2 {h['k2_ms']:.4f} ms, K3 {h['k3_ms']:.4f} ms a call"
             if "k2_ms" in h else ""), flush=True)


def sweep(scene: Scene, iters: int = ITERS, geometries=GEOMETRIES) -> dict:
    """The JAX tool's rows with the card's times and the holds; returns
    {(th, tw, k_tile, tcap): dict(fwd_ms, fwd_bwd_ms, maxdiff,
    share_over_1e3, lossy, hold) or dict(failed=reason)}."""
    out, ref_rgb = {}, None
    means = scene.params.means
    for geo in geometries:
        th, tw, k_tile, tcap = geo
        cfg = config(*geo)
        label = f"tile {th}x{tw} k={k_tile} tcap={tcap}:"
        try:
            t_f = measure(scene.fwd, means, cfg, iters=iters) * 1e3
            t_fb = measure(scene.fwd_bwd, means, cfg, iters=iters) * 1e3
            with torch.no_grad():
                r = scene.render(means, cfg)
            note, diff, over = "", None, None
            if ref_rgb is None:
                ref_rgb = r.rgb
            else:
                d = (r.rgb - ref_rgb).abs().amax(dim=-1)
                diff, over = float(d.max()), float((d > 1e-3).float().mean())
                note = (f" maxdiff_vs_32x32={diff:.2e} (pixels over 1e-3: "
                        f"{100 * over:.2f}%)")
            print(f"{label} fwd {t_f:7.3f} ms   fwd+bwd {t_fb:7.3f} ms{note}; "
                  f"lossy tiles {int(r.lossy_tiles)}", flush=True)
            h = hold(scene, cfg, iters)
            print_hold(h)
            out[geo] = dict(fwd_ms=t_f, fwd_bwd_ms=t_fb, maxdiff=diff,
                            share_over_1e3=over, lossy=int(r.lossy_tiles),
                            hold=h)
        except Exception as e:  # a failing row is a finding: print it, go on
            reason = f"{type(e).__name__}: {str(e)[:150]}"
            print(f"{label} FAILED {reason}", flush=True)
            out[geo] = dict(failed=reason)
    return out


def main(argv=None, out: dict | None = None) -> int:
    """Exit status 1 without a card or when a row's hold fails; ``out``
    receives the rows."""
    argv = sys.argv[1:] if argv is None else argv
    if not needs_card("exp_tile_size"):
        return 1
    print(card(), flush=True)
    rows = sweep(Scene.bench(), iters_arg(argv, ITERS))
    if out is not None:
        out["rows"] = rows
    return 0 if all(r.get("hold", {}).get("ok") for r in rows.values()) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
