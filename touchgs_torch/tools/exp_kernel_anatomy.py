"""Attribute the forward compositing kernel's (K2's) time to its pieces, on
the card (port of ``tools/exp_kernel_anatomy.py``).

K2 is stripped down and rebuilt piece by piece on the same tile data as the
flagship (800x800, 100k Gaussians in a capacity of 131072, SH degree 3,
camera at z = 2.5, colours |sh_dc|, k_chunk 128): the real kernel with and
without its early exit, then the K5 ablations ``full``, ``no_mxu``,
``alpha_only`` and ``noexp`` (``ops/anatomy.py``), which scan the full
lists.  Their differences split K2's time among exp2, the prefix product,
the R, G, B, D accumulation and the exit gate; ``alpha_only`` gives the
fp32 rate the card sustains on the α chain.  With ``--bf16`` the K6 probe
runs the α chain in f32 and in packed bf16.

    python -m touchgs_torch.tools.exp_kernel_anatomy [--bf16]

It needs a CUDA card and exits with status 1 without one.  Every time comes
from ``utils.profiling.measure`` (CUDA events).  The computing functions take
a ``device`` so that the tests drive them on the CPU at a small size.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from touchgs_torch.config import RasterizeConfig
from touchgs_torch.models.gaussians import init_random
from touchgs_torch.ops import anatomy, cuda_build
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.ops.projection import project_gaussians
from touchgs_torch.ops.tiles import bin_gaussians
from touchgs_torch.tools.pair_stats import bench_camera
from touchgs_torch.utils.profiling import card, measure

WIDTH = HEIGHT = 800
N_GAUSSIANS, CAPACITY = 100_000, 131_072
K_CHUNK = 128
PROBE_TILES = 625
ITERS = 20


@dataclasses.dataclass
class AnatomyInputs:
    at: torch.Tensor     # (n_tiles, k_tile, 16) gathered attribute rows
    nc: torch.Tensor     # (n_tiles,) int32 chunks of k_chunk per list
    tids: torch.Tensor   # (n_tiles,) int32 tile ids
    geom: tuple          # (th, tw, k_tile, k_chunk, n_tx, cfg)

    @property
    def full_entries(self) -> int:
        """Entries the no-exit kernels scan: whole chunks of each list."""
        k_tile, k_chunk = self.geom[2], self.geom[3]
        return int(torch.clamp(self.nc, max=k_tile // k_chunk).sum()) * k_chunk


def anatomy_inputs(device="cuda", width: int = WIDTH, height: int = HEIGHT,
                   n: int = N_GAUSSIANS,
                   capacity: int = CAPACITY) -> AnatomyInputs:
    """The flagship's tiles through the port's projection, binning and K1,
    as ``tools/exp_kernel_anatomy.py:39-71`` makes them."""
    rcfg = RasterizeConfig(use_pallas=True)
    params = init_random(n=n, capacity=capacity, sh_degree=3, device=device)
    cam = bench_camera(width, height, device)
    k_tile = rcfg.k_tile
    with torch.no_grad():
        opac = params.opacities()
        proj = project_gaussians(
            params.means, params.quats, params.scales(), cam.w2c, cam.fx,
            cam.fy, cam.cx, cam.cy, width, height, rcfg,
            extra_valid=params.alive, opacities=opac)
        bins = bin_gaussians(proj, width, height, rcfg)
        attrs = rc._pack_attrs(proj, params.sh_dc.abs(), opac)
        n_tiles = bins.n_tiles_x * bins.n_tiles_y
        capped = torch.clamp(bins.tile_counts, max=k_tile).contiguous()
        gidx = rc.slot_lists(bins.sorted_gauss, bins.tile_starts, capped,
                             n_tiles, k_tile, proj.means2d.shape[0])
        at = attrs[gidx].contiguous()
    nc = ((capped + K_CHUNK - 1) // K_CHUNK).to(torch.int32)
    tids = torch.arange(n_tiles, dtype=torch.int32, device=device)
    return AnatomyInputs(at=at, nc=nc, tids=tids,
                         geom=(rcfg.tile_h, rcfg.tile_w, k_tile, K_CHUNK,
                               bins.n_tiles_x, rcfg))


def forward(x: AnatomyInputs, early_exit: bool = True) -> torch.Tensor:
    """K2 on the anatomy's tiles."""
    return rc.forward_tiles(x.nc, x.tids, x.at, *x.geom, early_exit=early_exit)


def variant(x: AnatomyInputs, mode: str) -> torch.Tensor:
    """K5 ``mode`` on the anatomy's tiles."""
    return anatomy.variant(mode, x.nc, x.tids, x.at, *x.geom)


def probe_inputs(n_tiles: int = PROBE_TILES, device="cuda",
                 spread: bool = False) -> dict:
    """The probe's rows, ``default_rng(0).uniform(0.1, 1.0)``, in f32 and
    bf16 (as ``tools/exp_kernel_anatomy.py:182-186,215-216``).  With
    ``spread`` each row's centre lies on the pixels' line instead (mx ~
    U(0, 1024), my = mx / 2 + U(−1, 1)), so α > 0 reaches every part of
    the tile, not only its first pixels: a check of which pixel each
    thread sums."""
    rng = np.random.default_rng(0)
    at = rng.uniform(0.1, 1.0, (n_tiles, anatomy.PROBE_ROWS,
                                anatomy.PROBE_COLS))
    if spread:
        at[..., 0] = rng.uniform(0.0, anatomy.PROBE_NPIX, at.shape[:2])
        at[..., 1] = at[..., 0] / 2 + rng.uniform(-1.0, 1.0, at.shape[:2])
    at32 = torch.as_tensor(at.astype(np.float32), device=device)
    return {"f32": at32, "bf16": at32.to(torch.bfloat16)}


def scanned_entries(x: AnatomyInputs) -> int:
    """Entries K2 composites with its early exit (row 6 × k_chunk)."""
    done = forward(x)[:, plain.ROW_DONE, 0]
    return int(done.sum()) * x.geom[3]


def print_attribution(ms: dict, full_entries: int, npix: int) -> float:
    """Print how K2's no-exit time splits among its pieces, from the times
    (ms) of K2 with ("exit") and without ("noexit") its exit and of the
    four modes; returns the fp32 rate (op/s) that ``alpha_only`` sustains."""
    total = ms["noexit"]
    print(f"K2 without its exit, {total:.4f} ms, split by the ablations:")
    for piece, t in (
            ("α chain without exp2 (noexp)", ms["noexp"]),
            ("exp2 (alpha_only - noexp)", ms["alpha_only"] - ms["noexp"]),
            ("prefix product + weights (no_mxu - alpha_only)",
             ms["no_mxu"] - ms["alpha_only"]),
            ("R, G, B, D accumulation (full - no_mxu)",
             ms["full"] - ms["no_mxu"]),
            ("exit-gate max + 8-row store (K2 no exit - full)",
             ms["noexit"] - ms["full"])):
        print(f"  {t:8.4f} ms {100 * t / total:6.1f}%  {piece}")
    print(f"  early exit saves {ms['noexit'] - ms['exit']:.4f} ms "
          f"(K2 with its exit: {ms['exit']:.4f} ms)")
    rate = (anatomy.OPS_PER_PAIR["alpha_only"] * full_entries * npix
            / (ms["alpha_only"] * 1e-3))
    print(f"alpha_only sustains {rate / 1e12:.2f} T fp32 op/s "
          f"({anatomy.OPS_PER_PAIR['alpha_only']} op x {full_entries} "
          f"entries x {npix} px in {ms['alpha_only']:.4f} ms)")
    return rate


def run(x: AnatomyInputs, probe: dict | None = None) -> dict:
    """Print the JAX tool's lines with the card's times; returns the times
    in ms under "exit", "noexit", the four modes and "probe_<leg>"."""
    def timeit(fn, *args):
        return measure(fn, *args, iters=ITERS) * 1e3

    print(f"scanned {scanned_entries(x)} (early exit) vs full lists "
          f"{x.full_entries}")
    ms = {"exit": timeit(forward, x), "noexit": timeit(forward, x, False)}
    print(f"real forward (early exit):    {ms['exit']:7.4f} ms")
    print(f"real forward (no early exit): {ms['noexit']:7.4f} ms")
    for mode in anatomy.MODES:
        ms[mode] = timeit(variant, x, mode)
        print(f"variant {mode:11s}:          {ms[mode]:7.4f} ms  "
              f"(no early exit, scans full lists)")
    for leg, at in (probe or {}).items():
        ms[f'probe_{leg}'] = timeit(anatomy.bf16_probe, at)
        name = "float32" if leg == "f32" else "bfloat16"
        print(f"bf16probe {name:9s}: {ms[f'probe_{leg}']:7.4f} ms")
    return ms


def run_tool(argv: list) -> tuple:
    """What ``main`` does once a card is known to be there: the build and
    launch check, the flagship tiles, the lines, the attribution.  Returns
    the inputs, the probe inputs (or None) and the times."""
    out = cuda_build.compile_smoke()
    if not torch.equal(out, cuda_build.compile_smoke_plain(torch.ones_like(out))):
        raise RuntimeError("compile_smoke: the kernel's x·2 is wrong")
    print(card(), flush=True)
    x = anatomy_inputs()
    probe = probe_inputs() if "--bf16" in argv else None
    ms = run(x, probe)
    print_attribution(ms, x.full_entries, x.geom[0] * x.geom[1])
    return x, probe, ms


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("exp_kernel_anatomy: needs a CUDA device; nothing was timed",
              file=sys.stderr)
        return 1
    run_tool(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
