"""What the experiment tools under ``touchgs_torch/tools/exp_*.py`` share:
the bench scene's tile inputs, the ``--iters`` flag and the card check.
"""
from __future__ import annotations

import functools
import sys

import torch

from touchgs_torch.config import RasterizeConfig
from touchgs_torch.models.gaussians import init_random
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops.projection import project_gaussians
from touchgs_torch.ops.tiles import bin_gaussians
from touchgs_torch.tools.pair_stats import bench_camera

WIDTH = HEIGHT = 800
N_GAUSSIANS, CAPACITY = 100_000, 131_072
K_CHUNK = 128


@functools.lru_cache(maxsize=2)
def bench_params(device: str = "cuda", n: int = N_GAUSSIANS,
                 capacity: int = CAPACITY):
    """The bench's Gaussians, ``init_random(n, capacity, SH degree 3)``,
    made once a process: their nearest-neighbour scales take seconds on the
    host, and no tool writes into them."""
    return init_random(n=n, capacity=capacity, sh_degree=3, device=device)


def bench_tiles(device="cuda", rcfg: RasterizeConfig | None = None,
                k_chunk: int = K_CHUNK, width: int = WIDTH,
                height: int = HEIGHT, n: int = N_GAUSSIANS,
                capacity: int = CAPACITY, params=None) -> dict:
    """The bench scene's tile inputs under ``rcfg`` (default
    ``RasterizeConfig(use_pallas=True)``), as ``tools/exp_kernels.py:37-79``
    builds them: the projection's binning, the packed attribute table, K1's
    arguments, the lists and their rows, and the chunks a tile at
    ``k_chunk``."""
    rcfg = rcfg or RasterizeConfig(use_pallas=True)
    if params is None:
        params = bench_params(str(device), n, capacity)
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
        k1 = (bins.sorted_gauss, bins.tile_starts, capped, n_tiles, k_tile,
              proj.means2d.shape[0])
        gidx, at = rc.slot_rows(attrs, *k1)
    nc = ((capped + k_chunk - 1) // k_chunk).to(torch.int32)
    tids = torch.arange(n_tiles, dtype=torch.int32, device=attrs.device)
    return dict(bins=bins, attrs=attrs, k1=k1, gidx=gidx, at=at, nc=nc,
                tids=tids, n_tiles=n_tiles,
                geom=(rcfg.tile_h, rcfg.tile_w, k_tile, k_chunk,
                      bins.n_tiles_x, rcfg))


def iters_arg(argv: list, default: int) -> int:
    """``--iters N`` from ``argv``, else ``default``."""
    return int(argv[argv.index("--iters") + 1]) if "--iters" in argv \
        else default


def needs_card(name: str) -> bool:
    """False, with a message, where there is no CUDA card."""
    if torch.cuda.is_available():
        return True
    print(f"{name}: needs a CUDA device; nothing was timed", file=sys.stderr)
    return False
