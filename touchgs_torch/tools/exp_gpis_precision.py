"""The hard scene with the GPIS mean's matvec at a TPU's default matmul
precision (ROADMAP C17's candidate).

On a TPU, XLA runs an fp32 matmul at its default precision in one pass of
bf16 inputs with fp32 products and sums.  The JAX tool's march
(``touchgs_tpu/touch/gpis.py``: the ``k @ alpha`` of ``posterior_mean``
along each ray and of ``posterior`` at the crossing) ran so for
``RESULTS_hard_scene.md``, where the port runs fp32.  Here both products
take their inputs rounded to bf16 (a product of two bf16 values is exact
in fp32, so this is the TPU's pass up to the order of the sums); the
Cholesky and the triangular solves stay fp32.  The tool then:

1. marches every view's touch maps in fp32 and in bf16 and prints, for
   each, the share of the sphere's pixels covered, the touch depth's MAE
   against the GT depth there, the touch pixels off the sphere, and the
   pixels whose validity or depth differ between the two;
2. unless ``--maps-only``, runs ``train_hard_scene.main`` with the matvec
   at bf16 (the fp32 run is ``train_hard_scene`` itself), and prints both
   arms' rows.

Everything after ``--`` goes to ``train_hard_scene``:

    python -m touchgs_torch.tools.exp_gpis_precision -- \\
        --views 24 --touch-patches 60 --steps 6000 --sh-degree 0
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from touchgs_torch.eval.lpips_vgg import fp32
from touchgs_torch.tools import train_hard_scene as ths
from touchgs_torch.touch import gpis


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _posterior_mean_bf16(g: gpis.GPIS, queries: torch.Tensor
                         ) -> torch.Tensor:
    k = gpis._KERNELS[g.kernel](gpis._sq_dist(queries, g.X), g.lengthscale,
                                g.signal_var)
    return _bf16(k) @ _bf16(g.alpha)


def _posterior_bf16(g: gpis.GPIS, queries: torch.Tensor) -> tuple:
    k = gpis._KERNELS[g.kernel](gpis._sq_dist(queries, g.X), g.lengthscale,
                                g.signal_var)
    mean = _bf16(k) @ _bf16(g.alpha)
    v = torch.linalg.solve_triangular(g.L, k.T, upper=False)
    var = g.signal_var - torch.sum(v * v, dim=0)
    return mean, torch.clamp(var, min=0.0)


@contextlib.contextmanager
def matvec(mode: str):
    """``gpis``'s two ``k @ alpha`` products at ``mode`` ("fp32" leaves
    them as they are, "bf16" rounds their inputs) inside the block."""
    saved = (gpis.posterior_mean, gpis.posterior)
    if mode == "bf16":
        gpis.posterior_mean, gpis.posterior = (_posterior_mean_bf16,
                                               _posterior_bf16)
    try:
        yield
    finally:
        gpis.posterior_mean, gpis.posterior = saved


def touch_map_check(hs: argparse.Namespace, dev: torch.device) -> dict:
    """Every view's touch maps, marched at fp32 and at bf16, against the
    GT depth on the sphere's pixels."""
    gt = ths.render_gt(hs.views, hs.size, dev, dev.type == "cuda")
    sensors = ths.synth_sensors(gt, hs.touch_patches, hs.patch_radius, dev)
    g = ths.fit_touch_gpis(sensors["contacts"], hs.patch_radius,
                           hs.gpis_max_points, dev, hs.gpis_seed)
    sph, depths = sensors["sphere_masks"], gt["depths"]
    near_far = ths.march_range(depths, sph)
    maps, rows = {}, {}
    for mode in ("fp32", "bf16"):
        with matvec(mode):
            touch, _ = ths.touch_maps(g, gt["cams"], *near_far)
        on = (touch > 0) & sph
        maps[mode] = touch
        rows[mode] = dict(
            coverage=float(on.sum() / max(sph.sum(), 1)),
            mae_cm=100 * float(np.abs(touch - depths)[on].mean()),
            off_sphere=int(((touch > 0) & ~sph).sum()))
    a, b = maps["fp32"] > 0, maps["bf16"] > 0
    both = a & b
    diff = np.abs(maps["fp32"] - maps["bf16"])[both]
    rows["validity_flips"] = int((a != b).sum())
    rows["depth_diff_cm"] = dict(max=100 * float(diff.max()),
                                 mean=100 * float(diff.mean()))
    return rows


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    rest = argv[argv.index("--") + 1:] if "--" in argv else []
    own = argv[:argv.index("--")] if "--" in argv else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--maps-only", action="store_true",
                    help="compare the touch maps and train nothing")
    args = ap.parse_args(own)
    hs = ths.parse_args(rest)
    dev = torch.device(hs.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exp_gpis_precision wants a CUDA device and none "
                           "is available; pass -- --device cpu for the CPU")
    with fp32():
        maps = touch_map_check(hs, dev)
    print(f"touch maps, fp32 against bf16 matvec: {json.dumps(maps)}",
          flush=True)
    out = {"touch_maps": maps}
    if not args.maps_only:
        with matvec("bf16"):
            out["run"] = ths.main(rest)
        print("matvec bf16: " + json.dumps(
            {k: out["run"]["arms"][k] for k in out["run"]["arms"]}),
            flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
