"""K2 and K3 at every tile shape the JAX rasterizer takes, on the CPU.

The JAX kernels take any (1, npix) pixel layout; the port's K2 and K3 run
whole-warp tiles of at most 1024 pixels in their register kernels and every
other shape (over 1024 pixels, or not a multiple of 32) in their group
kernels (``touchgs_torch/csrc/composite_common.cuh``), whose K3 sums in an
order that ``rasterize_plain._block_sum`` mirrors.  Here:

- the whole tile rasterizer, JAX's ``rasterize_pallas`` in interpret mode
  against the port's ``rasterize_cuda`` on the CPU (the kernels' plain
  versions), on 300 Gaussians at 128x128 with 32x64, 64x64, 16x32, 12x12
  and 8x6 tiles: rgb and acc within 3e-5, depth 3e-4, the gradients with
  respect to means2d, colours and opacities 5e-6 (``tests/test_pallas.py``);
- ``_block_sum`` against a numpy rebuild of the group kernels' order (each
  thread's pixels of a group with the tile padded by zeros, the three
  reduce-scatter steps, the partials warp by warp and group by group), bit
  for bit;
- the group kernels' thread shape for the new pixel counts, and the cap.

The kernels against these plain versions on the card are in
``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.ops import rasterize_pallas as rp
from touchgs_tpu.ops.projection import project_gaussians as j_project
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.ops.projection import project_gaussians as t_project

from tests.synthetic import look_at_camera, random_gaussians
from tests.test_torch_composite import _lane_steps, _slot_quantity

W = H = 128
N = 300
K_TILE, K_CHUNK = 512, 128
TILES = [(32, 64), (64, 64), (16, 32), (12, 12), (8, 6)]
# pixels per thread, threads and pixel groups of the group kernels
GROUP_SHAPES = {35: (4, 32, 1), 48: (4, 32, 1), 144: (4, 64, 1),
                1056: (4, 256, 2), 1600: (4, 256, 2), 2048: (4, 256, 2),
                4096: (4, 256, 4), 16384: (4, 256, 16)}


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


@pytest.fixture(scope="module")
def scene():
    means, quats, scales, colors, opac = random_gaussians(N, seed=5)
    cam = look_at_camera(eye=(0.3, 0.2, 2.2), width=W, height=H, focal=140.0)
    return dict(means=means, quats=quats, scales=scales, colors=colors,
                opac=opac, cam=cam)


def _loss(out, xp):
    return (xp.mean((out.rgb - 0.25) ** 2) + 0.3 * xp.mean(out.depth)
            + 0.1 * xp.mean(out.acc))


@pytest.mark.parametrize("th,tw", TILES)
def test_rasterize_cuda_matches_pallas_at_tile(scene, th, tw):
    cam, bg = scene["cam"], np.array([0.1, 0.2, 0.3], np.float32)
    jc = dataclasses.replace(jcfg.RasterizeConfig(), tile_h=th, tile_w=tw)
    tc = dataclasses.replace(tcfg.RasterizeConfig(), tile_h=th, tile_w=tw)
    proj = j_project(scene["means"], scene["quats"], scene["scales"],
                     cam.w2c, cam.fx, cam.fy, cam.cx, cam.cy, W, H, jc,
                     opacities=scene["opac"])

    def j_fn(off, colors, opac):
        out = rp.rasterize_pallas(proj._replace(means2d=proj.means2d + off),
                                  colors, opac, W, H, jc, k_tile=K_TILE,
                                  k_chunk=K_CHUNK,
                                  background=jnp.asarray(bg), interpret=True)
        return _loss(out, jnp), out

    (_, jout), jg = jax.value_and_grad(j_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.zeros_like(proj.means2d), scene["colors"], scene["opac"])

    tproj = t_project(*(_t(scene[k]) for k in ("means", "quats", "scales")),
                      *(_t(x) for x in (cam.w2c, cam.fx, cam.fy, cam.cx,
                                        cam.cy)),
                      W, H, tc, opacities=_t(scene["opac"]))
    off = torch.zeros((N, 2), requires_grad=True)
    cols, op = _t(scene["colors"], True), _t(scene["opac"], True)
    tout = rc.rasterize_cuda(tproj._replace(means2d=tproj.means2d + off),
                             cols, op, W, H, tc, k_tile=K_TILE,
                             k_chunk=K_CHUNK,
                             background=_t(bg))
    tg = torch.autograd.grad(_loss(tout, torch), (off, cols, op))

    for name, tol in (("rgb", 3e-5), ("acc", 3e-5), ("depth", 3e-4)):
        np.testing.assert_allclose(getattr(tout, name).detach().numpy(),
                                   np.asarray(getattr(jout, name)), atol=tol,
                                   err_msg=name)
    assert float(tout.acc.detach().max()) > 0.5
    errs = {}
    for a, b, name in zip(tg, jg, ("means2d", "colors", "opacities")):
        b = np.asarray(b)
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a.numpy(), b, atol=5e-6,
                                   err_msg=f"grad {name}")
        errs[name] = float(np.abs(a.numpy() - b).max())
    print(f"{th}x{tw} (P {plain.pixels_per_thread(th * tw)}, "
          f"{plain.tile_threads(th * tw)} threads, "
          f"{plain.pixel_groups(th * tw)} groups): rgb "
          f"{np.abs(tout.rgb.detach().numpy() - np.asarray(jout.rgb)).max():.2e}"
          f", grads {errs}")


@pytest.mark.parametrize("npix", sorted(GROUP_SHAPES))
def test_group_kernel_thread_shape(npix):
    """Tiles over 1024 pixels or not a multiple of 32 run kGroupP = 4
    pixels a thread in whole warps of at most 256 threads, in as many
    groups as cover the tile, with less than one group's worth of padding."""
    p, s, groups = GROUP_SHAPES[npix]
    assert not plain.whole_warps(npix)
    assert plain.pixels_per_thread(npix) == p
    assert plain.tile_threads(npix) == s and s % 32 == 0 and s <= 256
    assert plain.pixel_groups(npix) == groups
    assert (groups - 1) * p * s < npix <= groups * p * s


def _group_order_sum(x):
    """(10, npix) float32 → (10,), summed as the group kernel of K3 sums:
    written from the kernel's loops, not from ``_block_sum``."""
    q_n, npix = x.shape
    p, s, groups = GROUP_SHAPES[npix]
    n_warps = s // 32
    parts = []
    for g in range(groups):
        v = np.zeros((q_n, s), np.float32)
        for j in range(p):
            pix = (g * p + j) * s + np.arange(s)
            xj = np.where(pix < npix, x[:, np.minimum(pix, npix - 1)],
                          np.float32(0.0)).astype(np.float32)
            v = xj if j == 0 else v + xj
        part = np.full((q_n, n_warps, 4), np.nan, np.float32)
        for w in range(n_warps):
            o = _lane_steps(np.ascontiguousarray(v[:, w * 32:(w + 1) * 32].T))
            for lane in range(32):
                for j in range(2):
                    k = _slot_quantity(lane, j)
                    if k >= 0:
                        part[k, w, lane & 3] = o[lane, j]
        parts.append(part.reshape(q_n, -1))
    part = np.concatenate(parts, axis=1)
    assert not np.isnan(part).any()
    out = part[:, 0].copy()
    for i in range(1, part.shape[1]):
        out = out + part[:, i]
    return out


@pytest.mark.parametrize("npix", [35, 48, 144, 1600, 2048, 4096])
def test_block_sum_is_the_group_kernels_order(npix):
    rng = np.random.default_rng(npix)
    x = (rng.normal(size=(10, npix)) * rng.uniform(0.1, 10.0, (10, 1))
         ).astype(np.float32)
    got = plain._block_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _group_order_sum(x))
    exact = x.astype(np.float64).sum(axis=1)
    print(f"npix {npix}: max |block sum - float64| "
          f"{np.abs(got - exact).max():.3e}")


def test_tile_cap_raises():
    """K2 and K3 take up to MAX_TILE_PIXELS pixels a tile (C40); past it
    the launch path raises with the cap in its message."""
    rc._check_geometry(128, 128, 512, 64)
    rc._check_geometry(12, 12, 512, 64)
    with pytest.raises(ValueError, match=str(rc.MAX_TILE_PIXELS)):
        rc._check_geometry(128, 129, 512, 64)
    with pytest.raises(ValueError, match="k_chunk"):
        rc._check_geometry(64, 64, 500, 64)
