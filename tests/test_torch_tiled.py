"""Parity of the port's scan-path rasterizer (``touchgs_torch/ops/
rasterize_tiled.py``) with the JAX package's ``rasterize_tiled`` on the CPU.

Same projected 300-Gaussian scene at 96x64 (six 32x32 tiles) through both,
on the same ``TileBins`` (the JAX package's), so sort ties cannot reorder a
tile.  Tolerances are the ones the JAX package holds this path to against
its dense oracle (``tests/test_rasterize.py:64-66, 88-89``): rgb/acc 2e-5,
depth 2e-4, gradients 1e-6.  The cases cover truncation (k_tile below a
tile's count), a k_tile that is not a multiple of 64 (with a padded last
chunk), a tile count that is not a multiple of ``tile_block``, and a
background.
"""
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.ops.projection import project_gaussians as j_project
from touchgs_tpu.ops.rasterize_tiled import rasterize_tiled as j_tiled
from touchgs_tpu.ops.tiles import bin_gaussians as j_bin
from touchgs_torch.ops.projection import ProjectedGaussians
from touchgs_torch.ops.rasterize_ref import rasterize_dense as t_dense
from touchgs_torch.ops.tiles import TileBins, bin_gaussians as t_bin

from tests.synthetic import look_at_camera, random_gaussians

# the module: ``touchgs_torch.ops`` re-exports the function under its name
rt = import_module("touchgs_torch.ops.rasterize_tiled")

W, H, N = 96, 64, 300
GRAD_NAMES = ("means2d", "conics", "colors", "opacities", "depths")

# name: (k_tile, k_chunk, tile_block, background)
CASES = {
    # k_tile ≥ N: min(k_tile, N) = 300, so the last chunk of 64 is padded;
    # 6 tiles in blocks of 4
    "full_list_padded": (1024, 64, 4, (0.1, 0.2, 0.3)),
    # k_tile 40 below most tiles' counts; one block of all 6 tiles
    "truncated": (40, 16, 64, None),
    # k_tile 100, not a multiple of 64; 6 tiles in blocks of 5
    "odd_k_tile": (100, 64, 5, (0.5, 0.5, 0.5)),
}


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


@pytest.fixture(scope="module")
def scene():
    means, quats, scales, colors, opac = random_gaussians(N, seed=5)
    cam = look_at_camera(eye=(0.3, 0.2, 2.2), width=W, height=H, focal=110.0)
    cfg = jcfg.RasterizeConfig()
    proj = j_project(means, quats, scales, cam.w2c, cam.fx, cam.fy, cam.cx,
                     cam.cy, W, H, cfg, opacities=opac)
    bins = j_bin(proj, W, H, cfg)
    target = np.random.default_rng(7).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    return dict(proj=proj, bins=bins, colors=colors, opac=opac,
                target=target)


def _t_proj(proj, **diff):
    """The JAX projection as the port's `ProjectedGaussians`, with the
    differentiable fields replaced by ``diff``."""
    p = ProjectedGaussians(*(None if v is None else _t(v) for v in proj))
    return p._replace(**{k: v for k, v in diff.items()
                         if k in ProjectedGaussians._fields})


def _t_bins(bins):
    return TileBins(_t(bins.sorted_gauss), _t(bins.tile_starts),
                    _t(bins.tile_counts), bins.n_tiles_x, bins.n_tiles_y)


def _loss(out, target, xp):
    return (xp.mean((out.rgb - target) ** 2) + 0.3 * xp.mean(out.depth)
            + 0.1 * xp.mean(out.acc))


def _jax(scene, k_tile, k_chunk, tile_block, bg):
    proj, cfg = scene["proj"], jcfg.RasterizeConfig()
    bg = None if bg is None else jnp.asarray(bg, jnp.float32)

    def fn(m2d, con, col, op, z):
        p = proj._replace(means2d=m2d, conics=con, depths=z)
        out = j_tiled(p, col, op, W, H, cfg, background=bg,
                      bins=scene["bins"], k_tile=k_tile, k_chunk=k_chunk,
                      tile_block=tile_block)
        return _loss(out, jnp.asarray(scene["target"]), jnp), out

    args = (proj.means2d, proj.conics, scene["colors"], scene["opac"],
            proj.depths)
    (_, out), grads = jax.value_and_grad(fn, argnums=tuple(range(5)),
                                         has_aux=True)(*args)
    return out, [np.asarray(g) for g in grads]


def _torch(scene, k_tile, k_chunk, tile_block, bg, bins=None):
    proj = scene["proj"]
    diff = {n: _t(v, True) for n, v in zip(GRAD_NAMES, (
        proj.means2d, proj.conics, scene["colors"], scene["opac"],
        proj.depths))}
    out = rt.rasterize_tiled(
        _t_proj(proj, **diff), diff["colors"], diff["opacities"], W, H,
        tcfg.RasterizeConfig(), background=None if bg is None else _t(
            np.float32(bg)),
        bins=_t_bins(scene["bins"]) if bins is None else bins,
        k_tile=k_tile, k_chunk=k_chunk, tile_block=tile_block)
    grads = torch.autograd.grad(_loss(out, _t(scene["target"]), torch),
                                [diff[n] for n in GRAD_NAMES])
    return out, [g.numpy() for g in grads]


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_matches_jax(scene, case):
    k_tile, k_chunk, tile_block, bg = CASES[case]
    jout, jg = _jax(scene, k_tile, k_chunk, tile_block, bg)
    tout, tg = _torch(scene, k_tile, k_chunk, tile_block, bg)
    assert tout.lossy_tiles is None
    counts = np.asarray(scene["bins"].tile_counts)
    if case == "truncated":
        assert (counts > k_tile).any()
    errs = {}
    for name, tol in (("rgb", 2e-5), ("acc", 2e-5), ("depth", 2e-4)):
        a = getattr(tout, name).detach().numpy()
        b = np.asarray(getattr(jout, name))
        np.testing.assert_allclose(a, b, atol=tol, err_msg=name)
        errs[name] = float(np.abs(a - b).max())
    assert float(np.asarray(jout.acc).max()) > 0.5
    for name, a, b in zip(GRAD_NAMES, tg, jg):
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=f"grad {name}")
        errs[f"grad {name}"] = float(np.abs(a - b).max())
    print(f"{case}: max |port - JAX| {errs}")


def test_dead_slot_takes_no_gradient(scene):
    """The gather's backward is an index-add into the table padded with
    the dead row N: culled Gaussians and the last one get exactly JAX's
    gradient, and a Gaussian in no tile's list gets none."""
    _, tg = _torch(scene, *CASES["truncated"])
    listed = np.zeros(N, bool)
    bins = scene["bins"]
    sg, starts = np.asarray(bins.sorted_gauss), np.asarray(bins.tile_starts)
    for s, c in zip(starts, np.asarray(bins.tile_counts)):
        listed[sg[s:s + min(c, CASES["truncated"][0])]] = True
    assert not listed.all()
    for g in tg:
        assert not g[~listed].any()


def test_checkpointed_backward_equals_plain(scene, monkeypatch):
    """The recomputed chunk bodies give the gradients of the plain
    backward, bit for bit."""
    args = CASES["odd_k_tile"]
    _, ckpt = _torch(scene, *args)
    monkeypatch.setattr(rt, "checkpoint", lambda fn, *a, **k: fn(*a))
    _, direct = _torch(scene, *args)
    for a, b in zip(ckpt, direct):
        np.testing.assert_array_equal(a, b)


def test_tile_block_changes_nothing(scene):
    k_tile, k_chunk, _, bg = CASES["odd_k_tile"]
    outs = [_torch(scene, k_tile, k_chunk, b, bg) for b in (1, 4, 64)]
    for out, grads in outs[1:]:
        for name in ("rgb", "depth", "acc"):
            np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                       getattr(outs[0][0], name).detach()
                                       .numpy(), atol=1e-7, err_msg=name)
        for a, b in zip(grads, outs[0][1]):
            np.testing.assert_allclose(a, b, atol=1e-9)


def test_own_binning_matches_dense(scene):
    """The port's own binning and scan path against the port's dense
    oracle: lossless with k_tile ≥ every tile's count."""
    proj = _t_proj(scene["proj"])
    cfg = tcfg.RasterizeConfig()
    cols, op = _t(scene["colors"]), _t(scene["opac"])
    bins = t_bin(proj, W, H, cfg)
    out = rt.rasterize_tiled(proj, cols, op, W, H, cfg, bins=bins,
                             k_tile=512)
    ref = t_dense(proj, cols, op, W, H, cfg)
    np.testing.assert_allclose(out.rgb.numpy(), ref.rgb.numpy(), atol=2e-5)
    np.testing.assert_allclose(out.acc.numpy(), ref.acc.numpy(), atol=2e-5)
    np.testing.assert_allclose(out.depth.numpy(), ref.depth.numpy(),
                               atol=2e-4)


def test_spmd_mode_raises(scene):
    """The SPMD mode, ``tile_shards > 0``, composites the grid in that many
    slices (2 of 3 tiles, 4 of 2 with two padding tiles): the image and
    the five gradients equal those of ``tile_shards=0``, and JAX's own
    SPMD mode."""
    def run(shards):
        diff = {n: _t(getattr(scene["proj"], n), True)
                for n in ("means2d", "conics", "depths")}
        cols, op = _t(scene["colors"], True), _t(scene["opac"], True)
        out = rt.rasterize_tiled(_t_proj(scene["proj"], **diff), cols, op, W,
                                 H, tcfg.RasterizeConfig(), k_tile=512,
                                 bins=_t_bins(scene["bins"]),
                                 tile_shards=shards)
        loss = _loss(out, _t(scene["target"]), torch)
        return out, torch.autograd.grad(loss, list(diff.values()) + [cols, op])

    ref, ref_g = run(0)
    jout = j_tiled(scene["proj"], scene["colors"], scene["opac"], W, H,
                   jcfg.RasterizeConfig(), bins=scene["bins"], k_tile=512,
                   tile_shards=2)
    for shards in (2, 4):
        out, g = run(shards)
        for name in ("rgb", "depth", "acc"):
            torch.testing.assert_close(getattr(out, name), getattr(ref, name),
                                       rtol=0, atol=0, msg=name)
            np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                       np.asarray(getattr(jout, name)),
                                       atol=2e-4 if name == "depth" else 2e-5)
        for a, b in zip(g, ref_g):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-9)
