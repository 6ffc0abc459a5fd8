"""Parity of the port's tile kernels (their plain PyTorch versions) and
rasterizer against the JAX package's Pallas kernels in interpret mode.

K1 is compared bit-exact; K2 and K3 on identical ``attrs_tiled`` and
stacks, with the tolerances the JAX package holds its own kernels to
(``tests/test_pallas.py``): rgb/acc 3e-5, depth 3e-4, gradients 5e-6.
Two inputs: the tiles of a projected 300-Gaussian scene at 96x64, and a
synthetic table of large splats whose tiles saturate, so the
two-chunks-stale exit fires and ``chunks_done`` varies from tile to tile.

The CUDA kernels against their plain versions are in
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.ops import rasterize_pallas as rp
from touchgs_tpu.ops.projection import project_gaussians as j_project
from touchgs_tpu.ops.rasterize_ref import rasterize_dense as j_dense
from touchgs_tpu.ops.tiles import bin_gaussians as j_bin
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.ops.projection import project_gaussians as t_project
from touchgs_torch.ops.rasterize_ref import rasterize_dense as t_dense

from tests.synthetic import look_at_camera, random_gaussians
from tests.test_torch_cuda import saturating_tiles

W, H = 96, 64           # 3x2 tiles of 32x32
K_TILE, K_CHUNK = 512, 64
N_TX, N_TILES = 3, 6


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def scene():
    means, quats, scales, colors, opac = random_gaussians(300, seed=5)
    cam = look_at_camera(eye=(0.3, 0.2, 2.2), width=W, height=H, focal=110.0)
    cfg = jcfg.RasterizeConfig()
    proj = j_project(means, quats, scales, cam.w2c, cam.fx, cam.fy, cam.cx,
                     cam.cy, W, H, cfg, opacities=opac)
    return dict(means=means, quats=quats, scales=scales, colors=colors,
                opac=opac, cam=cam, proj=proj)


def _scene_tiles(scene):
    """The JAX pipeline's per-tile inputs for the scene, as numpy."""
    cfg = jcfg.RasterizeConfig()
    proj = scene["proj"]
    bins = j_bin(proj, W, H, cfg)
    capped = jnp.minimum(bins.tile_counts, K_TILE)
    gidx = rp._slot_lists(bins.sorted_gauss, bins.tile_starts, capped,
                          N_TILES, K_TILE, 300, True)
    attrs = rp._pack_attrs(proj, scene["colors"], scene["opac"])
    return dict(sorted_gauss=np.asarray(bins.sorted_gauss),
                starts=np.asarray(bins.tile_starts),
                capped=np.asarray(capped), gidx=np.asarray(gidx),
                attrs_tiled=np.asarray(attrs[gidx]))


def _tile_cases(scene):
    s = _scene_tiles(scene)
    nc = ((s["capped"] + K_CHUNK - 1) // K_CHUNK).astype(np.int32)
    at, counts = saturating_tiles()
    return {"scene": (s["attrs_tiled"], nc),
            "saturating": (at, (counts + K_CHUNK - 1) // K_CHUNK)}


@pytest.fixture(scope="module")
def tile_cases(scene):
    return _tile_cases(scene)


_TIDS = np.arange(N_TILES, dtype=np.int32)


def _j_forward(at, nc):
    return np.asarray(rp._forward_tiles(
        jnp.asarray(nc), jnp.asarray(_TIDS), jnp.asarray(at), 32, 32, K_TILE,
        K_CHUNK, N_TX, jcfg.RasterizeConfig(), True))


def _t_forward(at, nc):
    return _np(rc.forward_tiles(_t(nc), _t(_TIDS), _t(at), 32, 32, K_TILE,
                                K_CHUNK, N_TX, tcfg.RasterizeConfig()))


def test_slot_lists_bit_exact(scene):
    s = _scene_tiles(scene)
    out = rc.slot_lists(_t(s["sorted_gauss"]), _t(s["starts"]),
                        _t(s["capped"]), N_TILES, K_TILE, 300)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(_np(out), s["gidx"])
    assert (s["capped"] > 0).any() and (s["gidx"] >= 300).any()


@pytest.mark.parametrize("case", ["scene", "saturating"])
def test_forward_tiles_matches(tile_cases, case):
    at, nc = tile_cases[case]
    j, t = _j_forward(at, nc), _t_forward(at, nc)
    np.testing.assert_array_equal(t[:, plain.ROW_DONE], j[:, plain.ROW_DONE])
    for r in (0, 1, 2, 4, plain.ROW_T):
        np.testing.assert_allclose(t[:, r], j[:, r], atol=3e-5, err_msg=r)
    np.testing.assert_allclose(t[:, 3], j[:, 3], atol=3e-4)
    rows = [0, 1, 2, 4, plain.ROW_T]
    print(f"K2 {case}: max |port - JAX| rgb/acc/T "
          f"{np.abs(t[:, rows] - j[:, rows]).max():.3e}, depth "
          f"{np.abs(t[:, 3] - j[:, 3]).max():.3e}")
    done = t[:, plain.ROW_DONE, 0]
    if case == "saturating":  # the stale gate fired, at different chunks
        assert (done < nc).any() and len(set(done)) > 1


@pytest.mark.parametrize("case", ["scene", "saturating"])
def test_backward_tiles_matches(tile_cases, case):
    at, nc = tile_cases[case]
    fwd = _j_forward(at, nc)
    rng = np.random.default_rng(3)
    # cotangent scale of a mean-reduced image loss at this size
    g = (rng.normal(size=fwd.shape) / (W * H)).astype(np.float32)
    done = fwd[:, plain.ROW_DONE, 0].astype(np.int32)
    j = np.asarray(rp._backward_tiles(
        jnp.asarray(done), jnp.asarray(_TIDS), jnp.asarray(at),
        jnp.asarray(fwd), jnp.asarray(g), 32, 32, K_TILE, K_CHUNK, N_TX,
        jcfg.RasterizeConfig(), True))
    t = _np(rc.backward_tiles(_t(done), _t(_TIDS), _t(at), _t(fwd), _t(g),
                              32, 32, K_TILE, K_CHUNK, N_TX,
                              tcfg.RasterizeConfig()))
    assert np.abs(j).max() > 1e-4
    np.testing.assert_allclose(t, j, atol=5e-6, rtol=1e-4)
    print(f"K3 {case}: max |port - JAX| {np.abs(t - j).max():.3e} "
          f"(largest |JAX| {np.abs(j).max():.3e})")
    # rows past the replay are zero
    for tile in range(N_TILES):
        assert not t[tile, done[tile] * K_CHUNK:].any()


def _renders(scene, bg, early_exit=True):
    """Loss with rasterize_pallas (interpret) and with rasterize_cuda."""
    proj = scene["proj"]

    def loss_of(out, xp):
        return (xp.mean((out.rgb - 0.25) ** 2) + 0.3 * xp.mean(out.depth)
                + 0.1 * xp.mean(out.acc))

    def j_fn(off, colors, opac):
        p = proj._replace(means2d=proj.means2d + off)
        out = rp.rasterize_pallas(p, colors, opac, W, H, jcfg.RasterizeConfig(),
                                  k_tile=K_TILE, background=jnp.asarray(bg),
                                  interpret=True, early_exit=early_exit)
        return loss_of(out, jnp), out

    (jl, jout), jg = jax.value_and_grad(j_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.zeros_like(proj.means2d), scene["colors"], scene["opac"])

    tproj = t_project(*(_t(scene[k]) for k in ("means", "quats", "scales")),
                      *(_t(x) for x in (scene["cam"].w2c, scene["cam"].fx,
                                        scene["cam"].fy, scene["cam"].cx,
                                        scene["cam"].cy)),
                      W, H, tcfg.RasterizeConfig(), opacities=_t(scene["opac"]))
    off = torch.zeros((300, 2), requires_grad=True)
    cols, op = _t(scene["colors"], True), _t(scene["opac"], True)
    tout = rc.rasterize_cuda(tproj._replace(means2d=tproj.means2d + off), cols,
                             op, W, H, tcfg.RasterizeConfig(), k_tile=K_TILE,
                             background=_t(bg), early_exit=early_exit)
    tl = loss_of(tout, torch)
    tg = torch.autograd.grad(tl, (off, cols, op))
    return jout, jg, tout, tg


def test_rasterize_cuda_matches_pallas(scene):
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jout, jg, tout, tg = _renders(scene, bg)
    np.testing.assert_allclose(_np(tout.rgb), np.asarray(jout.rgb), atol=3e-5)
    np.testing.assert_allclose(_np(tout.acc), np.asarray(jout.acc), atol=3e-5)
    np.testing.assert_allclose(_np(tout.depth), np.asarray(jout.depth),
                               atol=3e-4)
    assert int(tout.lossy_tiles) == int(jout.lossy_tiles)
    assert float(_np(tout.acc).max()) > 0.5
    for a, b, name in zip(tg, jg, ("means2d", "colors", "opacities")):
        assert np.abs(np.asarray(b)).max() > 0
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=5e-6,
                                   err_msg=f"grad {name}")
    errs = {n: float(np.abs(_np(getattr(tout, n))
                            - np.asarray(getattr(jout, n))).max())
            for n in ("rgb", "acc", "depth")}
    errs.update({f"grad {n}": float(np.abs(_np(a) - np.asarray(b)).max())
                 for a, b, n in zip(tg, jg, ("means2d", "colors",
                                              "opacities"))})
    print(f"rasterize_cuda vs rasterize_pallas: max abs errors {errs}")


def test_rasterize_dense_matches(scene):
    jout = j_dense(scene["proj"], scene["colors"], scene["opac"], W, H,
                   jcfg.RasterizeConfig(), background=jnp.asarray([0.5, 0.5, 0.5]))
    p = scene["proj"]
    tproj = type(t_project(torch.zeros((1, 3)), torch.ones((1, 4)),
                           torch.ones((1, 3)), torch.eye(4), *(_t(1.0),) * 4,
                           1, 1))(*(None if v is None else _t(v) for v in p))
    tout = t_dense(tproj, _t(scene["colors"]), _t(scene["opac"]), W, H,
                   tcfg.RasterizeConfig(), background=_t([0.5, 0.5, 0.5]))
    np.testing.assert_allclose(_np(tout.rgb), np.asarray(jout.rgb), atol=3e-5)
    np.testing.assert_allclose(_np(tout.acc), np.asarray(jout.acc), atol=3e-5)
    np.testing.assert_allclose(_np(tout.depth), np.asarray(jout.depth), atol=3e-4)


def test_out_of_slice_options_raise(scene):
    """``tile_shards`` composites the grid in slices, each through its own
    K1 (with the slice's ``tile0``), K2 and K3: 2 slices of 3 tiles and 4
    of 2 (two padding tiles) render the same image and gradients as the
    whole grid, and each slice's lists are the global lists' slice bit for
    bit.  A k_chunk that does not divide 128 still raises."""
    bg = _t(np.array([0.1, 0.2, 0.3], np.float32))
    tproj = t_project(*(_t(scene[k]) for k in ("means", "quats", "scales")),
                      *(_t(x) for x in (scene["cam"].w2c, scene["cam"].fx,
                                        scene["cam"].fy, scene["cam"].cx,
                                        scene["cam"].cy)),
                      W, H, tcfg.RasterizeConfig(), opacities=_t(scene["opac"]))

    def render(shards):
        cols, op = _t(scene["colors"], True), _t(scene["opac"], True)
        out = rc.rasterize_cuda(tproj, cols, op, W, H, tcfg.RasterizeConfig(),
                                k_tile=K_TILE, background=bg,
                                tile_shards=shards)
        loss = torch.mean((out.rgb - 0.25) ** 2) + 0.3 * torch.mean(out.depth)
        return out, torch.autograd.grad(loss, (cols, op))

    ref, ref_g = render(0)
    for shards in (2, 4):
        out, g = render(shards)
        for name in ("rgb", "depth", "acc", "lossy_tiles"):
            torch.testing.assert_close(getattr(out, name), getattr(ref, name),
                                       rtol=0, atol=0, msg=name)
        for a, b in zip(g, ref_g):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-9)

    s = _scene_tiles(scene)
    full = rc.slot_lists(_t(s["sorted_gauss"]), _t(s["starts"]),
                         _t(s["capped"]), N_TILES, K_TILE, 300)
    for t0, t1 in ((0, 3), (3, 6), (4, 6)):
        part = rc.slot_lists(_t(s["sorted_gauss"]), _t(s["starts"][t0:t1]),
                             _t(s["capped"][t0:t1]), t1 - t0, K_TILE, 300,
                             tile0=t0)
        torch.testing.assert_close(part, full[t0:t1], rtol=0, atol=0)
    cols, op = torch.ones((300, 3)), torch.full((300,), 0.5)
    with pytest.raises(ValueError, match="k_chunk"):
        rc.rasterize_cuda(tproj, cols, op, W, H, k_chunk=96)


def test_wrappers_reject_mixed_or_unsupported_devices():
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="devices"):
        rc.slot_lists(x, x.to("meta"), x, 8, 128, 0)
    with pytest.raises(ValueError, match="devices"):
        rc.slot_lists(x.to("meta"), x.to("meta"), x.to("meta"), 8, 128, 0)
