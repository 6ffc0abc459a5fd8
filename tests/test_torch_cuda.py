"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here but the device rule's needs a CUDA device and skips
without one: the kernels have no CPU mode.  The file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed; on a GPU machine run it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
Inputs are made with numpy from a seed and go through the port's own
pipeline; the tolerances are those ``chip_smoke.py`` holds the kernels to.
Beside the kernels, the paths that use them are driven here at test size:
the trainer, the CLI, the tools, the touch, vision, sensor and NeRF
stacks, the viewer, the parallel steps and the graphed steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from touchgs_torch.config import (DensifyConfig, ModelConfig, RasterizeConfig,
                                  TrainConfig)
from touchgs_torch.data.cameras import Camera, Cameras
from touchgs_torch.data.scene import Scene
from touchgs_torch.ops import anatomy, cuda_build
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.ops.projection import project_gaussians
from touchgs_torch.ops.rasterize_ref import rasterize_dense
from touchgs_torch.ops.tiles import bin_gaussians
from touchgs_torch.tools.exp_kernel_anatomy import probe_inputs
from touchgs_torch.train import graphs
from touchgs_torch.train.graphs import GraphedStep
from touchgs_torch.train.trainer import (Trainer, grow_state,
                                         make_train_step, refine_state,
                                         reset_opacity_state)
from touchgs_torch.utils import telemetry

from chip_smoke import TRAIN_PATH
from test_torch_shade import look_at_c2w

W, H = 96, 64           # 3x2 tiles of 32x32
K_TILE, K_CHUNK = 512, 64
N_TX, N_TILES = 3, 6
N = 300
# TRAIN_PATH: the kernels every training step launches once; the SO3xR3
# step, whose camera takes a gradient, shades through the op chain and
# launches the others (POSE_PATH)
POSE_PATH = TRAIN_PATH[:5]


def _zero_launches() -> None:
    for k in cuda_build.launches:
        cuda_build.launches[k] = 0


def _want(**counts) -> dict:
    """A whole launch dict: ``counts``, every other kernel 0."""
    return {**dict.fromkeys(cuda_build.launches, 0), **counts}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def scene_arrays(seed=5):
    """300 random Gaussians in view of a 96x64 camera, as numpy."""
    rng = np.random.default_rng(seed)
    quats = rng.normal(size=(N, 4))
    return dict(
        means=rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32),
        quats=(quats / np.linalg.norm(quats, axis=-1, keepdims=True)
               ).astype(np.float32),
        scales=np.exp(rng.uniform(-4.5, -3.0, (N, 3))).astype(np.float32),
        colors=rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32),
        opac=rng.uniform(0.3, 0.95, N).astype(np.float32),
        c2w=look_at_c2w((0.3, 0.2, 2.2)),
    )


def _project(a, dev):
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    cam = Camera(fx=t(110.0), fy=t(110.0), cx=t(W / 2), cy=t(H / 2),
                 c2w=t(a["c2w"]), width=W, height=H)
    return project_gaussians(t(a["means"]), t(a["quats"]), t(a["scales"]),
                             cam.w2c, cam.fx, cam.fy, cam.cx, cam.cy, W, H,
                             RasterizeConfig(), opacities=t(a["opac"]))


def saturating_tiles(seed=11, th=32, tw=32):
    """Large splats over every th x tw tile, more opaque from tile to tile:
    whole tiles saturate after different numbers of chunks, so the two-
    chunks-stale exit fires and ``chunks_done`` varies.  Returns the
    (6, 512, 16) attribute table and each tile's entry count."""
    rng = np.random.default_rng(seed)
    at = np.zeros((N_TILES, K_TILE, plain.A), np.float32)
    scale = np.sqrt(th * tw) / 32             # splat size follows the tile
    for t in range(N_TILES):
        n = 64 * (t + 2)                      # 2..7 chunks of entries
        ox, oy = (t % N_TX) * tw, (t // N_TX) * th
        at[t, :n, plain.MX] = ox + rng.uniform(-tw / 4, 1.25 * tw, n)
        at[t, :n, plain.MY] = oy + rng.uniform(-th / 4, 1.25 * th, n)
        sig = rng.uniform(4, 12, n) * scale
        at[t, :n, plain.CA] = 0.5 * 1.4426950408889634 / sig**2
        at[t, :n, plain.CC] = 0.5 * 1.4426950408889634 / sig**2
        at[t, :n, plain.CB] = rng.uniform(-0.2, 0.2, n) / sig**2
        at[t, :n, plain.OP] = rng.uniform(0.05, 0.1 + 0.1 * t, n)
        at[t, :n, plain.Z] = np.sort(rng.uniform(1, 4, n))
        at[t, :n, plain.R:plain.B + 1] = rng.uniform(0, 1, (n, 3))
    counts = np.array([64 * (t + 2) for t in range(N_TILES)], np.int32)
    return at, counts


def synthetic_slots(k_tile, seed=7, n=1000):
    """K1's inputs for six tiles, as numpy: two empty tiles, a short one,
    one of exactly k_tile entries and two with more than k_tile, which the
    lists cap.  Every row of the (n + 512, 16) table is random, the dead
    rows too, so a row copied from the wrong place shows.  Returns (attrs,
    sorted_gauss, starts, capped counts, n)."""
    rng = np.random.default_rng(seed)
    counts = np.array([0, 5, k_tile, k_tile + 77, 3 * k_tile // 2, 0],
                      np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    sorted_gauss = rng.integers(0, n, int(counts.sum()), dtype=np.int32)
    attrs = rng.normal(size=(n + plain.DEAD_SPREAD, plain.A)).astype(
        np.float32)
    return (attrs, sorted_gauss, starts,
            np.minimum(counts, k_tile).astype(np.int32), n)


def _slot_case(case, k_tile, dev):
    """K1's arguments for ``rc.slot_rows`` on ``dev``: the scene's tiles
    through the port's projection and binning, or ``synthetic_slots``."""
    if case == "scene":
        a = scene_arrays()
        proj = _project(a, dev)
        bins = bin_gaussians(proj, W, H, RasterizeConfig())
        attrs = rc._pack_attrs(proj, torch.as_tensor(a["colors"], device=dev),
                               torch.as_tensor(a["opac"], device=dev))
        capped = torch.clamp(bins.tile_counts, max=k_tile).contiguous()
        return (attrs, bins.sorted_gauss, bins.tile_starts, capped, N_TILES,
                k_tile, N)
    attrs, sg, starts, capped, n = synthetic_slots(k_tile)
    return (*(torch.as_tensor(v, device=dev)
              for v in (attrs, sg, starts, capped)), len(starts), k_tile, n)


def _scene_tiles(dev):
    """K1's lists on the card and their plain version, and the scene's tile
    table gathered through them."""
    attrs, *args = _slot_case("scene", K_TILE, dev)
    gidx = rc.slot_lists(*args)
    return (gidx, plain.slot_lists_plain(*args), attrs[gidx].contiguous(),
            args[2])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["scene", "saturating", "saturating_16x16",
                                  "saturating_8x8", "saturating_4x8"])
def test_cuda_kernels_match_plain(cuda_device, case):
    """K1 bit-exact; K2's chunks_done and T row equal to the plain
    version's, rgb/acc 3e-5, depth 3e-4; K3 bit-exact, because the plain
    version sums in the kernel's order.  The tile sizes take every
    pixels-per-thread instance of K2 and K3 (4, 4, 2, 1)."""
    dev = cuda_device
    th, tw = _case_shape(case)
    if case == "scene":
        gidx, gidx_p, at, counts = _scene_tiles(dev)
        assert torch.equal(gidx, gidx_p)
        assert bool((gidx >= N).any())
    else:
        at_np, counts_np = saturating_tiles(th=th, tw=tw)
        at = torch.as_tensor(at_np, device=dev)
        counts = torch.as_tensor(counts_np, device=dev)
    nc = ((counts + K_CHUNK - 1) // K_CHUNK).to(torch.int32)
    tids = torch.arange(N_TILES, dtype=torch.int32, device=dev)
    cfg = RasterizeConfig()
    args = (nc, tids, at, th, tw, K_TILE, K_CHUNK, N_TX, cfg)
    fwd = rc.forward_tiles(*args)
    fwd_p = plain.forward_tiles_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(fwd[:, plain.ROW_DONE], fwd_p[:, plain.ROW_DONE])
    assert torch.equal(fwd[:, plain.ROW_T], fwd_p[:, plain.ROW_T])
    torch.testing.assert_close(fwd[:, 3], fwd_p[:, 3], atol=3e-4, rtol=0)
    rgba_t = [0, 1, 2, 4, plain.ROW_T]
    torch.testing.assert_close(fwd[:, rgba_t], fwd_p[:, rgba_t], atol=3e-5,
                               rtol=0)
    done = fwd[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
    if case == "saturating":
        assert bool((done < nc).any()) and len(set(done.tolist())) > 1
    g = torch.randn(fwd.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    bargs = (done, tids, at, fwd, g, th, tw, K_TILE, K_CHUNK, N_TX, cfg)
    d = rc.backward_tiles(*bargs)
    d_p = plain.backward_tiles_plain(*bargs)
    torch.cuda.synchronize()
    assert float(d.abs().max()) > 0
    if not torch.equal(d, d_p):
        torch.testing.assert_close(d, d_p, atol=1e-5, rtol=1e-4)
        pytest.fail("K3 is within rtol 1e-4 / atol 1e-5 of its plain "
                    "version but not bit-exact: the summation orders differ")


@pytest.mark.cuda
def test_rasterize_cuda_on_card_matches_cpu(cuda_device):
    """The whole tile rasterizer, kernels on the card against the plain
    versions on the CPU: outputs, and gradients with respect to means2d,
    colours and opacities."""
    a = scene_arrays()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    res = {}
    for dev in (torch.device("cpu"), cuda_device):
        proj = _project(a, dev)
        off = torch.zeros((N, 2), device=dev, requires_grad=True)
        cols = torch.tensor(a["colors"], device=dev, requires_grad=True)
        op = torch.tensor(a["opac"], device=dev, requires_grad=True)
        out = rc.rasterize_cuda(proj._replace(means2d=proj.means2d + off),
                                cols, op, W, H, RasterizeConfig(),
                                background=torch.as_tensor(bg, device=dev))
        loss = (torch.mean((out.rgb - 0.25) ** 2) + 0.3 * torch.mean(out.depth)
                + 0.1 * torch.mean(out.acc))
        grads = torch.autograd.grad(loss, (off, cols, op))
        res[dev.type] = [x.detach().cpu() for x in (out.rgb, out.acc,
                                                    out.depth, *grads)]
    c, g = res["cpu"], res["cuda"]
    assert float(c[1].max()) > 0.5
    torch.testing.assert_close(g[0], c[0], atol=3e-5, rtol=0)
    torch.testing.assert_close(g[1], c[1], atol=3e-5, rtol=0)
    torch.testing.assert_close(g[2], c[2], atol=3e-4, rtol=0)
    for gg, cc in zip(g[3:], c[3:]):
        assert float(cc.abs().max()) > 0
        torch.testing.assert_close(gg, cc, atol=5e-6, rtol=1e-4)


def card_scene(n_views: int = 2) -> Scene:
    """``n_views`` (2 or 3) random 96x64 views and 300 seeds, as numpy."""
    rng = np.random.default_rng(0)
    c2w = np.stack([look_at_c2w((2.0 * np.cos(t), 0.6, 2.0 * np.sin(t)))
                    for t in (0.4, 1.1, 1.8)[:n_views]])
    f = np.full(n_views, 90.0, np.float32)
    cams = Cameras(fx=f, fy=f.copy(), cx=np.full(n_views, W / 2, np.float32),
                   cy=np.full(n_views, H / 2, np.float32), c2w=c2w, width=W,
                   height=H)
    return Scene(
        cameras=cams,
        images=rng.uniform(0, 1, (n_views, H, W, 3)).astype(np.float32),
        depths=rng.uniform(1.5, 3.0, (n_views, H, W)).astype(np.float32),
        uncertainties=rng.uniform(0, 1, (n_views, H, W)).astype(np.float32),
        i_train=np.arange(n_views), i_eval=np.array([], int),
        seed_points=rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32),
        seed_colors=rng.uniform(0, 1, (N, 3)).astype(np.float32),
        scale_factor=1.0, transform=np.eye(4)[:3], name="card")


@pytest.mark.cuda
def test_trainer_on_card_matches_cpu(cuda_device):
    """Three steps of ``Trainer.run`` with the default device (the card)
    against the same steps on the CPU; every step launches K1 with rows,
    K2 and K3 once, and K1 without rows never."""
    scene = card_scene()
    cfg = TrainConfig(model=ModelConfig(
        max_gaussians=512, sh_degree=3,
        rasterize=RasterizeConfig(use_pallas=True)),
        sh_degree_interval=1, log_every=1)
    steps = 3
    logs = {}
    for device in ("cpu", None):
        _zero_launches()
        trainer = Trainer(scene, cfg, device=device)
        log = []
        trainer.run(steps, log_fn=log.append)
        logs[trainer.device.type] = log
        counts = dict(cuda_build.launches)
        want = _want(**(dict.fromkeys(TRAIN_PATH, steps)
                        if device is None else {}))
        assert counts == want, counts
    for key in ("loss", "psnr"):
        c = np.array([m[key] for m in logs["cpu"]])
        g = np.array([m[key] for m in logs["cuda"]])
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, c, rtol=1e-3, err_msg=key)


@pytest.mark.cuda
def test_trainer_sh_degree_0_on_card(cuda_device):
    """SH degree 0, whose ``sh_rest`` is (C, 0, 3), as the hard scene
    trains it, on the card through K1-K3, Adam, a capacity growth (512 to
    1024 at step 2) and refines at steps 2, 4 and 6 (the last densifies).
    The steps before the first refine equal the CPU's within rtol 1e-3;
    after it each device draws its own split noise."""
    scene = card_scene()
    cfg = TrainConfig(
        model=ModelConfig(max_gaussians=1024, sh_degree=0,
                          rasterize=RasterizeConfig(use_pallas=True)),
        densify=DensifyConfig(warmup_steps=2, refine_every=2,
                              stop_refine_at=100),
        init_capacity=512, grow_trigger_fraction=0.5, log_every=1)
    steps = 7
    logs = {}
    for device in ("cpu", "cuda"):
        _zero_launches()
        trainer = Trainer(scene, cfg, device=device)
        assert tuple(trainer.state.params.sh_rest.shape) == (512, 0, 3)
        log = []
        trainer.run(steps, log_fn=log.append)
        logs[device] = log
        p = trainer.state.params
        assert tuple(p.sh_rest.shape) == (1024, 0, 3)
        assert tuple(trainer.state.opt_state.mu["sh_rest"].shape) == (
            1024, 0, 3)
        # on the card the graphed step captures at step 0 and after the
        # growth (new tensors); the refines write in place and cost none
        counts = {k: trainer.events[k]
                  for k in ("grow", "refine", "reset_opacity", "capture")}
        assert counts == {
            "grow": 1, "refine": 3, "reset_opacity": 0,
            "capture": 2 if device == "cuda" else 0}, trainer.events
        assert int(p.num_alive) > N                 # the refine densified
        assert all(np.isfinite(m["loss"]) for m in log)
        if device == "cuda":
            launched = cuda_build.launches
            assert all(launched[k] == steps for k in (
                "slot_rows", "composite_fwd", "composite_bwd")), launched
    for key in ("loss", "psnr"):
        np.testing.assert_allclose([m[key] for m in logs["cuda"][:3]],
                                   [m[key] for m in logs["cpu"][:3]],
                                   rtol=1e-3, err_msg=key)


def _project_sized(a, dev, w, h):
    """``scene_arrays`` through a camera of w x h pixels whose focal length
    scales with the width, so the splats fill the image as at 96x64."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    f = 110.0 * w / W
    cam = Camera(fx=t(f), fy=t(f), cx=t(w / 2), cy=t(h / 2),
                 c2w=t(a["c2w"]), width=w, height=h)
    return project_gaussians(t(a["means"]), t(a["quats"]), t(a["scales"]),
                             cam.w2c, cam.fx, cam.fy, cam.cx, cam.cy, w, h,
                             RasterizeConfig(), opacities=t(a["opac"]))


# (rgb and acc, depth where the oracle's acc > 0.5) against the dense
# oracle.  At 400x400 the splats span 4x the pixels they span at 96x64, and
# the tile paths drop contributions of alpha about 1/255 beyond each
# splat's opacity-adaptive cull radius, which the oracle keeps: rgb 3.9e-3,
# acc 4.4e-3, depth 1.4e-3 measured on the CPU, in the JAX package's own
# ``rasterize_tiled`` (rgb 3.9e-3) as in the port's (ROADMAP.md C16)
DENSE_TOL = {(400, 400): (5e-3, 2e-3), (100, 72): (1e-4, 1e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("w, h", [(400, 400), (100, 72)])
def test_partial_tiles_match_plain_and_dense(cuda_device, w, h):
    """Images whose last tile row and column are partial, as the hard
    scene's 400x400 (13x13 tiles for 12.5) and 100x72; ``rasterize_cuda``
    crops them after compositing.  On the image's own tiles: K1 with rows
    equal to its plain version, K2 with equal chunks_done and T row, K3
    bit-exact; the render against the CPU's (rgb/acc 3e-5, depth 3e-4)
    and against the dense oracle (``DENSE_TOL``); its gradients against
    the CPU's."""
    dev = cuda_device
    a = scene_arrays()
    cfg = RasterizeConfig()
    n_tx, n_ty = -(-w // 32), -(-h // 32)
    assert n_tx * 32 > w and n_ty * 32 > h
    proj = _project_sized(a, dev, w, h)
    bins = bin_gaussians(proj, w, h, cfg)
    assert (bins.n_tiles_x, bins.n_tiles_y) == (n_tx, n_ty)
    n_tiles = n_tx * n_ty
    colors = torch.as_tensor(a["colors"], device=dev)
    opac = torch.as_tensor(a["opac"], device=dev)
    attrs = rc._pack_attrs(proj, colors, opac)
    capped = torch.clamp(bins.tile_counts, max=K_TILE).contiguous()
    args = (attrs, bins.sorted_gauss, bins.tile_starts, capped, n_tiles,
            K_TILE, N)
    gidx, rows = rc.slot_rows(*args)
    gidx_p, rows_p = plain.slot_rows_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(gidx, gidx_p) and torch.equal(rows, rows_p)
    # the last tile column and row hold splats
    last = bins.tile_counts.reshape(n_ty, n_tx)
    assert int(last[:, -1].sum()) > 0 and int(last[-1].sum()) > 0

    nc = ((capped + K_CHUNK - 1) // K_CHUNK).to(torch.int32)
    tids = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    fargs = (nc, tids, rows, 32, 32, K_TILE, K_CHUNK, n_tx, cfg)
    fwd = rc.forward_tiles(*fargs)
    fwd_p = plain.forward_tiles_plain(*fargs)
    torch.cuda.synchronize()
    assert torch.equal(fwd[:, plain.ROW_DONE], fwd_p[:, plain.ROW_DONE])
    assert torch.equal(fwd[:, plain.ROW_T], fwd_p[:, plain.ROW_T])
    torch.testing.assert_close(fwd[:, 3], fwd_p[:, 3], atol=3e-4, rtol=0)
    torch.testing.assert_close(fwd[:, [0, 1, 2, 4]], fwd_p[:, [0, 1, 2, 4]],
                               atol=3e-5, rtol=0)
    done = fwd[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
    g = torch.randn(fwd.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    bargs = (done, tids, rows, fwd, g, 32, 32, K_TILE, K_CHUNK, n_tx, cfg)
    d = rc.backward_tiles(*bargs)
    d_p = plain.backward_tiles_plain(*bargs)
    torch.cuda.synchronize()
    assert float(d.abs().max()) > 0 and torch.equal(d, d_p)

    with torch.no_grad():
        out = rc.rasterize_cuda(proj, colors, opac, w, h, cfg)
        ref = rasterize_dense(proj, colors, opac, w, h, cfg)
    assert tuple(out.rgb.shape) == (h, w, 3) and out.depth.shape == (h, w)
    assert float(ref.acc[:, -1].max()) > 0.1 and float(
        ref.acc[-1].max()) > 0.1                  # the cropped edges are lit
    tol, tol_depth = DENSE_TOL[(w, h)]
    lit = ref.acc > 0.5
    assert float((out.rgb - ref.rgb).abs().max()) <= tol
    assert float((out.acc - ref.acc).abs().max()) <= tol
    assert float((out.depth - ref.depth).abs()[lit].max()) <= tol_depth

    # the whole rasterizer, card against CPU, on the card's projection
    # copied to the CPU: a contribution whose alpha sits at the 1/255 cut
    # may fall on either side of it on the two devices (with each device
    # projecting for itself, 3 of 480,000 rgb values at 400x400 were
    # 3.9e-3 apart), so at most 0.01% of values may exceed the kernels'
    # tolerances, by no more than 5e-3 in rgb and acc
    proj_cpu = type(proj)(*(x.cpu() for x in proj))
    res = {}
    for device, pr in ((torch.device("cpu"), proj_cpu), (dev, proj)):
        off = torch.zeros((N, 2), device=device, requires_grad=True)
        cols = torch.tensor(a["colors"], device=device, requires_grad=True)
        op = torch.tensor(a["opac"], device=device, requires_grad=True)
        o = rc.rasterize_cuda(pr._replace(means2d=pr.means2d + off), cols,
                              op, w, h, cfg)
        loss = (torch.mean((o.rgb - 0.25) ** 2) + 0.3 * torch.mean(o.depth)
                + 0.1 * torch.mean(o.acc))
        res[device.type] = [x.detach().cpu() for x in (
            o.rgb, o.acc, o.depth, *torch.autograd.grad(loss,
                                                        (off, cols, op)))]
    # Depth is normalised by acc, so a flipped contribution moves it by at
    # most (its depth - the pixel's) / (255 acc): where acc > 0.5, with the
    # scene's depths spanning 1.79, by at most 1.4e-2
    lit_cpu = res["cpu"][1] > 0.5
    for k, (g, c, t) in enumerate(zip(res["cuda"][:3], res["cpu"][:3],
                                      (3e-5, 3e-5, 3e-4))):
        diff = (g - c).abs()
        assert float((diff > t).float().mean()) <= 1e-4, k
        cap = float(diff[lit_cpu].max()) if k == 2 else float(diff.max())
        assert cap <= (2e-2 if k == 2 else 5e-3), (k, cap)
    for gg, cc in zip(res["cuda"][3:], res["cpu"][3:]):
        assert float(cc.abs().max()) > 0
        torch.testing.assert_close(gg, cc, atol=5e-6, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("npix", [1024, 256, 64, 32])
def test_composite_launch_shapes(cuda_device, npix):
    """K2 and K3 run npix / P threads a block with P as the plain version
    computes it, and keep at least two 32x32 tiles resident per SM."""
    want = plain.pixels_per_thread(npix)
    for name, variant in (("composite_fwd", 1), ("composite_fwd", 0),
                          ("composite_bwd", 0)):
        info = cuda_build.kernel_info(name, npix, K_CHUNK, variant)
        assert info["pixels_per_thread"] == want, (name, info)
        assert info["threads"] == npix // want, (name, info)
        assert info["blocks_per_sm"] >= (2 if npix == 1024 else 1), (name,
                                                                      info)


# tiles the group kernels take: over 1024 pixels, or not a multiple of 32
GROUP_TILES = [(32, 64), (64, 64), (16, 128), (12, 12), (8, 6), (40, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit", [True, False], ids=["exit", "noexit"])
@pytest.mark.parametrize("th,tw", GROUP_TILES)
def test_group_kernels_match_plain(cuda_device, th, tw, early_exit):
    """K2 and K3 at tile shapes the register kernels cannot take, on
    ``saturating_tiles`` of that shape: K2's chunks_done and T row equal to
    the plain version's, rgb/acc 3e-5, depth 3e-4; K3 equal to its plain
    version (``torch.equal``), which sums in the group kernel's order;
    each counts one launch."""
    dev = cuda_device
    at_np, counts_np = saturating_tiles(th=th, tw=tw)
    at = torch.as_tensor(at_np, device=dev)
    nc = torch.as_tensor((counts_np + K_CHUNK - 1) // K_CHUNK, device=dev)
    tids = torch.arange(N_TILES, dtype=torch.int32, device=dev)
    args = (nc, tids, at, th, tw, K_TILE, K_CHUNK, N_TX, RasterizeConfig())
    before = dict(cuda_build.launches)
    fwd = rc.forward_tiles(*args, early_exit=early_exit)
    fwd_p = plain.forward_tiles_plain(*args, early_exit=early_exit)
    torch.cuda.synchronize()
    assert fwd.shape == (N_TILES, plain.ROWS, th * tw)
    assert torch.equal(fwd[:, plain.ROW_DONE], fwd_p[:, plain.ROW_DONE])
    assert torch.equal(fwd[:, plain.ROW_T], fwd_p[:, plain.ROW_T])
    torch.testing.assert_close(fwd[:, 3], fwd_p[:, 3], atol=3e-4, rtol=0)
    torch.testing.assert_close(fwd[:, [0, 1, 2, 4]], fwd_p[:, [0, 1, 2, 4]],
                               atol=3e-5, rtol=0)
    assert float(fwd[:, 4].max()) > 0.5
    done = fwd[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
    if not early_exit:
        assert torch.equal(done, torch.clamp(nc, max=K_TILE // K_CHUNK))
    g = torch.randn(fwd.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    bargs = (done, tids, at, fwd, g, th, tw, K_TILE, K_CHUNK, N_TX,
             RasterizeConfig())
    d = rc.backward_tiles(*bargs)
    d_p = plain.backward_tiles_plain(*bargs)
    torch.cuda.synchronize()
    assert cuda_build.launches["composite_fwd"] == before["composite_fwd"] + 1
    assert cuda_build.launches["composite_bwd"] == before["composite_bwd"] + 1
    assert float(d.abs().max()) > 0
    assert torch.equal(d, d_p), float((d - d_p).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("npix", [35, 48, 144, 1600, 2048, 4096, 16384])
def test_group_kernel_launch_shapes(cuda_device, npix):
    """The group kernels run ``tile_threads`` threads of
    ``pixels_per_thread`` pixels, as the plain version computes them, and
    fit on an SM at every shape up to the cap with k_chunk 64 and 256."""
    for k_chunk in (64, 256):
        for name, variant in (("composite_fwd", 1), ("composite_fwd", 0),
                              ("composite_bwd", 0)):
            info = cuda_build.kernel_info(name, npix, k_chunk, variant)
            assert info["pixels_per_thread"] == plain.pixels_per_thread(npix)
            assert info["threads"] == plain.tile_threads(npix), (name, info)
            assert info["blocks_per_sm"] >= 1, (name, info)


@pytest.mark.cuda
def test_tile_limits_raise_on_card(cuda_device):
    """K2 and K3 refuse a tile past ``MAX_TILE_PIXELS`` and K5 one that is
    not whole warps, before any launch."""
    dev = cuda_device
    at = torch.zeros((1, K_TILE, plain.A), device=dev)
    one = torch.ones((1,), dtype=torch.int32, device=dev)
    cfg = RasterizeConfig()
    before = dict(cuda_build.launches)
    with pytest.raises(ValueError, match=str(rc.MAX_TILE_PIXELS)):
        rc.forward_tiles(one, one * 0, at, 129, 128, K_TILE, K_CHUNK, 1, cfg)
    with pytest.raises(ValueError, match="K5"):
        anatomy.variant("full", one, one * 0, at, 12, 12, K_TILE, 128, 1, cfg)
    assert cuda_build.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("k_tile", [128, 512, 8192])
@pytest.mark.parametrize("case", ["scene", "saturating"])
def test_slot_rows_matches_plain(cuda_device, case, k_tile):
    """K1 with rows equal to its plain version (``slot_lists_plain``, then
    ``attrs[gidx]``) on both outputs, and K1 without rows equal to the same
    lists; each call counts one launch under its own name."""
    args = _slot_case(case, k_tile, cuda_device)
    before = dict(cuda_build.launches)
    gidx, rows = rc.slot_rows(*args)
    gidx_alone = rc.slot_lists(*args[1:])
    gidx_p, rows_p = plain.slot_rows_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(gidx, gidx_p) and torch.equal(gidx_alone, gidx_p)
    assert torch.equal(rows, rows_p)
    assert rows.shape == (args[4], k_tile, plain.A)
    assert bool((gidx >= args[6]).any())          # dead slots were copied
    assert cuda_build.launches["slot_rows"] == before["slot_rows"] + 1
    assert cuda_build.launches["slot_lists"] == before["slot_lists"] + 1


@pytest.mark.cuda
def test_rasterize_cuda_gradients_equal_gather_path(cuda_device,
                                                    monkeypatch):
    """``rasterize_cuda`` through K1 with rows against the same render with
    K1's lists gathered by ``attrs[gidx]``, as the tiles were read before
    K1 wrote the rows: equal outputs and gradients, and one K1 launch a
    render."""
    a = scene_arrays()
    dev = cuda_device
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)

    def render():
        proj = _project(a, dev)
        off = torch.zeros((N, 2), device=dev, requires_grad=True)
        cols = torch.tensor(a["colors"], device=dev, requires_grad=True)
        op = torch.tensor(a["opac"], device=dev, requires_grad=True)
        out = rc.rasterize_cuda(proj._replace(means2d=proj.means2d + off),
                                cols, op, W, H, RasterizeConfig(),
                                background=bg)
        loss = (torch.mean((out.rgb - 0.25) ** 2) + 0.3 * torch.mean(out.depth)
                + 0.1 * torch.mean(out.acc))
        return [out.rgb, out.acc, out.depth,
                *torch.autograd.grad(loss, (off, cols, op))]

    before = dict(cuda_build.launches)
    new = render()
    torch.cuda.synchronize()
    assert cuda_build.launches["slot_rows"] == before["slot_rows"] + 1
    assert cuda_build.launches["slot_lists"] == before["slot_lists"]

    def gather(attrs, sorted_gauss, starts, counts, n_tiles, k_tile, dead,
               tile0=0):
        gidx = rc.slot_lists(sorted_gauss, starts, counts, n_tiles, k_tile,
                             dead, tile0)
        return attrs[gidx], gidx

    monkeypatch.setattr(rc._SlotRows, "apply", gather)
    old = render()
    torch.cuda.synchronize()
    assert float(new[3].abs().max()) > 0
    for x, y in zip(new, old):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_launch_stream_is_torchs_current(cuda_device):
    """The launch path's raw stream handle is PyTorch's current stream, on
    the default stream and inside ``torch.cuda.stream``, where K4 then
    runs."""
    assert (cuda_build.current_stream()
            == torch.cuda.current_stream().cuda_stream)
    side = torch.cuda.Stream()
    x = torch.ones((8, 128), device=cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert cuda_build.current_stream() == side.cuda_stream
        out = cuda_build.compile_smoke(x)
    side.synchronize()
    assert torch.equal(out, torch.full_like(x, 2.0))


@pytest.mark.cuda
def test_wrappers_check_tensors_on_card(cuda_device):
    """On the card each wrapper checks dtype, shape and layout and raises
    before it launches."""
    i32 = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    attrs = torch.zeros((552, 16), device=cuda_device)
    bad = {
        "sorted_gauss: want contiguous torch.int32": lambda: rc.slot_lists(
            i32.long(), i32, i32, 8, 128, 0),
        r"attrs: want .* \(552, 16\)": lambda: rc.slot_rows(
            attrs[:-1], i32, i32, i32, 8, 128, 40),
        "counts: want .* got non-contiguous": lambda: rc.slot_rows(
            attrs, i32, i32, torch.zeros(16, dtype=torch.int32,
                                         device=cuda_device)[::2], 8, 128,
            40),
        "x: want contiguous torch.float32": lambda: cuda_build.compile_smoke(
            attrs.double()),
    }
    # contiguous, but 2 bytes past an aligned start
    rows = torch.zeros(512 * 16 + 1, dtype=torch.bfloat16,
                       device=cuda_device)[1:].view(1, 512, 16)
    bad["attrs: want a 16-byte aligned start"] = lambda: anatomy.bf16_probe(
        rows)
    before = dict(cuda_build.launches)
    for match, call in bad.items():
        with pytest.raises(ValueError, match=match):
            call()
    assert cuda_build.launches == before


@pytest.mark.cuda
def test_compile_smoke_odd_shape(cuda_device):
    """K4 on a shape that fills no whole block or warp, and on a view 4
    bytes past an aligned address."""
    base = torch.arange(1 + 3 * 77, dtype=torch.float32,
                        device=cuda_device) - 100.5
    for x in (base[:-1].reshape(3, 77), base[1:].reshape(3, 77)):
        out = cuda_build.compile_smoke(x)
        torch.cuda.synchronize()
        assert torch.equal(out, cuda_build.compile_smoke_plain(x))


@pytest.mark.cuda
def test_compile_smoke_on_card(cuda_device):
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device=cuda_device).reshape(8, 128)
    before = cuda_build.launches["compile_smoke"]
    out = cuda_build.compile_smoke(x)
    torch.cuda.synchronize()
    assert torch.equal(out, cuda_build.compile_smoke_plain(x))
    assert torch.equal(cuda_build.compile_smoke(), torch.full_like(x, 2.0))
    assert cuda_build.launches["compile_smoke"] == before + 2


# ---- SSIM (csrc/ssim.cu) ----------------------------------------------------

# the kernels against the plain version on the card (band-matrix products,
# TF32 off): a stencil and a matrix product sum in different orders.
# Measured on an H100 at the four shapes below: value 6.3e-8 relative,
# gradient 1.44e-6 of its largest
SSIM_VALUE_RTOL = 1e-6
SSIM_GRAD_ATOL = 1e-5     # of the largest |dL/dx|


def ssim_images(shape, dev, seed=0):
    """Two (H, W, C) images from a seed, the second the first plus noise,
    as the training loss has them: a render and its ground truth."""
    C, H, W = shape
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (H, W, C)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return (torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev))


def ssim_kernel_grad(a, b):
    """The value and dL/da of ``ssim_cm`` on the channel-major views of
    (H, W, C) images, as ``compute_losses`` calls it: dL/da is (H, W, C)."""
    from touchgs_torch.ops.ssim import ssim_cm

    leaf = a.detach().clone().requires_grad_()
    v = ssim_cm(leaf.permute(2, 0, 1), b.permute(2, 0, 1))
    (g,) = torch.autograd.grad(v, leaf)
    return v.detach(), g


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 800, 800), (3, 720, 1280),
                                   (3, 33, 97), (1, 7, 9)])
def test_ssim_kernels_match_plain(cuda_device, shape):
    """The forward and backward kernels against ``ssim_fwd_plain`` and
    ``ssim_bwd_plain`` on the card at the cells' shapes (800x800 and
    1280x720, whose last tile row is ragged), a non-square odd size and
    an image under the 11x11 window: value rtol SSIM_VALUE_RTOL, gradient
    into ``img0`` within SSIM_GRAD_ATOL of its largest; one launch of
    each kernel."""
    from touchgs_torch.ops.ssim import ssim_bwd_plain, ssim_fwd_plain

    a, b = ssim_images(shape, cuda_device)
    before = dict(cuda_build.launches)
    v, g = ssim_kernel_grad(a, b)
    torch.cuda.synchronize()
    assert _counts_since(before, cuda_build.launches) == {
        **dict.fromkeys(before, 0), "ssim_fwd": 1, "ssim_bwd": 1}
    pa, pb = a.permute(2, 0, 1), b.permute(2, 0, 1)
    pv, maps = ssim_fwd_plain(pa, pb, 0.01**2, 0.03**2, True)
    pg = ssim_bwd_plain(pa, pb, maps, torch.ones((), device=cuda_device))
    torch.testing.assert_close(v, pv, rtol=SSIM_VALUE_RTOL, atol=0)
    torch.testing.assert_close(
        g.permute(2, 0, 1), pg, rtol=0,
        atol=SSIM_GRAD_ATOL * float(pg.abs().max()))
    assert g.stride() == a.stride()


@pytest.mark.cuda
def test_ssim_kernels_identity_and_repeat(cuda_device):
    """An image against itself reads 1 within 1e-6; two runs of the
    kernels give the same value and gradient bit for bit."""
    from touchgs_torch.ops.ssim import ssim

    a, b = ssim_images((3, 800, 800), cuda_device)
    assert abs(float(ssim(a, a)) - 1.0) <= 1e-6
    v0, g0 = ssim_kernel_grad(a, b)
    v1, g1 = ssim_kernel_grad(a, b)
    assert torch.equal(v0, v1) and torch.equal(g0, g1)


@pytest.mark.cuda
def test_ssim_graph_replay_equals_eager(cuda_device):
    """The forward and backward captured in a CUDA graph: a replay equals
    the eager call bit for bit, before and after new data is copied into
    the captured input."""
    from touchgs_torch.ops.ssim import ssim_cm

    a, b = ssim_images((3, 200, 300), cuda_device)
    leaf = a.clone().requires_grad_()

    def step():
        v = ssim_cm(leaf.permute(2, 0, 1), b.permute(2, 0, 1))
        return (v.detach(), *torch.autograd.grad(v, leaf))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    for new in (a, a.flip(0)):
        with torch.no_grad():
            leaf.copy_(new)
        graph.replay()
        eager = step()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(captured, eager))


@pytest.mark.cuda
def test_ssim_no_sync(cuda_device):
    """A forward and backward of the kernels make no synchronisation:
    ``set_sync_debug_mode("error")`` raises on any."""
    a, b = ssim_images((3, 64, 96), cuda_device)
    leaf = a.clone().requires_grad_()
    from touchgs_torch.ops.ssim import ssim_cm

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        v = ssim_cm(leaf.permute(2, 0, 1), b.permute(2, 0, 1))
        torch.autograd.grad(v, leaf)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_ssim_launches_and_img1_gradient(cuda_device):
    """A forward under ``no_grad`` launches the forward kernel alone; the
    gradient into ``img1`` alone launches the forward with the images'
    roles swapped and the backward, and equals the plain version's."""
    from touchgs_torch.ops.ssim import (ssim, ssim_bwd_plain, ssim_cm,
                                        ssim_fwd_plain)

    a, b = ssim_images((3, 33, 97), cuda_device)
    before = dict(cuda_build.launches)
    with torch.no_grad():
        ssim(a, b)
    leaf = b.clone().requires_grad_()
    v = ssim_cm(a.permute(2, 0, 1), leaf.permute(2, 0, 1))
    (g,) = torch.autograd.grad(v, leaf)
    torch.cuda.synchronize()
    assert _counts_since(before, cuda_build.launches) == {
        **dict.fromkeys(before, 0), "ssim_fwd": 3, "ssim_bwd": 1}
    pa, pb = a.permute(2, 0, 1), b.permute(2, 0, 1)
    _, maps = ssim_fwd_plain(pb, pa, 0.01**2, 0.03**2, True)
    pg = ssim_bwd_plain(pb, pa, maps, torch.ones((), device=cuda_device))
    torch.testing.assert_close(
        g.permute(2, 0, 1), pg, rtol=0,
        atol=SSIM_GRAD_ATOL * float(pg.abs().max()))


@pytest.mark.cuda
def test_ssim_wrappers_check_tensors_on_card(cuda_device):
    """The kernels' wrappers raise before they launch on a tensor of the
    CPU among the card's, a float64 image, images of two shapes, a 2-D
    image and maps of the wrong shape."""
    from touchgs_torch.ops.ssim import ssim_bwd, ssim_fwd

    a, b = (x.permute(2, 0, 1) for x in ssim_images((3, 16, 24),
                                                     cuda_device))
    maps = torch.zeros((3, 3, 16, 24), device=cuda_device)
    grad = torch.ones((), device=cuda_device)
    c = (0.01**2, 0.03**2, True)
    bad = {
        "unsupported devices": lambda: ssim_fwd(a, b.cpu(), *c),
        r"img0: .* got torch\.float64": lambda: ssim_fwd(
            a.double(), b.double(), *c),
        r"img1: want .* \(3, 16, 24\)": lambda: ssim_fwd(a, b[:, :8], *c),
        r"img0: .* shape \(16, 24\)": lambda: ssim_fwd(a[0], b[0], *c),
        r"maps: want .* \(3, 3, 16, 24\)": lambda: ssim_bwd(a, b, maps[:2],
                                                             grad),
    }
    before = dict(cuda_build.launches)
    for match, call in bad.items():
        with pytest.raises(ValueError, match=match):
            call()
    assert cuda_build.launches == before


# ---- the shade stage (csrc/shade.cu) ---------------------------------------

# the cells' start states (the benchmark's polish states, SH 3) and the
# CPU tests' planted state at each active degree and without eps2d
SHADE_STATES = ["blender800", "mirror720", "real1m", "planted0", "planted1",
                "planted2", "planted3", "degenerate"]


def shade_state(name, dev) -> tuple:
    """(groups, alive, camera, model config, active degree) of a state of
    SHADE_STATES on ``dev``."""
    from chip_smoke import cell_shade_state
    from test_torch_shade import camera as planted_camera
    from test_torch_shade import planted
    from touchgs_torch.ops import shade as sh

    if name in ("blender800", "mirror720", "real1m"):
        params, cam, mcfg = cell_shade_state(name, dev)
        return (tuple(getattr(params, g) for g in sh.GROUPS), params.alive,
                cam, mcfg, 3)
    degenerate = name == "degenerate"
    active = 3 if degenerate else int(name[-1])
    groups, alive = planted(3, seed=30 + active, isotropic=degenerate)
    c = planted_camera()
    cam = Camera(*(getattr(c, f).to(dev) for f in ("fx", "fy", "cx", "cy",
                                                   "c2w")),
                 width=c.width, height=c.height)
    mcfg = ModelConfig(sh_degree=3, rasterize=RasterizeConfig(
        eps2d=0.0 if degenerate else 0.3))
    return (tuple(g.to(dev) for g in groups), alive.to(dev), cam, mcfg,
            active)


@pytest.mark.cuda
@pytest.mark.parametrize("state", SHADE_STATES)
def test_shade_kernels_match_the_op_chain(cuda_device, state):
    """The forward kernel against the op chain on the card
    (``shade_fwd_plain``: ``splatfacto.shade`` and ``_attr_rows``): the
    table, means2d and depths within chip_smoke.SHADE_ULPS of the chain's,
    radii, cull radii and validity equal, the dead rows zero; the
    backward kernel against ``torch.autograd.grad`` of the chain for a
    seeded cotangent on the valid rows: each group within SHADE_GRAD_TOL
    of its largest, zero on every row the cotangent skips, the colour
    groups' zeros where autograd's are."""
    from chip_smoke import SHADE_GRAD_TOL, SHADE_ULPS, shade_errors
    from test_torch_shade import assert_grads_close, chain_grads
    from touchgs_torch.ops import shade as sh

    groups, alive, cam, mcfg, active = shade_state(state, cuda_device)
    C = groups[0].shape[0]
    off = torch.zeros((C, 2), device=cuda_device)
    before = dict(cuda_build.launches)
    fwd = sh.shade_fwd(groups, alive, off, cam, cam.w2c, mcfg, active, 512)
    ref = sh.shade_fwd_plain(groups, alive, off, cam, cam.w2c, mcfg, active,
                             512)
    err = shade_errors(fwd, ref)
    assert all(err[f"{k}_ulps"] <= SHADE_ULPS
               for k in ("table", "means2d", "depths")), err
    assert err["radii_differ"] == err["cull_radii_differ"] == 0, err
    assert err["valid_differ"] == 0, err
    assert not bool(fwd[0][C:].any())
    assert int(fwd[5].sum()) > 0
    valid, grad, want = chain_grads(groups, alive, cam, mcfg, active)
    assert torch.equal(valid, fwd[5])
    got = sh.shade_bwd(grad, groups, cam, cam.w2c, mcfg, active)
    torch.cuda.synchronize()
    assert _counts_since(before, cuda_build.launches) == {
        **dict.fromkeys(before, 0), "shade_fwd": 1, "shade_bwd": 1}
    assert_grads_close(got, want, valid, SHADE_GRAD_TOL)


@pytest.mark.cuda
def test_shade_function_launches_and_no_grad(cuda_device):
    """``render``'s path on the card: ``shade_packed`` launches the forward
    kernel, its gradient the backward kernel once; under ``no_grad`` (an
    eval, CLI or viewer render) the forward alone; the offset's gradient
    is the table's two mean columns."""
    from touchgs_torch.models.gaussians import GaussianParams
    from touchgs_torch.ops import shade as sh

    groups, alive, cam, mcfg, active = shade_state("planted3", cuda_device)
    leaves = [g.clone().requires_grad_(True) for g in groups]
    off = torch.zeros((groups[0].shape[0], 2), device=cuda_device,
                      requires_grad=True)
    before = dict(cuda_build.launches)
    with torch.no_grad():
        sh.shade_packed(GaussianParams(*groups, alive), cam, mcfg, active)
    proj, table = sh.shade_packed(GaussianParams(*leaves, alive), cam, mcfg,
                                  active, off)
    cot = torch.randn(table.shape, device=cuda_device) * torch.cat(
        [proj.valid, proj.valid.new_zeros(512)])[:, None]
    grads = torch.autograd.grad(table, leaves + [off], cot)
    torch.cuda.synchronize()
    assert _counts_since(before, cuda_build.launches) == {
        **dict.fromkeys(before, 0), "shade_fwd": 2, "shade_bwd": 1}
    assert torch.equal(grads[-1], cot[:off.shape[0], :2])


@pytest.mark.cuda
def test_shade_graph_replay_equals_eager(cuda_device):
    """The forward and backward captured in a CUDA graph: a replay equals
    the eager call bit for bit, before and after new parameters are copied
    into the captured ones."""
    from touchgs_torch.models.gaussians import GaussianParams
    from touchgs_torch.ops import shade as sh

    groups, alive, cam, mcfg, active = shade_state("blender800",
                                                   cuda_device)
    leaves = [g.clone().requires_grad_(True) for g in groups]
    off = torch.zeros((groups[0].shape[0], 2), device=cuda_device,
                      requires_grad=True)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(0)
    cot = torch.randn((off.shape[0] + 512, 16), generator=g,
                      device=cuda_device)

    def step():
        proj, table = sh.shade_packed(GaussianParams(*leaves, alive), cam,
                                      mcfg, active, off)
        return (table.detach(), proj.radii, proj.valid,
                *torch.autograd.grad(table, leaves + [off], cot))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    for k in range(2):
        if k:
            with torch.no_grad():
                leaves[0].add_(0.01)
                leaves[4].mul_(0.5)
        graph.replay()
        eager = step()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(captured, eager))


@pytest.mark.cuda
def test_shade_no_sync(cuda_device):
    """The function's forward and backward make no synchronisation:
    ``set_sync_debug_mode("error")`` raises on any."""
    from touchgs_torch.models.gaussians import GaussianParams
    from touchgs_torch.ops import shade as sh

    groups, alive, cam, mcfg, active = shade_state("planted2", cuda_device)
    leaves = [g.clone().requires_grad_(True) for g in groups]
    w2c = cam.w2c
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, table = sh.shade_packed(GaussianParams(*leaves, alive), cam, mcfg,
                                   active)
        torch.autograd.grad(table.sum(), leaves)
        sh.shade_bwd(torch.zeros_like(table), groups, cam, w2c, mcfg, active)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_shade_wrappers_check_tensors_on_card(cuda_device):
    """The kernels' wrappers raise before they launch on a tensor of the
    CPU among the card's, a group of the wrong type or shape, a
    non-contiguous group, an active degree past the configuration's and a
    gradient table that is not 16-byte aligned."""
    from touchgs_torch.ops import shade as sh

    groups, alive, cam, mcfg, _ = shade_state("planted3", cuda_device)
    w2c = cam.w2c
    C = groups[0].shape[0]

    def fwd(gs=groups, al=alive, active=3):
        return sh.shade_fwd(tuple(gs), al, None, cam, w2c, mcfg, active, 512)

    table = torch.zeros((C + 512) * 16 + 1, device=cuda_device)
    bad = {
        "unsupported devices": lambda: fwd(al=alive.cpu()),
        r"means: .* got torch\.float64": lambda: fwd(
            gs=(groups[0].double(),) + groups[1:]),
        r"sh_rest: want .* \(300, 15, 3\)": lambda: fwd(
            gs=groups[:5] + (groups[5][:, :8].contiguous(),)),
        r"quats: want contiguous": lambda: fwd(
            gs=(groups[0], groups[1].t().contiguous().t()) + groups[2:]),
        "active SH degree 4": lambda: fwd(active=4),
        "16-byte aligned": lambda: sh.shade_bwd(
            table[1:].view(C + 512, 16), groups, cam, w2c, mcfg, 3),
    }
    before = dict(cuda_build.launches)
    for match, call in bad.items():
        with pytest.raises(ValueError, match=match):
            call()
    assert cuda_build.launches == before


def _case_shape(case):
    """(th, tw) of a tile case: ``saturating_<th>x<tw>``, else 32x32."""
    if case.startswith("saturating_"):
        return tuple(map(int, case.split("_")[1].split("x")))
    return 32, 32


def _tiles_on(dev, case, k_chunk):
    if case == "scene":
        _, _, at, counts = _scene_tiles(dev)
    else:
        th, tw = _case_shape(case)
        at_np, counts_np = saturating_tiles(th=th, tw=tw)
        at = torch.as_tensor(at_np, device=dev)
        counts = torch.as_tensor(counts_np, device=dev)
    nc = ((counts + k_chunk - 1) // k_chunk).to(torch.int32)
    tids = torch.arange(N_TILES, dtype=torch.int32, device=dev)
    return at, nc, tids


@pytest.mark.cuda
@pytest.mark.parametrize("k_chunk", [64, 128])
@pytest.mark.parametrize("case", ["scene", "saturating"])
def test_forward_without_exit_matches_plain(cuda_device, case, k_chunk):
    at, nc, tids = _tiles_on(cuda_device, case, k_chunk)
    args = (nc, tids, at, 32, 32, K_TILE, k_chunk, N_TX, RasterizeConfig())
    fwd = rc.forward_tiles(*args, early_exit=False)
    fwd_p = plain.forward_tiles_plain(*args, early_exit=False)
    torch.cuda.synchronize()
    done = fwd[:, plain.ROW_DONE, 0]
    assert torch.equal(done, torch.clamp(nc, max=K_TILE // k_chunk).float())
    assert torch.equal(fwd[:, plain.ROW_DONE], fwd_p[:, plain.ROW_DONE])
    torch.testing.assert_close(fwd[:, 3], fwd_p[:, 3], atol=3e-4, rtol=0)
    rgba_t = [0, 1, 2, 4, plain.ROW_T]
    torch.testing.assert_close(fwd[:, rgba_t], fwd_p[:, rgba_t], atol=3e-5,
                               rtol=0)


def _tile_rel_err(out, ref):
    scale = ref.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    return float(((out - ref).abs().amax(dim=(1, 2)) / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", anatomy.MODES)
@pytest.mark.parametrize("case", ["scene", "saturating", "saturating_8x8",
                                  "saturating_4x8"])
def test_anatomy_variant_matches_plain(cuda_device, case, mode):
    """K5 against its plain version: 3e-5 of the tile's largest output
    (the plain version's cumulative product and sums round in another
    order; α is bit-identical), T exactly 1 where no mode carries it.  The
    tile sizes take every pixels-per-thread instance (4, 4, 2, 1)."""
    at, nc, tids = _tiles_on(cuda_device, case, 128)
    th, tw = _case_shape(case)
    args = (nc, tids, at, th, tw, K_TILE, 128, N_TX, RasterizeConfig())
    before = cuda_build.launches[f"anatomy_{mode}"]
    out = anatomy.variant(mode, *args)
    ref = anatomy.variant_plain(mode, *args)
    torch.cuda.synchronize()
    assert cuda_build.launches[f"anatomy_{mode}"] == before + 1
    assert out.shape == (N_TILES, 2, th * tw)
    assert float(ref[:, 0].max()) > 0.1
    assert _tile_rel_err(out, ref) <= 3e-5
    if mode in ("alpha_only", "noexp"):
        assert bool((out[:, 1] == 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("npix", [1024, 256, 64, 32])
def test_anatomy_launch_shapes(cuda_device, npix):
    """Every K5 mode runs K2's thread shape: npix / P threads a block with
    P as the plain version computes it, and at least two 32x32 tiles
    resident per SM."""
    want = plain.pixels_per_thread(npix)
    for i, mode in enumerate(anatomy.MODES):
        info = cuda_build.kernel_info("anatomy_variants", npix, 128, i)
        assert info["pixels_per_thread"] == want, (mode, info)
        assert info["threads"] == npix // want, (mode, info)
        assert info["blocks_per_sm"] >= (2 if npix == 1024 else 1), (mode,
                                                                      info)


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [False, True], ids=["uniform", "spread"])
@pytest.mark.parametrize("n_tiles", [1, 3, 133])
@pytest.mark.parametrize("leg", ["f32", "bf16"])
def test_bf16_probe_matches_plain(cuda_device, leg, n_tiles, spread):
    """K6 against its plain version on the card, pixel by pixel: f32 1e-5
    of the tile's largest output (sum order); bf16 2^-6 (h2exp2's f32
    ex2.approx rounded to bf16, and the tensor core adds each chunk in its
    own order).  The uniform rows light only the first pixels of a tile
    (α falls with the pixel index); the spread rows light nearly every
    8-pixel group, so every block, warp, n-tile and lane of the mapping has
    pixels with α > 0, and a lane that summed another pixel's α fails."""
    at = probe_inputs(n_tiles=n_tiles, device=cuda_device, spread=spread)[leg]
    before = cuda_build.launches[f"bf16_probe_{leg}"]
    out = anatomy.bf16_probe(at)
    ref = anatomy.bf16_probe_plain(at)
    torch.cuda.synchronize()
    assert cuda_build.launches[f"bf16_probe_{leg}"] == before + 1
    assert out.shape == (n_tiles, 1, 1024)
    if spread:
        assert float((ref.view(n_tiles, -1, 8) > 0).any(-1).float().mean()) \
            > 0.97
    else:
        assert float(ref.max()) > 100
    assert _tile_rel_err(out, ref) <= (1e-5 if leg == "f32" else 2.0 ** -6)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A scene directory written by ``tools/write_scene.py`` (6 views of
    320x320, 2000 seeds; at 96x96 the GT's 100k splats overflow the
    lossless k_tile 8192 in its 9 tiles), then ``cli train`` 20 steps on the
    card with the launch counters set to 0 just before."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    from touchgs_torch import cli
    from touchgs_torch.tools.write_scene import write_scene

    root = tmp_path_factory.mktemp("cli_scene")
    written = write_scene(root, views=6, size=320, seeds=2000, device="cuda")
    _zero_launches()
    trainer, run = cli.main([
        "train", "--data", str(root), "--preset", "bunny_blender",
        "--max-steps", "20", "--output-dir",
        str(tmp_path_factory.mktemp("outputs"))])
    torch.cuda.synchronize()
    return root, written, trainer, run, dict(cuda_build.launches)


@pytest.mark.cuda
def test_cli_train_on_card(cli_run):
    """``load_scene`` reads back what was written exactly; the CLI trains
    through K1-K3 (each launched every step) and writes its checkpoint."""
    from touchgs_torch.data.scene import load_scene

    root, written, trainer, run, counts = cli_run
    scene = load_scene(root)
    np.testing.assert_array_equal(
        scene.images, written["images"].astype(np.float32) / 255.0)
    np.testing.assert_array_equal(
        scene.depths,
        written["depth_mm"].astype(np.float32) / 1000.0 * scene.scale_factor)
    assert trainer.device.type == "cuda"
    assert trainer.cfg.model.rasterize.use_pallas
    assert all(counts[k] >= 20 for k in ("slot_rows", "composite_fwd",
                                         "composite_bwd")), counts
    assert (run / "checkpoints" / "20.pt").exists()
    assert all(np.isfinite(m["loss"]) for m in trainer.history)


@pytest.mark.cuda
def test_ply_rerender_on_card(cli_run, tmp_path):
    """The trained state exported to ``.ply`` (alive slots, compacted) and
    loaded back renders an eval view through K1-K3 within rgb/acc 3e-5 and
    depth 3e-4 of the trainer's own render."""
    from touchgs_torch.data.ply import load_gaussians_ply, save_gaussians_ply
    from touchgs_torch.models.splatfacto import render_lossless

    _, _, trainer, _, _ = cli_run
    save_gaussians_ply(tmp_path / "splat.ply", trainer.state.params)
    params = load_gaussians_ply(tmp_path / "splat.ply", device="cuda")
    assert int(params.num_alive) == int(trainer.state.params.num_alive)
    view = int(trainer.scene.i_eval[0])
    with torch.no_grad():
        a = render_lossless(params, trainer.scene.cameras.at(view, "cuda"),
                            trainer.cfg.model,
                            active_sh_degree=trainer.cfg.model.sh_degree)
        b = trainer.render_view(view)
    for name, tol in (("rgb", 3e-5), ("acc", 3e-5), ("depth", 3e-4)):
        err = float((getattr(a, name) - getattr(b, name)).abs().max())
        assert err <= tol, (name, err)


# ---------------------------------------- monocular depth and capture --

def small_net(net: str, seed: int = 0):
    """A net of ``touchgs_torch.vision`` at narrow widths with the published
    structure, on a random checkpoint drawn as ``random_checkpoint`` draws
    the full-width ones."""
    import dataclasses

    from touchgs_torch.tools.random_checkpoint import random_checkpoint
    from touchgs_torch.vision import depth_anything as da
    from touchgs_torch.vision import dpt, zoedepth as zd

    vit = dict(hidden_size=64, num_layers=4, num_heads=2,
               intermediate_size=128, image_size=64,
               neck_hidden_sizes=(16, 32, 64, 64), fusion_hidden_size=32)
    if net == "dpt":
        kind, cls = "dpt", dpt.DPT
        arch = dpt.DPTArch(**vit, backbone_out_indices=(0, 1, 2, 3))
    elif net == "depth_anything":
        kind, cls = "depth_anything", da.DepthAnything
        arch = da.DepthAnythingArch(
            hidden_size=64, num_layers=4, num_heads=2, image_size=56,
            out_indices=(1, 2, 3, 4), reassemble_hidden_size=64,
            neck_hidden_sizes=(16, 32, 64, 64), fusion_hidden_size=32,
            head_hidden_size=16)
    else:
        kind, cls = "zoedepth", zd.ZoeDepth
        arch = zd.ZoeDepthArch(**vit, backbone_out_indices=(1, 2, 3, 4),
                               bottleneck_features=32,
                               num_relative_features=8)
        if net == "zoe_nk":
            arch = dataclasses.replace(
                arch, bin_configurations=zd.ZOEDEPTH_NK.bin_configurations)
    return cls(random_checkpoint(kind, arch, seed), arch)


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["dpt", "zoe_n", "zoe_nk", "depth_anything"])
def test_vision_net_on_card_matches_cpu(cuda_device, net):
    """Each net on the card against the CPU at fp32 with TF32 off (the
    nets' own guard): within 1e-4 of the depth's scale; ZoeD_NK routes to
    the same head."""
    model = small_net(net)
    size = (56, 84) if net == "depth_anything" else (64, 96)
    img = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, size + (3,)).astype(np.float32))
    ref = model(img)
    card = model.to(cuda_device)
    out = card(img.to(cuda_device)).cpu()
    scale = float(ref.abs().max())
    assert out.shape == ref.shape and scale > 0.1
    assert float((out - ref).abs().max()) <= 1e-4 * scale
    if net == "zoe_nk":
        assert int(torch.argmax(card.route(img.to(cuda_device)))) == int(
            torch.argmax(model.to("cpu").route(img)))


@pytest.mark.cuda
def test_trunk_pipeline_on_card_matches_cpu(cuda_device):
    """``VisualPipeline``'s compact trunk (random, from the same seed on
    both) on a 100x72 image: within 1e-4 of the scale."""
    from touchgs_torch.vision.monodepth import VisualPipeline

    rgb = np.random.default_rng(4).integers(0, 255, (72, 100, 3),
                                            dtype=np.uint8)
    ref = VisualPipeline(device="cpu").predict_depth(rgb)
    out = VisualPipeline().predict_depth(rgb)
    assert out.shape == (72, 100) and float(np.abs(ref).max()) > 0
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.cuda
def test_capture_renders_on_card_match_cpu(cuda_device):
    """``render_pc_depth`` and ``render_mesh_depth`` of a sphere on the card
    against the CPU: validity flips at most 0.1% of pixels, depths within
    1e-5 m where both hit; ``estimate_normals`` of the points that face
    the camera on the card against the CPU: every pair within 1e-4 of
    parallel."""
    from touchgs_torch.data.meshing import (estimate_normals,
                                            marching_tetrahedra,
                                            poisson_indicator,
                                            render_mesh_depth)
    from touchgs_torch.data.pc_depth import (render_pc_depth,
                                             visibility_by_normals)

    v = np.random.default_rng(5).normal(size=(20000, 3)).astype(np.float32)
    pts = 0.5 * v / np.linalg.norm(v, axis=1, keepdims=True)
    t = lambda x, dev: torch.tensor(x, dtype=torch.float32, device=dev)
    cams = [Camera(fx=t(180.0, d), fy=t(180.0, d), cx=t(100.0, d),
                   cy=t(80.0, d), c2w=t(look_at_c2w((0.4, 0.3, 1.8)), d),
                   width=200, height=160) for d in ("cpu", cuda_device)]
    chi, origin, spacing, level = poisson_indicator(pts, pts * 2, 48)
    verts, faces = marching_tetrahedra(chi, float(level), origin,
                                       float(spacing))
    for ref, out in (
            [render_pc_depth(torch.from_numpy(pts).to(c.c2w.device), c.w2c,
                             c.fx, c.fy, c.cx, c.cy, c.width, c.height, 2)
             .cpu().numpy() for c in cams],
            [render_mesh_depth(verts, faces, c, 256).cpu().numpy()
             for c in cams]):
        both = (ref > 0) & (out > 0)
        assert ((ref > 0) != (out > 0)).mean() <= 1e-3 and both.mean() > 0.1
        assert np.abs(ref[both] - out[both]).max() <= 1e-5
    eye = look_at_c2w((0.4, 0.3, 1.8))[:3, 3]
    scan = pts[visibility_by_normals(pts, pts, eye)]
    ref, out = (estimate_normals(torch.as_tensor(scan, device=d),
                                 viewpoint=eye).cpu()
                for d in ("cpu", cuda_device))
    assert len(scan) > 1000 and float((ref * out).sum(1).min()) > 1 - 1e-4


# ----------------------------------------------- sensor nets and NeRF --

SMALL_DENSENET = dict(init_features=16, growth=8, blocks=(2, 2, 2, 2),
                      bn_size=2)


def small_sensor_net(net: str, seed: int = 0):
    """A sensor net of ``touchgs_torch.touch`` at narrow widths with the
    published structure, on a random checkpoint drawn as
    ``random_checkpoint`` draws the full-width ones."""
    from touchgs_torch.tools.random_checkpoint import random_checkpoint
    from touchgs_torch.touch import densetact_nets as dt
    from touchgs_torch.touch import swin_force as sw

    if net == "stforce":
        arch = sw.SwinArch(img_size=64, patch_size=4, embed_dim=24,
                           depths=(2, 2), num_heads=(2, 4), window_size=8,
                           num_classes=10)
        return sw.STForce(random_checkpoint("stforce", arch, seed), arch)
    cls = dt.DenseDepth if net == "densetact_depth" else dt.DenseNetForce
    return cls(random_checkpoint(net, SMALL_DENSENET, seed), SMALL_DENSENET)


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["densetact_depth", "densetact_force",
                                 "stforce"])
def test_sensor_net_on_card_matches_cpu(cuda_device, net):
    """Each faithful sensor net on the card against the CPU at fp32 with
    TF32 off (the nets' own guard): within 1e-4 of the output's range."""
    from touchgs_torch.touch.sensor_nets import normalize_tactile

    model = small_sensor_net(net)
    img = normalize_tactile(torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (64, 64, 3)).astype(np.float32)))
    ref = model(img)
    out = model.to(cuda_device)(img.to(cuda_device)).cpu()
    scale = float(ref.max() - ref.min())
    assert out.shape == ref.shape and scale > 0
    assert float((out - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_compact_sensor_on_card_matches_cpu(cuda_device):
    """``DenseTactSensor``'s compact nets (random from the same seed) on the
    card against the CPU: depth within 1e-4 of its range, the wrench within
    1e-5, the uint8 depth at most one level apart."""
    from touchgs_torch.touch.sensor_nets import DenseTactSensor

    img = np.random.default_rng(7).integers(0, 256, (96, 96, 3), np.uint8)
    cpu, card = DenseTactSensor(device="cpu"), DenseTactSensor()
    assert card.device.type == "cuda"
    ref, out = cpu.depth(img), card.depth(img).cpu()
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.max() - ref.min())
    assert np.abs(cpu.get_depth(img).astype(int)
                  - card.get_depth(img).astype(int)).max() <= 1
    np.testing.assert_allclose(card.get_force(img), cpu.get_force(img),
                               atol=1e-5)


@pytest.mark.cuda
def test_nerf_step_on_card_matches_cpu(cuda_device):
    """One ``NerfTrainer`` step on the card against the CPU at a small
    config, from the same parameters and pixels with the same injected
    uniforms: every metric within rtol 1e-4."""
    from touchgs_torch.models import nerf

    cfg = nerf.NerfConfig(num_levels=4, hash_size=2**12, base_res=4,
                          max_res=64, mlp_width=32, num_coarse=24,
                          num_fine=24, rays_per_batch=512, near=0.5, far=4.0)
    u = nerf.draw_uniforms(cfg, cfg.rays_per_batch,
                           torch.Generator().manual_seed(1))
    logs = {}
    for dev in ("cpu", cuda_device):
        trainer = nerf.NerfTrainer(card_scene(), cfg, device=dev)
        trainer.draw_uniforms = lambda dev=dev: tuple(a.to(dev) for a in u)
        logs[str(dev)] = trainer.run(1)
    for k, v in logs["cpu"].items():
        np.testing.assert_allclose(logs[str(cuda_device)][k], v, rtol=1e-4,
                                   err_msg=k)


def test_sensor_and_nerf_run_on_the_card_unless_asked_for_the_cpu():
    """``DenseTactSensor`` and ``NerfTrainer`` take ``cuda`` by default and
    raise without a GPU; ``device="cpu"`` runs on the CPU."""
    from touchgs_torch.models import nerf
    from touchgs_torch.touch.sensor_nets import DenseTactSensor

    cfg = nerf.NerfConfig(num_levels=2, hash_size=2**8, rays_per_batch=64)
    assert DenseTactSensor(device="cpu").device.type == "cpu"
    assert nerf.NerfTrainer(card_scene(), cfg,
                            device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert DenseTactSensor().device.type == "cuda"
        assert nerf.NerfTrainer(card_scene(), cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DenseTactSensor()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            nerf.NerfTrainer(card_scene(), cfg)


def _card_cfg(**kw):
    return TrainConfig(model=ModelConfig(
        max_gaussians=512, sh_degree=3,
        rasterize=RasterizeConfig(use_pallas=True)),
        sh_degree_interval=1, log_every=1, **kw)


@pytest.mark.cuda
def test_viewer_frame_on_card(cuda_device):
    """A live viewer on a card trainer: frames render on the server's
    thread through K1 with rows and K2 (never K3), equal the trainer's own
    render byte for byte, and the counts add up with the training's."""
    import urllib.request

    from touchgs_torch.data.png import decode_png
    from touchgs_torch.models.splatfacto import render
    from touchgs_torch.viewer import ViewerServer, orbit_c2w
    from touchgs_torch.viewer.server import frame_bytes

    trainer = Trainer(card_scene(), _card_cfg())
    with ViewerServer(trainer=trainer, port=0) as v:
        _zero_launches()
        trainer.run(2, viewer=v)
        url = v.url + "render?theta=0.3&phi=0.2&radius=2.5&w=96&h=64&mode="
        pngs = {m: urllib.request.urlopen(url + m, timeout=60).read()
                for m in ("rgb", "depth", "acc")}
        torch.cuda.synchronize()
        assert cuda_build.launches == _want(slot_rows=5, composite_fwd=5,
                                            composite_bwd=2, ssim_fwd=2,
                                            ssim_bwd=2, shade_fwd=5,
                                            shade_bwd=2)
    c2w = orbit_c2w(0.3, 0.2, 2.5)
    f = np.float32(0.8 * 96)
    cam = Camera(*(torch.tensor(np.float32(x), device=cuda_device)
                   for x in (f, f, 48, 32)),
                 c2w=torch.as_tensor(c2w, device=cuda_device), width=96,
                 height=64)
    with torch.no_grad():
        out, _ = render(trainer.state.params, cam, trainer.cfg.model,
                        active_sh_degree=3)
    host = {k: getattr(out, k).cpu().numpy() for k in ("rgb", "depth", "acc")}
    for m, png in pngs.items():
        np.testing.assert_array_equal(decode_png(png).pixels,
                                      frame_bytes(host, m), err_msg=m)


@pytest.mark.cuda
def test_two_scene_step_on_card(cuda_device):
    """A 2-scene step (one launch each of K1, K2, K3) against two single
    scene steps from the same parameters: loss rtol 1e-4, parameters atol
    1e-5."""
    import copy

    from touchgs_torch.models.densify import DensifyState
    from touchgs_torch.parallel import multiscene as ms
    from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam
    from touchgs_torch.train.trainer import TrainState, make_train_step

    cfg = _card_cfg()
    opt = FusedAdam(cfg.optim)
    scene = card_scene()
    trainers = [Trainer(scene, dataclasses.replace(cfg, seed=s))
                for s in range(2)]
    params = [t.state.params for t in trainers]
    batches = [t._batch(s) for s, t in enumerate(trainers)]
    state = ms.make_multiscene_state(copy.deepcopy(params), cfg, opt)
    _zero_launches()
    state, m = ms.make_multiscene_train_step(cfg, opt)(
        state, ms.stack_cameras([b[0] for b in batches]),
        *(torch.stack([b[i] for b in batches]) for i in (1, 2, 3)), 3)
    torch.cuda.synchronize()
    assert cuda_build.launches == _want(slot_rows=1, composite_fwd=1,
                                        composite_bwd=1, ssim_fwd=2,
                                        ssim_bwd=2)
    step = make_train_step(cfg, opt)
    for s in range(2):
        p = copy.deepcopy(params[s])
        st, sm = step(TrainState(params=p, opt_state=opt.init(
            {g: getattr(p, g) for g in PARAM_GROUPS}),
            densify=DensifyState.zeros(512, cuda_device), step=0),
            *batches[s], 3)
        np.testing.assert_allclose(float(m["loss_per_scene"][s]),
                                   float(sm["loss"]), rtol=1e-4)
        alive = st.params.alive
        for g in ("means", "sh_dc", "log_scales", "logit_opacities"):
            torch.testing.assert_close(
                getattr(ms.scene_params(state.params, s), g)[alive],
                getattr(st.params, g)[alive], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_tile_shards_on_card(cuda_device):
    """The scene's render with its 6 tiles in 4 slices (K1, K2, K3 launched
    once a slice, K1 with each slice's tile0) equals the unsharded render,
    image and gradients."""
    a = scene_arrays()
    proj = _project(a, cuda_device)
    outs = {}
    for shards in (0, 4):
        cols = torch.as_tensor(a["colors"], device=cuda_device
                               ).requires_grad_()
        op = torch.as_tensor(a["opac"], device=cuda_device).requires_grad_()
        _zero_launches()
        out = rc.rasterize_cuda(proj, cols, op, W, H, RasterizeConfig(),
                                tile_shards=shards)
        grads = torch.autograd.grad(out.rgb.square().mean(), (cols, op))
        torch.cuda.synchronize()
        n = max(shards, 1)
        assert cuda_build.launches == _want(slot_rows=n, composite_fwd=n,
                                            composite_bwd=n)
        outs[shards] = (out, grads)
    (o0, g0), (o4, g4) = outs[0], outs[4]
    for k in ("rgb", "depth", "acc"):
        torch.testing.assert_close(getattr(o4, k), getattr(o0, k), rtol=0,
                                   atol=0)
    for x, y in zip(g4, g0):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-9)


def packed_scenes(dev, n_scenes: int = 3) -> dict:
    """``rc.pack_scenes``'s grid of ``n_scenes`` views of 96x64 (each
    ``scene_arrays`` from its own seed): 6 tiles a scene."""
    projs, colors, opac = [], [], []
    for s in range(n_scenes):
        a = scene_arrays(seed=5 + s)
        projs.append(_project(a, dev))
        colors.append(torch.as_tensor(a["colors"], device=dev))
        opac.append(torch.as_tensor(a["opac"], device=dev))
    return rc.pack_scenes(projs, colors, opac, W, H, RasterizeConfig(),
                          k_tile=K_TILE, k_chunk=K_CHUNK)


def composite_slices(x: dict, shards: int) -> tuple:
    """K1 with rows, K2 and K3 on each of ``shards`` contiguous slices of
    ``pack_scenes``'s grid ``x`` (K1 with the slice's offset into the grid
    as ``tile0``, K2 and K3 with its tile ids), one launch of each a
    slice, and once on the whole grid, with one seeded cotangent.  Returns
    the slices' (gidx, rows, forward stack, per-slot gradients),
    concatenated, and the whole grid's."""
    th, tw, k_tile, k_chunk, _, _ = x["geom"]
    n = x["tile_counts"].shape[0]
    dead = x["attrs"].shape[0] - plain.DEAD_SPREAD
    capped = torch.clamp(x["tile_counts"], max=k_tile)
    gen = torch.Generator(device=capped.device)
    gen.manual_seed(3)
    cot = torch.randn((n, plain.ROWS, th * tw), generator=gen,
                      device=capped.device)

    def launch(t0, t1):
        gidx, rows = rc.slot_rows(
            x["attrs"], x["sorted_gauss"], x["tile_starts"][t0:t1].contiguous(),
            capped[t0:t1].contiguous(), t1 - t0, k_tile, dead, t0)
        tids = x["tile_ids"][t0:t1].contiguous()
        nc = torch.div(capped[t0:t1] + k_chunk - 1, k_chunk,
                       rounding_mode="floor").to(torch.int32).contiguous()
        fwd = rc.forward_tiles(nc, tids, rows, *x["geom"])
        done = fwd[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
        d = rc.backward_tiles(done, tids, rows, fwd,
                              cot[t0:t1].contiguous(), *x["geom"])
        return gidx, rows, fwd, d

    per = -(-n // shards)
    parts = [launch(t0, min(t0 + per, n)) for t0 in range(0, n, per)]
    return tuple(torch.cat(p) for p in zip(*parts)), launch(0, n)


def assert_slices_equal_whole(sliced, whole) -> None:
    """K1's lists and rows and K3's gradients bit for bit; K2's rows within
    rgb/acc 3e-5 and depth 3e-4, its T and chunk rows equal."""
    (gidx, rows, fwd, d), (gidx0, rows0, fwd0, d0) = sliced, whole
    assert torch.equal(gidx, gidx0) and torch.equal(rows, rows0)
    assert torch.equal(fwd[:, plain.ROW_DONE], fwd0[:, plain.ROW_DONE])
    assert torch.equal(fwd[:, plain.ROW_T], fwd0[:, plain.ROW_T])
    sel = [0, 1, 2, 4, 5]
    torch.testing.assert_close(fwd[:, sel], fwd0[:, sel], rtol=0, atol=3e-5)
    torch.testing.assert_close(fwd[:, 3], fwd0[:, 3], rtol=0, atol=3e-4)
    assert torch.equal(d, d0)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_packed_grid_slices_on_card(cuda_device, shards):
    """The packed grid of 3 scenes (18 tiles) cut into 2 and 4 contiguous
    slices, each composited through one launch of K1 (its ``tile0``), K2
    and K3, equals one launch on the whole grid: K1 and K3 bit-equal, K2
    within its tolerance.  This is what each ``model`` rank of a
    multi-scene mesh runs on its slice."""
    x = packed_scenes(cuda_device)
    _zero_launches()
    sliced, whole = composite_slices(x, shards)
    torch.cuda.synchronize()
    assert cuda_build.launches == _want(slot_rows=shards + 1,
                                        composite_fwd=shards + 1,
                                        composite_bwd=shards + 1)
    assert float(whole[2][:, plain.ROW_DONE].max()) > 0
    assert_slices_equal_whole(sliced, whole)


@pytest.mark.cuda
def test_nccl_world_of_one(cuda_device):
    """The sharded step in a NCCL world of one against the unsharded step
    from the same state: loss rtol 1e-4, parameters atol 1e-5."""
    import copy
    import socket

    from touchgs_torch.parallel.distributed import init_distributed
    from touchgs_torch.parallel.mesh import make_mesh
    from touchgs_torch.parallel.sharded import (gather_state,
                                                make_sharded_train_step,
                                                shard_state)
    from touchgs_torch.train.trainer import make_train_step

    cfg = _card_cfg()
    trainer = Trainer(card_scene(), cfg)
    batch = (*trainer._batch(0), 3)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert init_distributed(f"127.0.0.1:{port}", 1, 0) is False
    try:
        mesh = make_mesh()
        assert mesh.size == 1 and mesh.group is not None
        assert torch.distributed.get_backend() == "nccl"
        ref, rm = make_train_step(cfg, trainer.optimizer)(
            copy.deepcopy(trainer.state), *batch)
        st, m = make_sharded_train_step(cfg, mesh, trainer.optimizer)(
            shard_state(copy.deepcopy(trainer.state), mesh), *batch)
        full = gather_state(st, mesh)
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-4)
    alive = ref.params.alive
    for g in ("means", "sh_dc"):
        torch.testing.assert_close(getattr(full.params, g)[alive],
                                   getattr(ref.params, g)[alive], rtol=0,
                                   atol=1e-5)


def same_step(name: str, loss, ref_loss, params, ref_params, optim) -> None:
    """One step against another at the JAX package's 1-vs-N tolerances:
    loss rtol 1e-4, parameters atol 1e-5 on the live slots.  An entry whose
    gradient is float32 noise about 0 moves by a whole Adam step of its
    sign (ROADMAP.md C32), so those are held as a share: at most 0.1% of a
    group's entries, none more than two steps apart."""
    from touchgs_torch.train.optim import PARAM_GROUPS

    lrs = {"means": optim.means_lr_init, "quats": optim.quats_lr,
           "log_scales": optim.scales_lr,
           "logit_opacities": optim.opacities_lr,
           "sh_dc": optim.features_dc_lr, "sh_rest": optim.features_rest_lr}
    loss, ref_loss = float(loss), float(ref_loss)
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss), (name, loss,
                                                          ref_loss)
    alive = ref_params.alive
    assert torch.equal(params.alive, alive), f"{name}: alive masks differ"
    for g in PARAM_GROUPS:
        d = (getattr(params, g)[alive] - getattr(ref_params, g)[alive]).abs()
        if d.numel() == 0:
            continue
        share = float((d > 1e-5).float().mean())
        assert share <= 1e-3 and float(d.max()) <= 2 * lrs[g] + 1e-5, (
            f"{name}: {g} {share:.4%} of the entries more than 1e-5 apart, "
            f"at most {float(d.max()):.3e}")


@pytest.mark.cuda
def test_multiscene_mesh_world_of_one(cuda_device):
    """A 2-scene step on a data=1, model=1 mesh in a NCCL world of one (the
    gathers through NCCL) against the unsharded batch from the same state:
    one launch each of K1, K2 and K3, losses and PSNRs rtol 1e-5, live
    parameters as ``same_step`` holds them (atol 1e-5, an entry
    moved by Adam on float32 noise held as a share, ROADMAP C32); then the
    refine and the opacity reset of the batch's stepped state, on the mesh
    and unsharded, bit for bit."""
    import copy
    import socket

    from touchgs_torch.parallel import multiscene as ms
    from touchgs_torch.parallel.distributed import init_distributed
    from touchgs_torch.parallel.mesh import make_mesh
    from touchgs_torch.train.optim import FusedAdam

    cfg = _card_cfg()
    opt = FusedAdam(cfg.optim)
    trainers = [Trainer(card_scene(), dataclasses.replace(cfg, seed=s))
                for s in range(2)]
    batches = [t._batch(s) for s, t in enumerate(trainers)]
    batch = (ms.stack_cameras([b[0] for b in batches]),
             *(torch.stack([b[i] for b in batches]) for i in (1, 2, 3)), 3)
    state0 = ms.make_multiscene_state([t.state.params for t in trainers],
                                      cfg, opt)
    meshes = {"batch": None}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert init_distributed(f"127.0.0.1:{port}", 1, 0) is False
    try:
        meshes["mesh"] = mesh = make_mesh(data=1, model=1)
        assert mesh.axis("model").group is not None
        assert mesh.axis("data").group is not None

        def placed(state, m):
            state = copy.deepcopy(state)
            return state if m is None else ms.shard_multiscene_state(state, m)

        def whole(state, m):
            return state if m is None else ms.gather_multiscene_state(state,
                                                                      m)

        stepped, refined = {}, {}
        for name, m in meshes.items():
            _zero_launches()
            state, metrics = ms.make_multiscene_train_step(cfg, opt, m)(
                placed(state0, m), *batch)
            torch.cuda.synchronize()
            assert cuda_build.launches == _want(slot_rows=1, composite_fwd=1,
                                                composite_bwd=1, ssim_fwd=2,
                                                ssim_bwd=2)
            stepped[name] = (whole(state, m), metrics)
        for name, m in meshes.items():
            state = ms.make_multiscene_refine_step(cfg, m)(
                placed(stepped["batch"][0], m),
                ms.scene_generators(0, 2, cuda_device))
            refined[name] = whole(
                ms.make_multiscene_reset_opacity_step(cfg)(state), m)
    finally:
        torch.distributed.destroy_process_group()
    (ref, rm), (got, gm) = stepped["batch"], stepped["mesh"]
    for k in rm:
        torch.testing.assert_close(gm[k], rm[k], rtol=1e-5, atol=0, msg=k)
    for s in range(2):
        same_step(f"scene {s}", gm["loss_per_scene"][s],
                  rm["loss_per_scene"][s], ms.scene_params(got.params, s),
                  ms.scene_params(ref.params, s), cfg.optim)
    alive = ref.params.alive
    ref, got = refined["batch"], refined["mesh"]
    assert not torch.equal(ref.params.alive, alive), "the refine did nothing"
    pairs = [(f.name, getattr(got.params, f.name),
              getattr(ref.params, f.name))
             for f in dataclasses.fields(ref.params)]
    pairs += [(f"mu.{k}", got.opt_state.mu[k], v)
              for k, v in ref.opt_state.mu.items()]
    for name, a, b in pairs:  # NaN where both have it: dead slots
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=name)


@pytest.mark.cuda
def test_sim_capture_through_sensor_loop_on_card(cuda_device, tmp_path):
    """The port-built ``tgs_sync_capture --sim 1`` takes 8 frames at 20 Hz
    into ``capture/`` (``poses.csv`` with its header and a row each), and
    ``imgs_cam0/`` replays through ``DirectorySource`` and ``SensorLoop``
    with the compact nets on the card: every frame processed, the last
    frame's depth and wrench within 1e-4 of the CPU's range.  Skips where
    the native layer cannot be built."""
    import subprocess

    from touchgs_torch.native import loader
    from touchgs_torch.touch.sensor_loop import DirectorySource, SensorLoop
    from touchgs_torch.touch.sensor_nets import DenseTactSensor

    missing = loader.missing_prerequisites()
    if missing:
        pytest.skip(f"the native layer needs {missing}")
    frames, cap = 8, tmp_path / "capture"
    r = subprocess.run(
        [str(loader.tool("tgs_sync_capture")), "--out", str(cap), "--sim",
         "1", "--auto-capture", str(frames), "--rate-hz", "20.0"],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-300:]
    rows = (cap / "poses.csv").read_text().splitlines()
    assert rows[0] == "index,frame,x,y,z,qx,qy,qz,qw,stamp"
    assert len(rows) == frames + 1
    results = {}
    sensor = DenseTactSensor(device=cuda_device)
    loop = SensorLoop(sensor=sensor, rate_hz=30.0,
                      on_frame=lambda i, res: results.__setitem__(i, res))
    assert loop.run(DirectorySource(cap / "imgs_cam0")) == frames
    assert sorted(results) == list(range(frames))
    last = results[frames - 1]
    cpu = DenseTactSensor(device="cpu")
    ref_depth = cpu.depth(last["rect"])
    ref_force = cpu.get_force(last["rect"])
    depth = sensor.depth(last["rect"]).cpu()
    assert float((depth - ref_depth).abs().max()) <= 1e-4 * float(
        ref_depth.max() - ref_depth.min())
    assert np.abs(last["force"] - ref_force).max() <= 1e-4 * np.ptp(
        ref_force)


@pytest.mark.cuda
@pytest.mark.parametrize("k_tile", [128, 512])
def test_bench_census_on_card_matches_plain(cuda_device, k_tile):
    """``bench_torch.py``'s state at 96x64 (300 Gaussians in 1024) after 3
    steps through K1-K3 on the card: the roofline report's census (K1 with
    rows and K2 on the card) equals the census of the same bins and
    attributes through the plain versions on the CPU, and so does every
    tile's chunks_done."""
    import bench_torch
    from touchgs_torch.ops.tiles import TileBins

    cfg, state, step, *batch = bench_torch.build_state_and_step(
        cuda_device, W, H, N, 1024)
    assert cfg.model.rasterize.use_pallas
    for _ in range(3):
        state, metrics = step(state, *batch, 3)
    assert np.isfinite(float(metrics["loss"]))
    rcfg = dataclasses.replace(cfg.model.rasterize, k_tile=k_tile)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rasterize=rcfg))
    before = dict(cuda_build.launches)
    got = bench_torch.census(cfg, state, batch[0])
    assert cuda_build.launches["slot_rows"] == before["slot_rows"] + 1
    assert cuda_build.launches["composite_fwd"] == before["composite_fwd"] + 1
    bins = got["x"]["bins"]
    cpu_bins = TileBins(*(t.cpu() for t in bins[:3]), bins.n_tiles_x,
                        bins.n_tiles_y)
    want = bench_torch.tile_census(rcfg, cpu_bins,
                                   got["x"]["k1_args"][0].cpu())
    keys = ("total", "kept", "scanned", "lossy", "distinct")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert torch.equal(got["x"]["done"].cpu(), want["x"]["done"])


def _graph_trainer() -> Trainer:
    trainer = Trainer(card_scene(), _card_cfg())
    assert isinstance(trainer.train_step, GraphedStep)
    return trainer


def _counts_since(before: dict, now: dict) -> dict:
    return {k: now[k] - before[k] for k in now}


@pytest.mark.cuda
def test_graphed_step_matches_eager(cuda_device):
    """5 steps of the graphed step against 5 of its ``__wrapped__`` from
    copies of one state, on the same views: loss and PSNR within rtol
    1e-3.  One capture; over the replays K1 with rows, K2 and K3 count
    exactly 5 launches each, as the eager steps do, and the warm-up's
    launches (``WARMUP_ITERS`` steps on a clone) are counted apart."""
    import copy

    trainer = _graph_trainer()
    step = trainer.train_step
    logs, counts = {}, {}
    warm0 = dict(cuda_build.launches_warmup)
    for name, fn in (("eager", step.__wrapped__), ("graph", step)):
        state = copy.deepcopy(trainer.state)
        _zero_launches()
        logs[name] = []
        for i in range(5):
            state, m = fn(state, *trainer._batch(i % 2), 3)
            logs[name].append((float(m["loss"]), float(m["psnr"])))
        torch.cuda.synchronize()
        counts[name] = dict(cuda_build.launches)
        assert state.step == 5
    want = _want(**dict.fromkeys(TRAIN_PATH, 5))
    assert counts == {"eager": want, "graph": want}, counts
    assert trainer.events["capture"] == 1 and len(step.graphs) == 1
    w = graphs.WARMUP_ITERS
    assert _counts_since(warm0, cuda_build.launches_warmup) == _want(
        **dict.fromkeys(TRAIN_PATH, w))
    assert np.isfinite(logs["graph"]).all()
    np.testing.assert_allclose(logs["graph"], logs["eager"], rtol=1e-3)


def _stage_scene(n_views=2, w=384, h=256, n=40_000) -> Scene:
    """``n_views`` random ``w``x``h`` views of ``n`` seeds: a step of a
    few milliseconds, so that a graph launch's fixed cost is a small part
    of it."""
    rng = np.random.default_rng(1)
    c2w = np.stack([look_at_c2w((2.0 * np.cos(t), 0.6, 2.0 * np.sin(t)))
                    for t in np.linspace(0.4, 1.2, n_views)])
    f = np.full(n_views, 300.0, np.float32)
    cams = Cameras(fx=f, fy=f.copy(), cx=np.full(n_views, w / 2, np.float32),
                   cy=np.full(n_views, h / 2, np.float32), c2w=c2w, width=w,
                   height=h)
    return Scene(
        cameras=cams,
        images=rng.uniform(0, 1, (n_views, h, w, 3)).astype(np.float32),
        depths=rng.uniform(1.5, 3.0, (n_views, h, w)).astype(np.float32),
        uncertainties=None, i_train=np.arange(n_views),
        i_eval=np.array([], int),
        seed_points=rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        seed_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        scale_factor=1.0, transform=np.eye(4)[:3], name="stages")


@pytest.mark.cuda
def test_graphed_stages_add_up_to_the_replay(cuda_device):
    """The stage intervals that a replay's own event nodes record
    (``telemetry.StageEvents``) come in ``telemetry.STAGES``' order and
    add up to the replay's time between CUDA events around
    ``graph.replay()`` within 2% (median of 20 replays)."""
    cfg = TrainConfig(model=ModelConfig(
        max_gaussians=131072, sh_degree=3,
        rasterize=RasterizeConfig(use_pallas=True)),
        sh_degree_interval=1, log_every=1)
    trainer = Trainer(_stage_scene(), cfg)
    step = trainer.train_step
    state, _ = step(trainer.state, *trainer._batch(0), 3)
    (g,) = step.graphs.values()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ratios = []
    for _ in range(20):
        a.record()
        g.graph.replay()
        b.record()
        b.synchronize()
        stages = g.stages.ms()
        assert list(stages) == list(telemetry.STAGES), stages
        assert all(ms > 0 for ms in stages.values()), stages
        ratios.append(sum(stages.values()) / a.elapsed_time(b))
    assert abs(float(np.median(ratios)) - 1.0) <= 0.02, ratios


@pytest.mark.cuda
def test_graphed_nested_stage_and_tile_lists(cuda_device):
    """The replay's ``raster_bwd`` event (set by a gradient hook on the
    autograd device thread during the capture) lies inside the loss and
    backward stages; the graph's tile lists are its replays' counts: the
    entries the account takes at a log point equal the eager binning's of
    the same view and state, and a ``Trainer.run`` log point reads no more
    than the schedule's reads."""
    import copy

    from touchgs_torch.models.splatfacto import shade

    trainer = _graph_trainer()
    step = trainer.train_step
    batch = trainer._batch(0)
    before = copy.deepcopy(trainer.state)
    state, _ = step(trainer.state, *batch, 0)    # capture and one replay
    torch.cuda.synchronize()
    (g,) = step.graphs.values()
    ms, nested = g.stages.ms(), g.stages.nested_ms()
    assert list(ms) == list(telemetry.STAGES) and set(nested) == {
        "raster_bwd"}, (ms, nested)
    assert 0 < nested["raster_bwd"] < ms["loss"] + ms["backward"], nested
    lists = step.take_tile_lists()
    assert lists is g.tiles and step.take_tile_lists() is None
    # the replay binned the state it was given
    with torch.no_grad():
        proj, *_ = shade(before.params, batch[0], trainer.cfg.model, 0)
        bins = bin_gaussians(proj, batch[0].width, batch[0].height,
                             trainer.cfg.model.rasterize)
    assert torch.equal(lists.counts, bins.tile_counts)
    assert int(lists.entries()) == int(torch.clamp(
        bins.tile_counts, max=lists.k_tile).sum())
    ev = trainer.events
    reads, samples, caps = ev["host_reads"], ev["tile_samples"], ev["capture"]
    trainer.run(state.step + 3)                  # log_every 1: 3 log points
    assert ev["tile_samples"] == samples + 3, ev
    assert ev["nested_raster_bwd_ms"] > 0, ev
    # each log point: the metrics and the guard's read, which carries the
    # tile lists; each capture (a new SH degree) its drain
    assert ev["host_reads"] - reads == (3 * (len(g.metrics) + 1)
                                        + ev["capture"] - caps), ev


@pytest.mark.cuda
def test_capture_ms_once_per_capture(cuda_device):
    """Each capture adds its host milliseconds (warm-ups and capture) to
    ``events["capture_ms"]`` once, after one drain of the stream counted
    in ``host_reads``; replays add neither.  A ``Trainer.run`` on the card
    takes one stage sample at each log point."""
    trainer = _graph_trainer()
    ev, step = trainer.events, trainer.train_step
    state, batch = trainer.state, trainer._batch(0)
    seen = []
    for sh in (0, 0, 1, 1):
        state, _ = step(state, *batch, sh)
        seen.append((ev["capture"], ev["capture_ms"], ev["host_reads"]))
    torch.cuda.synchronize()
    (c, ms, reads) = zip(*seen)
    assert c == (1, 1, 2, 2) and reads == (1, 1, 2, 2), seen
    assert 0 < ms[0] == ms[1] < ms[2] == ms[3], seen
    samples = ev["stage_samples"]
    trainer.run(state.step + 3)                  # log_every 1
    assert ev["stage_samples"] == samples + 3, ev
    assert all(ev[f"stage_{s}_ms"] > 0 for s in telemetry.STAGES), ev


@pytest.mark.cuda
def test_graphed_step_recaptures_on_a_new_key(cuda_device):
    """A new active SH degree, a new k_tile (a new step) and a capacity
    growth each capture once; a return to an SH degree replays its graph,
    and a refine and an opacity reset, written into the state's tensors,
    cost no capture and are seen by the next replay (its loss equals an
    eager step's from a copy, rtol 1e-3)."""
    import copy

    trainer = _graph_trainer()
    cfg, opt = trainer.cfg, trainer.optimizer
    events = {}
    step = make_train_step(cfg, opt, events=events)
    state, batch = trainer.state, trainer._batch(0)
    for sh, captures in ((0, 1), (0, 1), (1, 2), (0, 2), (1, 2)):
        state, m = step(state, *batch, sh)
        assert events["capture"] == captures, (sh, events)
    state = refine_state(state, cfg, generator=trainer.generator)
    state = reset_opacity_state(state, cfg)
    ref = copy.deepcopy(state)
    state, m = step(state, *batch, 1)
    _, m_ref = step.__wrapped__(ref, *batch, 1)
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                               rtol=1e-3)
    assert events["capture"] == 2
    wide = make_train_step(cfg, opt, k_tile=256, events=events)
    state, m = wide(state, *batch, 1)
    assert events["capture"] == 3
    state = grow_state(state, 2 * state.params.capacity)
    for _ in range(2):
        state, m = wide(state, *batch, 1)
    assert events["capture"] == 4 and len(wide.graphs) == 1
    assert np.isfinite(float(m["loss"])) and state.step == 9


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device, monkeypatch):
    """A step that reads a value to the host cannot be captured: the call
    raises, nothing runs eagerly in its place, and the state is as it
    was."""
    import copy

    from touchgs_torch.train import trainer as tr

    trainer = _graph_trainer()
    losses = tr.compute_losses

    def reading(*args, **kw):
        out = losses(*args, **kw)
        float(out.total)           # a sync: not allowed under capture
        return out

    monkeypatch.setattr(tr, "compute_losses", reading)
    step = make_train_step(trainer.cfg, trainer.optimizer)
    before = copy.deepcopy(trainer.state)
    _zero_launches()
    with pytest.raises(RuntimeError):
        step(trainer.state, *trainer._batch(0), 3)
    torch.cuda.synchronize()
    assert trainer.state.step == before.step == 0
    assert not step.graphs and step.events["capture"] == 0
    assert not any(cuda_build.launches.values()), cuda_build.launches
    for a, b in zip(graphs.state_tensors(trainer.state),
                    graphs.state_tensors(before)):
        assert torch.equal(a, b)


# ---- the other graphed steps (pose, tile_shards, sharded, multi-scene) ----

def _same_tensors(a: list, b: list) -> bool:
    """Every pair equal, NaN where NaN (the dead slots' quaternions)."""
    return all(x.shape == y.shape and bool(((x == y) | (x.isnan()
                                                        & y.isnan())).all())
               for x, y in zip(a, b))


def _graph_against_eager(step, state, batches: list, between=None) -> dict:
    """len(batches) steps of the graphed ``step`` and as many of its
    ``__wrapped__`` from copies of ``state``, ``between(i, state)`` (a
    refine, a reset) after step i on each side, the launch counters set to
    0 before each side: the losses, the final states and the counts."""
    import copy

    out = {}
    for name, fn in (("eager", step.__wrapped__), ("graph", step)):
        st = copy.deepcopy(state)
        _zero_launches()
        losses = []
        for i, batch in enumerate(batches):
            st, m = fn(st, *batch)
            losses.append(float(m["loss"]))
            if between is not None:
                st = between(i, st)
        torch.cuda.synchronize()
        out[name] = (losses, st, dict(cuda_build.launches))
    return out


def _check_graph_against_eager(out: dict, n_launches: int, n_losses: int,
                               n_shades: int) -> None:
    """``n_launches`` of each of K1 with rows, K2 and K3, ``n_losses`` of
    each SSIM kernel (one a scene a step) and ``n_shades`` of each shade
    kernel (one a step where ``render`` shades on the card) on each
    side."""
    (el, es, ec), (gl, gs, gc) = out["eager"], out["graph"]
    assert np.isfinite(gl).all()
    np.testing.assert_allclose(gl, el, rtol=1e-3)
    assert _same_tensors(graphs.state_tensors(gs), graphs.state_tensors(es))
    want = _want(slot_rows=n_launches, composite_fwd=n_launches,
                 composite_bwd=n_launches, ssim_fwd=n_losses,
                 ssim_bwd=n_losses, shade_fwd=n_shades, shade_bwd=n_shades)
    assert ec == want and gc == want, (ec, gc)


def _pose_trainer() -> Trainer:
    from touchgs_torch.config import PoseOptConfig

    trainer = Trainer(card_scene(3), _card_cfg(
        pose_opt=PoseOptConfig(mode="SO3xR3")))
    assert isinstance(trainer.train_step, GraphedStep)
    return trainer


@pytest.mark.cuda
def test_graphed_pose_step_one_capture_for_three_views(cuda_device):
    """The SO3xR3 step graphed against its ``__wrapped__`` over 5 steps on
    views 0, 1, 2, 0, 1 (each a device index): losses rtol 1e-3, every
    state tensor (the pose deltas too) equal, 5 launches each of K1 with
    rows, K2 and K3 and none of the shade kernels (the camera takes a
    gradient, so ``render`` runs the op chain); one capture serves the
    three views."""
    trainer = _pose_trainer()
    step = trainer.train_step
    batches = [(*trainer._batch(v), 3, trainer.view_index(v))
               for v in (0, 1, 2, 0, 1)]
    out = _graph_against_eager(step, trainer.state, batches)
    _check_graph_against_eager(out, 5, 5, 0)
    assert step.events["capture"] == 1 and len(step.graphs) == 1
    assert float(out["graph"][1].pose_deltas.abs().max()) > 0


@pytest.mark.cuda
def test_graphed_tile_shards_step_matches_eager(cuda_device):
    """``make_train_step(..., tile_shards=4)`` graphed against its
    ``__wrapped__`` over 5 steps: losses rtol 1e-3, every state tensor
    equal, K1-K3 launched once a slice a step; one capture."""
    trainer = Trainer(card_scene(), _card_cfg())
    events: dict = {}
    step = make_train_step(trainer.cfg, trainer.optimizer, tile_shards=4,
                           events=events)
    assert isinstance(step, GraphedStep)
    batches = [(*trainer._batch(i % 2), 3) for i in range(5)]
    _check_graph_against_eager(
        _graph_against_eager(step, trainer.state, batches), 4 * 5, 5, 5)
    assert events["capture"] == 1


def _two_scenes(cfg):
    import copy

    from touchgs_torch.parallel import multiscene as ms

    trainers = [Trainer(card_scene(), dataclasses.replace(cfg, seed=s))
                for s in range(2)]
    state = ms.make_multiscene_state(
        [copy.deepcopy(t.state.params) for t in trainers], cfg,
        trainers[0].optimizer)

    def batch(i):
        views = [trainers[s]._batch((i + s) % 2) for s in range(2)]
        return (ms.stack_cameras([b[0] for b in views]),
                *(torch.stack([b[k] for b in views]) for k in (1, 2, 3)), 3)

    return trainers[0].optimizer, state, [batch(i) for i in range(5)]


@pytest.mark.cuda
def test_graphed_multiscene_step_refine_and_reset(cuda_device):
    """The 2-scene step graphed against its ``__wrapped__`` over 5 steps
    with a refine after step 2 and an opacity reset after step 3 on each
    side (each scene's generator seeded alike): losses rtol 1e-3, every
    state tensor equal, one launch each of K1-K3 a step; the refine and
    the reset write into the state's tensors and cost no capture."""
    from touchgs_torch.parallel import multiscene as ms

    cfg = _card_cfg()
    opt, state, batches = _two_scenes(cfg)
    step = ms.make_multiscene_train_step(cfg, opt)
    refine = ms.make_multiscene_refine_step(cfg)
    reset = ms.make_multiscene_reset_opacity_step(cfg)

    def between(i, st):
        ptrs = [t.data_ptr() for t in graphs.state_tensors(st)]
        if i == 2:
            st = refine(st, ms.scene_generators(3, 2, cuda_device))
        if i == 3:
            st = reset(st)
        assert [t.data_ptr() for t in graphs.state_tensors(st)] == ptrs
        return st

    out = _graph_against_eager(step, state, batches, between)
    _check_graph_against_eager(out, 5, 2 * 5, 0)
    assert step.events["capture"] == 1 and len(step.graphs) == 1


@pytest.mark.cuda
def test_graphed_mesh_and_sharded_steps_in_nccl_world_of_one(cuda_device):
    """In a NCCL world of one, the sharded step and the 2-scene step on a
    data=1, model=1 mesh, each graphed (the gathers, reduce-scatters and
    sums captured) against its ``__wrapped__`` over 5 steps: losses rtol
    1e-3, every state tensor equal, one capture each."""
    import socket

    from touchgs_torch.parallel import multiscene as ms
    from touchgs_torch.parallel.distributed import init_distributed
    from touchgs_torch.parallel.mesh import make_mesh
    from touchgs_torch.parallel.sharded import (make_sharded_train_step,
                                                shard_state)

    cfg = _card_cfg()
    trainer = Trainer(card_scene(), cfg)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert init_distributed(f"127.0.0.1:{port}", 1, 0) is False
    try:
        mesh = make_mesh(data=1, model=1)
        assert torch.distributed.get_backend() == "nccl"
        assert mesh.group is not None
        step = make_sharded_train_step(cfg, mesh, trainer.optimizer)
        batches = [(*trainer._batch(i % 2), 3) for i in range(5)]
        _check_graph_against_eager(_graph_against_eager(
            step, shard_state(trainer.state, mesh), batches), 5, 5, 5)
        assert step.events["capture"] == 1
        opt, state, batches = _two_scenes(cfg)
        step = ms.make_multiscene_train_step(cfg, opt, mesh)
        _check_graph_against_eager(_graph_against_eager(
            step, ms.shard_multiscene_state(state, mesh), batches), 5, 2 * 5,
            0)
        assert step.events["capture"] == 1
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_failed_multiscene_capture_raises(cuda_device, monkeypatch):
    """A multi-scene step that reads a value to the host cannot be
    captured: the call raises, nothing runs eagerly in its place, and the
    state is as it was."""
    import copy

    from touchgs_torch.parallel import multiscene as ms

    cfg = _card_cfg()
    opt, state, batches = _two_scenes(cfg)
    losses = ms.compute_losses

    def reading(*args, **kw):
        out = losses(*args, **kw)
        float(out.total)           # a sync: not allowed under capture
        return out

    monkeypatch.setattr(ms, "compute_losses", reading)
    step = ms.make_multiscene_train_step(cfg, opt)
    before = copy.deepcopy(state)
    _zero_launches()
    with pytest.raises(RuntimeError):
        step(state, *batches[0])
    torch.cuda.synchronize()
    assert state.step == before.step == 0
    assert not step.graphs and step.events["capture"] == 0
    assert not any(cuda_build.launches.values()), cuda_build.launches
    assert _same_tensors(graphs.state_tensors(state),
                         graphs.state_tensors(before))


# ---- the trainer's paths, the tools and the sensor stack on the card -----

@pytest.mark.cuda
def test_scan_path_on_card(cuda_device):
    """The scan path (the default ``RasterizeConfig``, torch ops, no kernel
    of its own) on the card: the scene's forward within rgb/acc 1e-4 and
    depth 1e-3 of the dense oracle and of the tile kernels without their
    exit (the same lists); ``Trainer.run`` with the default config
    launches no tile or shade kernel, the SSIM pair once a step, and
    reports no lossy tiles."""
    from touchgs_torch.ops.rasterize_tiled import rasterize_tiled

    a = scene_arrays()
    proj = _project(a, cuda_device)
    cols, op = (torch.as_tensor(a[k], device=cuda_device)
                for k in ("colors", "opac"))
    cfg = RasterizeConfig()
    assert not cfg.use_pallas
    with torch.no_grad():
        out = rasterize_tiled(proj, cols, op, W, H, cfg, k_tile=K_TILE)
        refs = {"dense": rasterize_dense(proj, cols, op, W, H, cfg),
                "tile kernels": rc.rasterize_cuda(
                    proj, cols, op, W, H, cfg, k_tile=K_TILE,
                    early_exit=False)}
    assert float(out.acc.max()) > 0.5
    for ref_name, ref in refs.items():
        for name, tol in (("rgb", 1e-4), ("acc", 1e-4), ("depth", 1e-3)):
            err = float((getattr(out, name) - getattr(ref, name)).abs().max())
            assert err <= tol, (ref_name, name, err)

    steps = 3
    trainer = Trainer(card_scene(), TrainConfig(
        model=ModelConfig(max_gaussians=512, sh_degree=3), log_every=1))
    assert trainer.device.type == "cuda"
    _zero_launches()
    trainer.run(steps)
    torch.cuda.synchronize()
    assert cuda_build.launches == _want(ssim_fwd=steps, ssim_bwd=steps)
    assert all(np.isfinite(m["loss"]) and "lossy_tiles" not in m
               for m in trainer.history)


@pytest.mark.cuda
def test_scale_demo_on_card(cuda_device, tmp_path, monkeypatch):
    """``train_scale_demo.main`` at 800x800 with its 100k GT Gaussians on a
    short schedule: 2048 seeds start the capacity at 4096, refines from
    step 300 to 620 densify and prune, the opacities reset at 450, and a
    refine grows the capacity when more than 60% of it is alive.  The
    trainer counts at least two refines, a reset and a growth; every
    kernel of the step launches; the GT renders are lossless and the
    eval metrics and the census finite."""
    from touchgs_torch.tools import train_scale_demo

    monkeypatch.chdir(tmp_path)
    _zero_launches()
    s = train_scale_demo.main([
        "--steps", "720", "--polish", "100", "--seed-points", "2048",
        "--reset-opacity-every", "450", "--views", "8", "--render-dir", ""])
    torch.cuda.synchronize()
    ev = s["events"]
    assert ev["refine"] >= 2 and ev["reset_opacity"] >= 1 and ev["grow"] >= 1
    assert all(cuda_build.launches[k] >= 1 for k in TRAIN_PATH), (
        cuda_build.launches)
    assert all(np.isfinite(v) for v in s["eval"].values())
    assert np.isfinite(s["eval_depth_mae_m"])
    assert all(np.isfinite(v) for row in s["lossy_census"]["train"]
               for v in row)
    gt = s["lossy_census"]["gt_views"]
    assert gt and gt == [0] * len(gt)


@pytest.mark.cuda
def test_touch_maps_on_card_match_cpu(cuda_device):
    """The touch modules on the card against the CPU on the same inputs:
    ``fuse_view`` on a 400x400 view with an injected permutation (atol
    1e-5); the GPIS fitted on each from 512 contacts on the 0.5 m sphere
    (posterior mean within 2e-4 and variance within 1e-3 over 4096
    queries, the fp32 Cholesky's spread, ROADMAP C14); ``render_depth_var``
    of the CPU's fit at 96x96 on each (depth within 1e-4 m where both are
    valid, validity flips at most 0.1%).  Catches TF32 and cuSOLVER
    drift."""
    from touchgs_torch.tools.train_scale_demo import look_at_camera
    from touchgs_torch.touch.fusion import fuse_view
    from touchgs_torch.touch.gpis import (fit_gpis, gpis_from_numpy,
                                          posterior, render_depth_var)

    cpu, n = torch.device("cpu"), 400
    rng = np.random.default_rng(0)
    vision = rng.uniform(0.5, 3.0, (n, n))
    touch = np.zeros((n, n))
    touch[100:260, 150:300] = rng.uniform(0.8, 1.2, (160, 150))
    sig = np.where(touch > 0, rng.uniform(1e-4, 0.5, (n, n)), 0.0)
    grounded = 1.5 * vision + 0.3 + rng.normal(0, 0.01, (n, n))
    perm = torch.randperm(n * n, generator=torch.Generator().manual_seed(1))
    maps = [a.astype(np.float32) for a in (grounded, touch, vision, sig)]
    ref, out = (fuse_view(None, *(torch.as_tensor(a, device=d)
                                  for a in maps), perm=perm)
                for d in (cpu, cuda_device))
    for k in ref._fields:
        err = float((getattr(out, k).cpu() - getattr(ref, k)).abs().max())
        assert err <= 1e-5, (k, err)

    v = np.random.default_rng(3).normal(size=(512, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    g_cpu, g_dev = (fit_gpis((0.5 * v).astype(np.float32),
                             v.astype(np.float32), lengthscale=0.18,
                             off_surface_eps=0.05, device=d)
                    for d in (cpu, cuda_device))
    q = torch.as_tensor(np.random.default_rng(4).uniform(
        -0.7, 0.7, (4096, 3)).astype(np.float32))
    m_c, v_c = posterior(g_cpu, q)
    m_d, v_d = posterior(g_dev, q.to(cuda_device))
    assert float((m_d.cpu() - m_c).abs().max()) <= 2e-4
    assert float((v_d.cpu() - v_c).abs().max()) <= 1e-3

    m, res = 96, []
    for d in (cpu, cuda_device):
        g = gpis_from_numpy(g_cpu.X, g_cpu.alpha, g_cpu.L,
                            g_cpu.lengthscale, g_cpu.signal_var,
                            g_cpu.noise, off_eps=g_cpu.off_eps, device=d)
        cam = look_at_camera(eye=(2.2, 0.0, 0.8), target=(0, 0, -0.1),
                             width=m, height=m, focal=0.9 * m, device=d)
        dep, _ = render_depth_var(g, cam, near=1.3, far=2.8, n_samples=96,
                                  pixel_chunk=1024, support_var_frac=0.15)
        res.append(dep.cpu().numpy())
    c, g = res
    both = ~np.isnan(c) & ~np.isnan(g)
    assert both.sum() > 100 and np.abs(g - c)[both].max() <= 1e-4
    assert (np.isnan(c) != np.isnan(g)).mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("lossless", [False, True], ids=["train", "gt"])
def test_hard_scene_view_kernels_match_plain(cuda_device, lossless):
    """K1 with rows, K2 and K3 against their plain versions on the hard
    scene's own tiles (its GT Gaussians through its first ring camera at
    400x400: 13x13 tiles, the last row and column partial and holding
    splats) at the training path's k_tile and the GT renders' deep one
    (``lossless_gt_raster``): K1's lists and rows equal, K2's chunks_done
    and T row equal with rgb/acc within 3e-5 and depth within 3e-4, K3
    bit-exact on a seeded random cotangent."""
    from touchgs_torch.tools.train_hard_scene import N_SPHERE
    from touchgs_torch.tools.train_scale_demo import (build_gt_gaussians,
                                                      lossless_gt_raster,
                                                      ring_cameras)

    dev, size = cuda_device, 400
    means, quats, scales, colors, opac = (
        torch.as_tensor(a, device=dev) for a in build_gt_gaussians())
    colors[:N_SPHERE] = torch.tensor((0.82, 0.82, 0.85), device=dev)
    cam = ring_cameras(8, size, size, device=dev)[0]
    cfg = (lossless_gt_raster(True) if lossless
           else RasterizeConfig(use_pallas=True))
    with torch.no_grad():
        proj = project_gaussians(means, quats, scales, cam.w2c, cam.fx,
                                 cam.fy, cam.cx, cam.cy, size, size, cfg,
                                 opacities=opac)
        bins = bin_gaussians(proj, size, size, cfg)
        attrs = rc._pack_attrs(proj, colors, opac)
    n_tx, k_tile = bins.n_tiles_x, cfg.k_tile
    n_tiles = n_tx * bins.n_tiles_y
    counts = bins.tile_counts.reshape(-1, n_tx)
    assert n_tx * cfg.tile_w > size and int(counts[:, -1].sum()) > 0
    assert int(counts[-1].sum()) > 0
    capped = torch.clamp(bins.tile_counts, max=k_tile).contiguous()
    args = (attrs, bins.sorted_gauss, bins.tile_starts, capped, n_tiles,
            k_tile, means.shape[0])
    (gidx, rows), (gidx_p, rows_p) = (rc.slot_rows(*args),
                                      plain.slot_rows_plain(*args))
    torch.cuda.synchronize()
    assert torch.equal(gidx, gidx_p) and torch.equal(rows, rows_p)
    nc = ((capped + cfg.k_chunk - 1) // cfg.k_chunk).to(torch.int32)
    tids = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    geom = (cfg.tile_h, cfg.tile_w, k_tile, cfg.k_chunk, n_tx, cfg)
    fwd = rc.forward_tiles(nc, tids, rows, *geom)
    fwd_p = plain.forward_tiles_plain(nc, tids, rows, *geom)
    torch.cuda.synchronize()
    assert torch.equal(fwd[:, plain.ROW_DONE], fwd_p[:, plain.ROW_DONE])
    assert torch.equal(fwd[:, plain.ROW_T], fwd_p[:, plain.ROW_T])
    torch.testing.assert_close(fwd[:, 3], fwd_p[:, 3], atol=3e-4, rtol=0)
    torch.testing.assert_close(fwd[:, [0, 1, 2, 4]], fwd_p[:, [0, 1, 2, 4]],
                               atol=3e-5, rtol=0)
    done = fwd[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
    g = torch.randn(fwd.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    d = rc.backward_tiles(done, tids, rows, fwd, g, *geom)
    d_p = plain.backward_tiles_plain(done, tids, rows, fwd, g, *geom)
    torch.cuda.synchronize()
    assert float(d.abs().max()) > 0 and torch.equal(d, d_p)


@pytest.mark.cuda
def test_hard_scene_on_card(cuda_device, tmp_path, monkeypatch):
    """``train_hard_scene.main`` on a short schedule (8 views at 400x400,
    whose tiles end partial, 30 touch patches, 600 steps, SH degree 0):
    every kernel of the step launches, the GT renders are lossless, every
    metric is finite, touch covers part of the sphere, and the touch arm's
    object depth MAE is below the vision arm's."""
    from touchgs_torch.tools import train_hard_scene

    monkeypatch.chdir(tmp_path)
    _zero_launches()
    s = train_hard_scene.main([
        "--views", "8", "--size", "400", "--touch-patches", "30", "--steps",
        "600", "--sh-degree", "0", "--out", str(tmp_path / "hs.md")])
    torch.cuda.synchronize()
    assert all(cuda_build.launches[k] >= 1 for k in TRAIN_PATH), (
        cuda_build.launches)
    gt = s["gt_lossy_tiles"]
    assert gt and gt == [0] * len(gt)
    a, b = s["arms"]["touchgs"], s["arms"]["vision_only"]
    for row in (a, b):
        for k in ("eval_psnr", "depth_mae_cm", "object_depth_mae_cm",
                  "iters_per_sec"):
            assert np.isfinite(row[k]), (k, row)
    assert 0 < s["touch_coverage"] < 1
    assert a["object_depth_mae_cm"] < b["object_depth_mae_cm"], (a, b)


@pytest.mark.cuda
def test_cli_resume_eval_render_export_and_pose_on_card(cli_run, tmp_path):
    """After ``cli_run``'s 20 steps: ``train --load-run`` resumes at step 20
    and ends at 30 with its checkpoint; ``eval``, ``render`` and
    ``export-splat`` of the resumed run write their files with finite
    metrics; ``train --camera-optimizer SO3xR3`` launches K1 with rows, K2,
    K3 and the SSIM pair every step and the shade kernels' backward never
    (the camera takes a gradient, so ``render`` runs the op chain), its
    loss finite and its pose deltas moved."""
    from touchgs_torch import cli
    from touchgs_torch.data.png import read_rgb

    root, _, trainer, run, _ = cli_run
    base = ["--data", str(root), "--preset", "bunny_blender"]
    resumed, run_b = cli.main([
        "train", "--max-steps", "30", "--load-run", str(run),
        "--output-dir", str(tmp_path / "b")] + base)
    torch.cuda.synchronize()
    assert min(m["step"] for m in resumed.history) >= 20
    assert resumed.state.step == 30
    assert (run_b / "checkpoints" / "30.pt").exists()
    load = base + ["--load-run", str(run_b)]
    results = cli.main(["eval"] + load)
    assert all(np.isfinite(results[k]) for k in ("psnr", "ssim", "lpips"))
    assert (run_b / "eval.json").exists()
    rgbs = sorted(cli.main(["render"] + load).glob("*_rgb.png"))
    assert len(rgbs) == len(trainer.scene.i_eval)
    assert read_rgb(rgbs[0]).shape == trainer.scene.images.shape[1:]
    exported, ply = cli.main(["export-splat"] + load)
    assert ply.stat().st_size > 0

    steps = 10
    _zero_launches()
    posed, _ = cli.main([
        "train", "--max-steps", str(steps), "--camera-optimizer", "SO3xR3",
        "--output-dir", str(tmp_path / "c")] + base)
    torch.cuda.synchronize()
    counts = dict(cuda_build.launches)
    assert all(counts[k] >= steps for k in POSE_PATH), counts
    assert counts["shade_bwd"] == 0, counts
    pd = posed.state.pose_deltas
    assert all(np.isfinite(m["loss"]) for m in posed.history)
    assert bool(torch.isfinite(pd).all()) and float(pd.abs().max()) > 0


@pytest.mark.cuda
def test_cli_pipeline_on_card(cuda_device, tmp_path):
    """``cli pipeline`` on a capture directory (a written scene without the
    depth paths and touch seeds that stages 5 and 6 write, its GT depths as
    the aligning ``sparse_depths/``, touch points on the GT sphere nearest
    the first view): every stage runs, ``zoe_depth/`` holds a positive
    depth map a view, fusion, seeds and the depth paths are written, the
    eval metrics are finite, and every kernel of the step launches at
    least once a step."""
    import json
    import shutil

    from touchgs_torch import cli
    from touchgs_torch.data.png import read_png
    from touchgs_torch.tools.write_scene import write_scene

    views, size, steps = 4, 400, 10
    root = tmp_path / "capture"
    w = write_scene(root, views, size, 2000, cuda_device)
    meta = json.loads((root / "transforms.json").read_text())
    for f in meta["frames"]:
        del f["depth_file_path"], f["uncertainty_file_path"]
    (root / "transforms.json").write_text(json.dumps(meta, indent=2))
    shutil.rmtree(root / "uncertainty")
    (root / "depth").rename(root / "sparse_depths")
    for name in ("points_touch.npy", "points_colors.npy"):
        (root / name).unlink()
    pts = w["points"]
    sphere = pts[np.abs(np.linalg.norm(pts, axis=1) - 0.5) < 0.03]
    eye = w["c2w"][0, :3, 3]
    near = np.argsort(np.linalg.norm(sphere - eye, axis=1))[:256]
    np.save(root / "touch_points.npy", sphere[near])

    _zero_launches()
    results = cli.main([
        "pipeline", "--data", str(root), "--max-steps", str(steps),
        "--touch-points", str(root / "touch_points.npy"), "--output-dir",
        str(tmp_path / "outputs"), "--preset", "bunny_blender",
        "--max-gaussians", "16384"])
    torch.cuda.synchronize()
    counts = dict(cuda_build.launches)
    zoe = sorted((root / "zoe_depth").iterdir())
    mm = np.stack([read_png(f) for f in zoe])
    assert len(zoe) == views and mm.shape[1:] == (size, size)
    assert int(mm.min()) > 0
    meta = json.loads((root / "transforms.json").read_text())
    assert len(list((root / "fused_output_dir").iterdir())) == views
    assert (root / "points_touch.npy").exists()
    assert meta["frames"][0]["depth_file_path"].startswith(
        "fused_output_dir/")
    assert all(np.isfinite(results[k]) for k in ("psnr", "ssim", "lpips"))
    assert all(counts[k] >= steps for k in TRAIN_PATH), counts


@pytest.mark.cuda
def test_trainer_graphed_matches_eager_through_the_schedule(
        cuda_device, tmp_path, monkeypatch):
    """``Trainer.run`` for 300 steps on a written 12-view 800x800 scene,
    graphed and then eager (``make_train_step`` giving its
    ``__wrapped__``) from the same seeds, on a schedule that refines at 50,
    100, ..., 250, resets the opacities at 200, raises the active SH degree
    at 100 and 200, and starts at k_tile 128 so that the truncation guard
    escalates.  Each run refines at least twice, resets, raises the SH
    degree and escalates, and launches every kernel of the step exactly
    once a step; the graphed run captures at most once per SH degree,
    escalation and growth and once more, the eager run never; the mean
    eval PSNR (lossless renders) within 0.1 dB and the alive counts within
    1%."""
    from touchgs_torch.config import SCENE_PRESETS
    from touchgs_torch.data.scene import load_scene
    from touchgs_torch.tools.write_scene import write_scene
    from touchgs_torch.train import trainer as tr

    write_scene(tmp_path, 12, 800, 30_000, cuda_device)
    scene = load_scene(tmp_path, train_split_fraction=SCENE_PRESETS[
        "bunny_blender"].train_split_fraction)
    steps = 300
    cfg = TrainConfig(
        model=ModelConfig(max_gaussians=131_072, sh_degree=3,
                          rasterize=RasterizeConfig(use_pallas=True,
                                                    k_tile=128)),
        depth=SCENE_PRESETS["bunny_blender"].depth,
        densify=DensifyConfig(warmup_steps=50, refine_every=50,
                              reset_opacity_every=200),
        sh_degree_interval=100, log_every=10, view_cache_bytes=1 << 30)
    views = scene.i_eval if len(scene.i_eval) else scene.i_train
    graphed = tr.make_train_step

    def plain(*args, **kw):
        step = graphed(*args, **kw)
        return getattr(step, "__wrapped__", step)

    runs = {}
    for name in ("graph", "eager"):
        if name == "eager":
            monkeypatch.setattr(tr, "make_train_step", plain)
        trainer = Trainer(scene, cfg)
        _zero_launches()
        trainer.run(steps)
        torch.cuda.synchronize()
        counts = dict(cuda_build.launches)
        psnrs = []
        for v in views:
            out = trainer.render_view(int(v))
            mse = float(((out.rgb - torch.as_tensor(
                scene.images[v], device=out.rgb.device)) ** 2).mean())
            psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
        runs[name] = dict(
            psnr=float(np.mean(psnrs)),
            alive=int(trainer.state.params.num_alive),
            events=dict(trainer.events), counts=counts,
            escalations=[m["k_tile_escalated_to"] for m in trainer.history
                         if "k_tile_escalated_to" in m],
            sh=trainer.active_sh_degree(steps - 1))
        del trainer
        torch.cuda.empty_cache()
    want = _want(**dict.fromkeys(TRAIN_PATH, steps))
    for name, r in runs.items():
        ev = r["events"]
        assert ev["refine"] >= 2 and ev["reset_opacity"] >= 1, (name, ev)
        assert r["sh"] > 0 and r["escalations"], (name, r)
        assert r["counts"] == want, (name, r["counts"])
    g, e = runs["graph"], runs["eager"]
    bound = g["sh"] + 1 + len(g["escalations"]) + g["events"]["grow"] + 1
    assert g["events"]["capture"] <= bound, (g["events"], bound)
    assert e["events"]["capture"] == 0
    assert abs(g["psnr"] - e["psnr"]) <= 0.1, (g["psnr"], e["psnr"])
    assert abs(g["alive"] - e["alive"]) <= 0.01 * e["alive"]


@pytest.mark.cuda
@pytest.mark.parametrize("tool", [
    "exp_tile_size", "exp_kernels", "exp_kernels2", "exp_scatter",
    "exp_scatter2", "exp_tail", "exp_tail2", "exp_tail3"])
def test_experiment_tool_on_card(cuda_device, tool, tmp_path, monkeypatch):
    """Each experiment tool of ``touchgs_torch/tools/`` runs on the card at
    3 calls a row and exits 0 (``exp_tile_size`` exits 1 where K2 or K3
    differs from its plain version at one of its geometries; a row that
    prints FAILED is a finding, not a failure)."""
    import importlib

    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"touchgs_torch.tools.{tool}")
    assert mod.main(["--iters", "3"], out={}) == 0


# each sensor net's train step and its rate: the JAX package's own
# train-step tests' rates, 2e-4 for the depth net, 1e-3 for the force net
SENSOR_LR = {"densetact": 2e-4, "silog": 2e-4, "force": 1e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(SENSOR_LR))
def test_sensor_train_step_on_card_matches_cpu(cuda_device, kind):
    """One step of a compact sensor net's train step (flax's init from a
    seeded generator, Adam at SENSOR_LR) on the card against one on the
    CPU from the same parameters and batch: the loss within rtol 1e-4, the
    parameters after within 3·lr everywhere and within 1e-5 at 95% of them
    (Adam turns float32 noise in near-zero gradients into steps of up to
    lr; ``tests/test_torch_sensor.py`` measured at most 2.5% on the
    CPU)."""
    from touchgs_torch.touch import sensor_nets as sn
    from touchgs_torch.touch import sensor_train as st

    rng = np.random.default_rng(13)
    images = rng.integers(0, 256, (2, 32, 32, 3)).astype(np.float32)
    target = (rng.uniform(0, 1, (2, 6)) if kind == "force" else
              rng.uniform(1.0, 255.0, (2, 32, 32))).astype(np.float32)
    nets, losses = {}, {}
    for d in ("cpu", cuda_device):
        net = sn.flax_init_(sn.ForceNet() if kind == "force"
                            else sn.TouchDepthNet(),
                            torch.Generator().manual_seed(14)).to(d)
        opt = torch.optim.Adam(net.parameters(), lr=SENSOR_LR[kind],
                               eps=1e-8)
        step = (st.make_force_train_step(net, opt) if kind == "force" else
                st.make_depth_train_step(net, opt, loss=kind))
        losses[str(d)] = float(step(torch.as_tensor(images, device=d),
                                    torch.as_tensor(target, device=d))["loss"])
        nets[str(d)] = net
    card, cpu = losses[str(cuda_device)], losses["cpu"]
    assert np.isfinite(card) and abs(card - cpu) <= 1e-4 * abs(cpu)
    with torch.no_grad():
        diff = torch.cat([(p.cpu() - q).abs().flatten() for p, q in zip(
            nets[str(cuda_device)].parameters(), nets["cpu"].parameters())])
    assert float((diff > 1e-5).float().mean()) <= 0.05
    assert float(diff.max()) <= 3 * SENSOR_LR[kind]


@pytest.mark.cuda
def test_sensor_loop_on_card(cuda_device, tmp_path):
    """``SensorLoop`` with the compact nets on the card over three synthetic
    64x64 frames: every frame processed, a uint8 depth PNG a frame and a
    force.csv row a frame under its header."""
    from touchgs_torch.data.png import read_png
    from touchgs_torch.touch.sensor_loop import SensorLoop, SyntheticSource
    from touchgs_torch.touch.sensor_nets import DenseTactSensor

    loop = SensorLoop(sensor=DenseTactSensor(input_size=16,
                                             device=cuda_device),
                      out_dir=tmp_path, rate_hz=1000.0)
    assert loop.run(SyntheticSource(size=64, n_frames=3)) == 3
    depths = sorted((tmp_path / "depth").iterdir())
    assert len(depths) == 3
    d = read_png(depths[-1])
    assert d.dtype == np.uint8 and d.shape == (64, 64)
    rows = (tmp_path / "force.csv").read_text().splitlines()
    assert rows[0] == "index,fx,fy,fz,tx,ty,tz" and len(rows) == 4


@pytest.mark.cuda
def test_nerf_trains_on_card(cuda_device):
    """``NerfTrainer`` on the card at a small config: 30 DS-NeRF steps whose
    loss falls, 10 URF steps with σ decay (finite, σ decayed), and a
    finite ``render_view`` of the scene's shape."""
    from touchgs_torch.models import nerf

    cfg = nerf.NerfConfig(num_levels=4, hash_size=2**12, base_res=4,
                          max_res=64, mlp_width=32, num_coarse=24,
                          num_fine=24, rays_per_batch=512, near=0.5, far=4.0)
    scene = card_scene(3)
    trainer = nerf.NerfTrainer(scene, cfg, seed=0, device=cuda_device)
    log = []
    trainer.run(30, log_every=1, log_fn=log.append)
    assert all(np.isfinite(m["loss"]) for m in log)
    assert log[-1]["loss"] < log[0]["loss"], (log[0], log[-1])
    img = trainer.render_view(0)
    assert img.shape == scene.images[0].shape and np.isfinite(img).all()

    urf = dataclasses.replace(cfg, depth_loss_type=nerf.NerfDepthLossType.URF,
                              should_decay_sigma=True)
    trainer = nerf.NerfTrainer(scene, urf, seed=0, device=cuda_device)
    sigma = float(trainer.sigma)
    log = []
    trainer.run(10, log_every=1, log_fn=log.append)
    assert all(np.isfinite(m["loss"]) for m in log)
    assert float(trainer.sigma) < sigma


@pytest.mark.cuda
def test_bench_torch_on_card(cuda_device):
    """``bench_torch.py`` in a process of its own on the card at 64x64 (500
    Gaussians in 1024, 2 warm-up and 4 timed steps in windows of 2): exit
    0, one JSON line with a rate, no note and the card named; its launch
    line shows K4 once and every kernel of the step at least once a step;
    its census shows no lossy tile."""
    import json
    import re
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, bench_torch as b\n"
            "b.WIDTH = b.HEIGHT = 64; b.N_GAUSSIANS = 500; b.CAPACITY = 1024\n"
            "b.WARMUP_STEPS, b.TIMED_STEPS, b.CHUNK = 2, 4, 2\n"
            "sys.exit(b.main([]))\n")
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=Path(__file__).resolve().parents[1],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert len(lines) == 1, r.stdout
    h = json.loads(lines[0])
    assert h["value"] > 0 and "note" not in h
    assert h["device"] == torch.cuda.get_device_name(0)
    last = r.stderr.strip().splitlines()[-1]
    assert last.startswith("launches: ")
    counts = json.loads(last[len("launches: "):])["steps"]
    assert counts["compile_smoke"] == 1, counts
    assert all(counts[k] >= 6 for k in TRAIN_PATH), counts
    m = re.search(r"lossy-truncated tiles \(capped & unsaturated\): "
                  r"(\d+)/(\d+)", r.stderr)
    assert m is not None and int(m.group(1)) == 0, r.stderr[-2000:]
