"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs a CUDA device and skips without one: the kernels have
no CPU mode.  The file imports neither JAX nor the JAX package, so it also
runs where JAX is not installed; on a GPU machine run it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
Inputs are made with numpy from a seed and go through the port's own
pipeline; the tolerances are those ``chip_smoke.py`` holds the kernels to.
"""
import numpy as np
import pytest
import torch

from chip_smoke import look_at_c2w
from touchgs_torch.config import ModelConfig, RasterizeConfig, TrainConfig
from touchgs_torch.data.cameras import Camera, Cameras
from touchgs_torch.data.scene import Scene
from touchgs_torch.ops import anatomy, cuda_build
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.ops.projection import project_gaussians
from touchgs_torch.ops.tiles import bin_gaussians
from touchgs_torch.tools.exp_kernel_anatomy import probe_inputs
from touchgs_torch.train.trainer import Trainer

W, H = 96, 64           # 3x2 tiles of 32x32
K_TILE, K_CHUNK = 512, 64
N_TX, N_TILES = 3, 6
N = 300


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


def _scene_tiles(dev):
    """K1 on the card and its plain version, and the scene's tile table."""
    a = scene_arrays()
    proj = _project(a, dev)
    bins = bin_gaussians(proj, W, H, RasterizeConfig())
    capped = torch.clamp(bins.tile_counts, max=K_TILE).contiguous()
    args = (bins.sorted_gauss, bins.tile_starts, capped, N_TILES, K_TILE, N)
    gidx = rc.slot_lists(*args)
    attrs = rc._pack_attrs(proj, torch.as_tensor(a["colors"], device=dev),
                           torch.as_tensor(a["opac"], device=dev))
    return gidx, plain.slot_lists_plain(*args), attrs[gidx].contiguous(), capped


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["scene", "saturating", "saturating_16x16",
                                  "saturating_8x8", "saturating_4x8"])
def test_cuda_kernels_match_plain(cuda_device, case):
    """K1 bit-exact; K2's chunks_done and T row equal to the plain
    version's, rgb/acc 3e-5, depth 3e-4; K3 bit-exact, because the plain
    version sums in the kernel's order.  The tile sizes take every
    pixels-per-thread instance of K2 and K3 (4, 4, 2, 1)."""
    dev = cuda_device
    th, tw = 32, 32
    if case == "scene":
        gidx, gidx_p, at, counts = _scene_tiles(dev)
        assert torch.equal(gidx, gidx_p)
        assert bool((gidx >= N).any())
    else:
        if "_" in case:
            th, tw = map(int, case.split("_")[1].split("x"))
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


@pytest.mark.cuda
def test_trainer_on_card_matches_cpu(cuda_device):
    """Three steps of ``Trainer.run`` with the default device (the card)
    against the same steps on the CPU; every step launches K1-K3 once."""
    rng = np.random.default_rng(0)
    n_views = 2
    c2w = np.stack([look_at_c2w((2.0 * np.cos(t), 0.6, 2.0 * np.sin(t)))
                    for t in (0.4, 1.1)])
    f = np.full(n_views, 90.0, np.float32)
    cams = Cameras(fx=f, fy=f.copy(), cx=np.full(n_views, W / 2, np.float32),
                   cy=np.full(n_views, H / 2, np.float32), c2w=c2w, width=W,
                   height=H)
    scene = Scene(
        cameras=cams,
        images=rng.uniform(0, 1, (n_views, H, W, 3)).astype(np.float32),
        depths=rng.uniform(1.5, 3.0, (n_views, H, W)).astype(np.float32),
        uncertainties=rng.uniform(0, 1, (n_views, H, W)).astype(np.float32),
        i_train=np.arange(n_views), i_eval=np.array([], int),
        seed_points=rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32),
        seed_colors=rng.uniform(0, 1, (N, 3)).astype(np.float32),
        scale_factor=1.0, transform=np.eye(4)[:3], name="card")
    cfg = TrainConfig(model=ModelConfig(
        max_gaussians=512, sh_degree=3,
        rasterize=RasterizeConfig(use_pallas=True)),
        sh_degree_interval=1, log_every=1)
    steps = 3
    logs = {}
    for device in ("cpu", None):
        for k in rc.launches:
            rc.launches[k] = 0
        trainer = Trainer(scene, cfg, device=device)
        log = []
        trainer.run(steps, log_fn=log.append)
        logs[trainer.device.type] = log
        counts = dict(rc.launches)
        assert counts == {k: (steps if device is None else 0)
                          for k in counts}, counts
    for key in ("loss", "psnr"):
        c = np.array([m[key] for m in logs["cpu"]])
        g = np.array([m[key] for m in logs["cuda"]])
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, c, rtol=1e-3, err_msg=key)


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


def _tiles_on(dev, case, k_chunk):
    if case == "scene":
        _, _, at, counts = _scene_tiles(dev)
    else:
        at_np, counts_np = saturating_tiles()
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
@pytest.mark.parametrize("case", ["scene", "saturating"])
def test_anatomy_variant_matches_plain(cuda_device, case, mode):
    """K5 against its plain version: 3e-5 of the tile's largest output
    (the plain version's cumulative product and sums round in another
    order; α is bit-identical)."""
    at, nc, tids = _tiles_on(cuda_device, case, 128)
    args = (nc, tids, at, 32, 32, K_TILE, 128, N_TX, RasterizeConfig())
    before = anatomy.launches[f"anatomy_{mode}"]
    out = anatomy.variant(mode, *args)
    ref = anatomy.variant_plain(mode, *args)
    torch.cuda.synchronize()
    assert anatomy.launches[f"anatomy_{mode}"] == before + 1
    assert float(ref[:, 0].max()) > 0.1
    assert _tile_rel_err(out, ref) <= 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["f32", "bf16"])
def test_bf16_probe_matches_plain(cuda_device, leg):
    """K6 against its plain version on the card: f32 1e-5 of the tile's
    largest output (sum order); bf16 2^-6 (h2exp2 is not correctly
    rounded: a few bf16 ulps, 2^-8 each, per α)."""
    at = probe_inputs(n_tiles=8, device=cuda_device)[leg]
    before = anatomy.launches[f"bf16_probe_{leg}"]
    out = anatomy.bf16_probe(at)
    ref = anatomy.bf16_probe_plain(at)
    torch.cuda.synchronize()
    assert anatomy.launches[f"bf16_probe_{leg}"] == before + 1
    assert out.shape == (8, 1, 1024) and float(ref.max()) > 100
    assert _tile_rel_err(out, ref) <= (1e-5 if leg == "f32" else 2.0 ** -6)
