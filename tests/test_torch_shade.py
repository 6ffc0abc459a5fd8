"""The shade stage's kernels' plain versions and their place in ``render``
(``touchgs_torch/ops/shade.py``), on the CPU.

``shade_bwd_plain`` is the VJP the backward kernel computes, written out;
it is held against autograd of the op chain (``shade_fwd_plain``, which is
``splatfacto.shade`` and ``_attr_rows``) in float64, where the two agree
to rounding, and in float32 at the card tests' tolerance.  The states
plant what the masks must get right: dead slots, Gaussians behind the
near plane and off the screen (the Jacobian's clamp), a degenerate 2D
covariance (the det guard, with ``eps2d`` 0), opacities under the cull
threshold, colours clamped at 0, every active SH degree.  Then the
routing: on the CPU ``render`` and the train step run the op chain and
never the fused function; a camera that takes a gradient (the SO3xR3
step) keeps the op chain on any device, and its pose deltas get their
gradient; ``rasterize_cuda`` composites a table handed to it
(``attrs``) as it composites the one it packs, with and without tile
shards and a mesh of one rank.  The kernels themselves are held on the
card (``tests/test_torch_cuda.py``).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from touchgs_torch.config import (ModelConfig, PoseOptConfig,
                                  RasterizeConfig, TrainConfig)
from touchgs_torch.data.cameras import Camera, Cameras
from touchgs_torch.data.scene import Scene
from touchgs_torch.models import splatfacto
from touchgs_torch.models.gaussians import GaussianParams
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import shade as sh
from touchgs_torch.parallel.mesh import Mesh
from touchgs_torch.train import trainer as ttr

W, H, C = 96, 64, 300
PAIRS = [(deg, act) for deg in range(4) for act in range(deg + 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one intra-op thread for this module (restored after it):
    the scatter-add of the tile kernels' plain backward sums in another
    order from run to run on several threads, and the comparisons below
    are bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def look_at_c2w(eye, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """OpenGL-convention c2w (camera looks down −Z) from ``eye``."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w.astype(np.float32)


def camera(dtype=torch.float32) -> Camera:
    def t(v):
        return torch.as_tensor(np.asarray(v), dtype=dtype)

    return Camera(fx=t(110.0), fy=t(100.0), cx=t(W / 2), cy=t(H / 2),
                  c2w=t(look_at_c2w((0.3, 0.2, 2.2))), width=W, height=H)


def planted(deg: int, dtype=torch.float32, seed: int = 0,
            isotropic: bool = False) -> tuple:
    """(six groups, alive) of C Gaussians around the origin, with rows
    planted behind the camera, off the screen, huge, point-like,
    transparent and dark; ``isotropic``: every Gaussian's three scales
    within a factor 1.8, so that without ``eps2d`` only the point-like
    rows' 2D covariances are degenerate and the rest stay well
    conditioned."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (C, 3))
    means[:10, 2] = 5.0                      # behind the camera
    means[60:70, 0] = rng.uniform(2.0, 4.0, 10)   # off the screen's side
    quats = rng.normal(size=(C, 4))
    log_scales = rng.uniform(-4.0, -1.5, (C, 3))
    log_scales[10:20] = rng.uniform(-1.0, 0.0, (10, 3))   # large
    log_scales[40:50] = -30.0                # point-like: degenerate at eps 0
    if isotropic:
        log_scales[:] = log_scales[:, :1] + rng.uniform(-0.3, 0.3, (C, 3))
    logit = rng.normal(size=C) * 2.0
    logit[20:30] = -7.0                      # under the cull threshold
    sh_dc = rng.normal(size=(C, 3))
    sh_dc[30:40] = -3.0                      # clamped at 0
    sh_rest = rng.normal(size=(C, (deg + 1) ** 2 - 1, 3)) * 0.3
    alive = rng.uniform(size=C) > 0.1        # dead slots
    groups = tuple(torch.as_tensor(a, dtype=dtype) for a in
                   (means, quats, log_scales, logit, sh_dc, sh_rest))
    return groups, torch.as_tensor(alive)


def chain_grads(groups, alive, cam, cfg, active, seed=1) -> tuple:
    """(valid, the table's gradient, autograd's gradients of the six groups
    and the offset) for a seeded cotangent on the valid rows: what K3 and
    the scatter-add hand the stage."""
    n = groups[0].shape[0]
    leaves = [g.clone().requires_grad_(True) for g in groups]
    offset = torch.zeros((n, 2), dtype=groups[0].dtype,
                         device=groups[0].device, requires_grad=True)
    out = sh.shade_fwd_plain(tuple(leaves), alive, offset, cam, cam.w2c,
                             cfg, active, 512)
    table, valid = out[0], out[5]
    rng = np.random.default_rng(seed)
    grad = torch.as_tensor(rng.normal(size=table.shape), dtype=table.dtype,
                           device=table.device)
    grad[:n][~valid] = 0
    grad[n:] = 0
    ref = torch.autograd.grad((table * grad).sum(), leaves + [offset],
                              allow_unused=True)
    ref = tuple(torch.zeros_like(x) if r is None else r
                for r, x in zip(ref, leaves + [offset]))
    return valid, grad, ref


def assert_grads_close(got, ref, valid, rtol, sh_zeros=True):
    """Each group within ``rtol`` of its largest; the rows the cotangent
    skips zero in both; the colour groups' zeros (clamps, bands above the
    active degree) equal."""
    names = list(sh.GROUPS) + ["offset"]
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if r.numel() == 0:
            continue
        scale = float(r.abs().max())
        err = float((g - r).abs().max())
        assert err <= rtol * scale, (name, err, scale)
        assert bool((g[~valid] == 0).all()), name
        if sh_zeros and name in ("sh_dc", "sh_rest", "logit_opacities",
                                 "offset"):
            assert torch.equal(g == 0, r == 0), name


@pytest.mark.parametrize("deg, active", PAIRS)
def test_plain_backward_matches_autograd_float64(deg, active):
    """The written-out VJP is autograd's chain rule to rounding (float64):
    every formula and every mask; with eps2d 0 at active degree 0 so that
    the point-like rows meet the det guard."""
    eps = 0.0 if active == 0 else 0.3
    cfg = ModelConfig(sh_degree=deg, rasterize=RasterizeConfig(eps2d=eps))
    groups, alive = planted(deg, torch.float64, seed=3 * deg + active)
    cam = camera(torch.float64)
    valid, grad, ref = chain_grads(groups, alive, cam, cfg, active)
    got = sh.shade_bwd_plain(grad, groups, cam, cam.w2c, cfg, active)
    assert_grads_close(got, ref, valid, 1e-12)
    if eps == 0.0:   # the planted degenerate rows met the guard
        det_rows = sh.shade_fwd_plain(groups, alive, None, cam, cam.w2c, cfg,
                                      active, 0)[3][40:50]
        assert bool((det_rows == 0).all())


@pytest.mark.parametrize("active", range(4))
def test_plain_backward_float32(active):
    """In float32 the written-out VJP stays within the card tests' 1e-5 of
    each group's largest (measured at most 2.4e-6) on the planted state."""
    cfg = ModelConfig(sh_degree=3)
    groups, alive = planted(3, seed=10 + active)
    cam = camera()
    valid, grad, ref = chain_grads(groups, alive, cam, cfg, active)
    got = sh.shade_bwd_plain(grad, groups, cam, cam.w2c, cfg, active)
    assert_grads_close(got, ref, valid, 1e-5)


def test_plain_backward_float32_degenerate():
    """Without ``eps2d`` the point-like rows' 2D covariances fall under the
    det guard (radius 0, invalid, no gradient); the well-conditioned rest
    keep the float32 VJP within 1e-5 (measured at most 1.1e-6)."""
    cfg = ModelConfig(sh_degree=3, rasterize=RasterizeConfig(eps2d=0.0))
    groups, alive = planted(3, seed=41, isotropic=True)
    cam = camera()
    valid, grad, ref = chain_grads(groups, alive, cam, cfg, 3)
    assert not bool(valid[40:50].any())
    got = sh.shade_bwd_plain(grad, groups, cam, cam.w2c, cfg, 3)
    assert_grads_close(got, ref, valid, 1e-5)


def _params(groups, alive) -> GaussianParams:
    return GaussianParams(*groups, alive)


def test_shade_function_on_cpu(monkeypatch):
    """``shade_packed`` on CPU tensors: the op chain's table, means, depths,
    radii, cull radii and validity bit for bit (the plain forward is the
    chain), with the 512 dead rows zero, or none with ``dead`` 0; the
    backward within 1e-5 of autograd's, into the offset as well."""
    cfg = ModelConfig(sh_degree=3)
    groups, alive = planted(3, seed=21)
    cam = camera()
    leaves = [g.clone().requires_grad_(True) for g in groups]
    offset = torch.zeros((C, 2), requires_grad=True)
    proj, table = sh.shade_packed(_params(leaves, alive), cam, cfg, 2, offset)
    ref_proj, colors, opac, _ = splatfacto.shade(
        _params(groups, alive), cam, cfg, 2,
        means2d_offset=torch.zeros((C, 2)))
    ref_table = rc._pack_attrs(ref_proj, colors, opac)
    assert torch.equal(table, ref_table)
    for f in ("means2d", "depths", "radii", "cull_radii", "valid"):
        assert torch.equal(getattr(proj, f), getattr(ref_proj, f)), f
    assert proj.conics is None
    assert not any(t.requires_grad for t in (proj.means2d, proj.radii))
    _, rows = sh.shade_packed(_params(groups, alive), cam, cfg, 2,
                              dead_rows=False)
    assert torch.equal(rows, ref_table[:C])

    valid, grad, ref = chain_grads(groups, alive, cam, cfg, 2)
    got = torch.autograd.grad((table * grad).sum(), leaves + [offset])
    assert_grads_close(got, ref, valid, 1e-5)


@pytest.mark.parametrize("case", [
    "dtype", "shape", "contiguity", "alive", "offset", "camera", "active",
    "grad_rows"])
def test_wrappers_check_their_inputs(case):
    """The wrappers' checks, on any device: the groups' types, shapes and
    layout, ``alive``, the offset, the camera's tensors, the active
    degree and the gradient's rows each raise ValueError."""
    cfg = ModelConfig(sh_degree=3)
    groups, alive = planted(3)
    cam, w2c, offset = camera(), camera().w2c, None
    active = 3
    grad = torch.zeros((C + 512, 16))
    groups = list(groups)
    if case == "dtype":
        groups[0] = groups[0].double()
    elif case == "shape":
        groups[5] = groups[5][:, :8]
    elif case == "contiguity":
        groups[1] = groups[1].t().contiguous().t()
    elif case == "alive":
        alive = alive.float()
    elif case == "offset":
        offset = torch.zeros((C, 3))
    elif case == "camera":
        cam = dataclasses.replace(cam, fx=cam.fx.reshape(1))
    elif case == "active":
        active = 4
    else:
        grad = grad[:C - 1]
    with pytest.raises(ValueError):
        if case == "grad_rows":
            sh.shade_bwd(grad, tuple(groups), cam, w2c, cfg, active)
        else:
            sh.shade_fwd(tuple(groups), alive, offset, cam, w2c, cfg, active,
                         512)


def test_fused_shade_routing():
    """``render`` shades through the kernels only with the state on the
    card and a camera that takes no gradient: the SO3xR3 step's camera
    (its pose delta applied) keeps the op chain, whose autograd sums the
    camera's gradient over every Gaussian; a CPU state always does."""
    from touchgs_torch.models.pose_opt import apply_pose_delta

    on_card = types.SimpleNamespace(means=types.SimpleNamespace(is_cuda=True))
    cam = camera()
    assert splatfacto._fused_shade(on_card, cam)
    tau = torch.zeros(6, requires_grad=True)
    assert not splatfacto._fused_shade(on_card, apply_pose_delta(cam, tau))
    with torch.no_grad():   # an eval render of the pose-corrected camera
        assert splatfacto._fused_shade(on_card, apply_pose_delta(cam, tau))
    groups, alive = planted(3)
    assert not splatfacto._fused_shade(_params(groups, alive), cam)


def _scene(n_views=3, size=48, seeds=400) -> Scene:
    rng = np.random.default_rng(4)
    c2w = np.stack([look_at_c2w((2.0 * np.cos(a), 0.5, 2.0 * np.sin(a)))
                    for a in np.linspace(0.2, 1.2, n_views)])
    f = np.full(n_views, 50.0, np.float32)
    cams = Cameras(fx=f, fy=f, cx=f * 0 + size / 2, cy=f * 0 + size / 2,
                   c2w=c2w, width=size, height=size)
    return Scene(cameras=cams,
                 images=rng.uniform(0, 1, (n_views, size, size, 3))
                 .astype(np.float32),
                 depths=rng.uniform(1.5, 3.0, (n_views, size, size))
                 .astype(np.float32),
                 uncertainties=rng.uniform(0, 1, (n_views, size, size))
                 .astype(np.float32),
                 i_train=np.arange(n_views), i_eval=np.array([], int),
                 seed_points=rng.uniform(-0.5, 0.5, (seeds, 3))
                 .astype(np.float32),
                 seed_colors=rng.uniform(0, 1, (seeds, 3)).astype(np.float32),
                 scale_factor=1.0, transform=np.eye(4)[:3], name="shade")


def _train_cfg(pose: str = "off") -> TrainConfig:
    return TrainConfig(model=ModelConfig(
        max_gaussians=1024, sh_degree=1,
        rasterize=RasterizeConfig(use_pallas=True)),
        pose_opt=PoseOptConfig(mode=pose), seed=0)


@pytest.fixture
def no_fused_shade(monkeypatch):
    """The fused function made to raise wherever it would run."""
    def refuse(*a, **k):
        raise AssertionError("the fused shade ran")

    monkeypatch.setattr(sh, "shade_fwd", refuse)
    monkeypatch.setattr(sh, "shade_bwd", refuse)


@pytest.mark.parametrize("pose", ["off", "SO3xR3"])
def test_cpu_steps_run_the_op_chain(no_fused_shade, pose):
    """On the CPU the train step's body, with and without the pose
    optimizer, runs the op chain and autograd as before: three steps
    train without the fused function, and the pose step moves the pose
    deltas of the views it saw."""
    torch.manual_seed(0)
    trainer = ttr.Trainer(_scene(), _train_cfg(pose), device="cpu")
    trainer.run(3)
    assert trainer.state.step == 3
    if pose == "SO3xR3":
        moved = trainer.state.pose_deltas.abs().sum(-1) > 0
        assert int(moved.sum()) >= 1


def test_cpu_render_is_the_op_chain(no_fused_shade):
    """``render`` on the CPU through the tile kernels' plain versions gives
    the explicit chain's image and gradients bit for bit: ``shade``, then
    ``rasterize_cuda`` packing the attributes itself."""
    cfg = ModelConfig(sh_degree=3, rasterize=RasterizeConfig(use_pallas=True))
    groups, alive = planted(3, seed=5)
    alive[:] = True
    cam = camera()

    def run(fn):
        leaves = [g.clone().requires_grad_(True) for g in groups]
        out = fn(_params(leaves, alive))
        loss = out.rgb.sum() + out.depth.sum()
        return (out.rgb, out.depth, out.acc) + torch.autograd.grad(
            loss, leaves)

    def chain(p):
        proj, colors, opac, bg = splatfacto.shade(p, cam, cfg, 3)
        return rc.rasterize_cuda(proj, colors, opac, W, H, cfg.rasterize,
                                 background=bg, k_chunk=cfg.rasterize.k_chunk)

    got = run(lambda p: splatfacto.render(p, cam, cfg, 3)[0])
    want = run(chain)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("layout", ["whole", "tile_shards", "mesh"])
def test_rasterize_takes_a_packed_table(layout):
    """``rasterize_cuda`` given the table ``shade_packed`` packs
    (``attrs``: with its dead rows, or a mesh's rows alone) renders the
    image it renders from ``proj``, ``colors`` and ``opacities``, bit for
    bit, whole, in 3 tile shards and on a mesh of one rank; its gradients
    through the plain VJP within 1e-5 of autograd's."""
    cfg = ModelConfig(sh_degree=3, rasterize=RasterizeConfig(use_pallas=True))
    groups, alive = planted(3, seed=7)
    cam = camera()
    mesh = Mesh(data=1, model=1) if layout == "mesh" else None
    shards = 3 if layout == "tile_shards" else 0
    kw = dict(background=torch.zeros(3), k_chunk=cfg.rasterize.k_chunk,
              tile_shards=shards, mesh=mesh)

    def packed(p):
        proj, table = sh.shade_packed(p, cam, cfg, 3,
                                      dead_rows=mesh is None)
        return rc.rasterize_cuda(proj, None, None, W, H, cfg.rasterize,
                                 attrs=table, **kw)

    def chain(p):
        proj, colors, opac, _ = splatfacto.shade(p, cam, cfg, 3)
        return rc.rasterize_cuda(proj, colors, opac, W, H, cfg.rasterize,
                                 **kw)

    results = []
    for fn in (packed, chain):
        leaves = [g.clone().requires_grad_(True) for g in groups]
        out = fn(_params(leaves, alive))
        loss = (out.rgb * torch.linspace(0, 1, 3)).sum() + out.depth.sum()
        results.append(((out.rgb, out.depth, out.acc),
                        torch.autograd.grad(loss, leaves)))
    (img, grads), (ref_img, ref_grads) = results
    for a, b in zip(img, ref_img):
        assert torch.equal(a, b)
    for name, g, r in zip(sh.GROUPS, grads, ref_grads):
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-5 * scale, name
