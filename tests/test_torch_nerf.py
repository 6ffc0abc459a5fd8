"""The depth-supervised NeRF (``touchgs_torch/models/nerf.py``) against the
JAX package's (``touchgs_tpu/models/nerf.py``) on the CPU.

The field's parameters are flax's, redrawn to order one (flax's init
gives tables of 1e-4, under which the density is one constant) and carried
across with ``load_flax_params``; the stratified and importance uniforms
are JAX's, drawn as its ``render_rays`` and ``NerfTrainer`` draw them and
injected into the port.  Tolerances: outputs within 1e-5 of their range,
losses rtol 1e-5, unless a test states another with its measurement
(the range, or the largest magnitude where that is larger: ``acc`` sits
at 1 on opaque rays).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchgs_tpu.data.cameras import Cameras as JCameras
from touchgs_tpu.data.scene import Scene as JScene
from touchgs_tpu.models import nerf as jn
from touchgs_torch.data.cameras import Camera as TCamera
from touchgs_torch.data.cameras import Cameras as TCameras
from touchgs_torch.data.scene import Scene as TScene
from touchgs_torch.models import nerf as tn

from tests.synthetic import look_at_camera

TINY = dict(num_levels=4, hash_size=2**12, base_res=4, max_res=64,
            mlp_width=32, num_coarse=24, num_fine=24, rays_per_batch=512,
            near=0.5, far=4.0, depth_loss_mult=0.05, lr=5e-3)
W, H, VIEWS = 48, 32, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one intra-op thread for this module (ROADMAP.md C18),
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def cfgs(**kw):
    return jn.NerfConfig(**{**TINY, **kw}), tn.NerfConfig(
        **{**TINY, **{k: (tn.NerfDepthLossType[v.name]
                          if isinstance(v, jn.NerfDepthLossType) else v)
                      for k, v in kw.items()}})


def assert_close_range(out, ref, tol=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(float(np.ptp(ref)), float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(out - ref).max()) / scale
    assert err <= tol, f"{err:.3e} of the range {scale:.3e}"


def order_one(params, seed):
    """flax's HashGridMLP parameters with the tables redrawn N(0, 0.5²) and
    the biases N(0, 0.1²), as numpy."""
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "hash_" in name:
            return rng.normal(0, 0.5, a.shape).astype(np.float32)
        if "bias" in name:
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(redraw, params)


def field(cfg_j, cfg_t, seed=0):
    jm = jn.HashGridMLP(cfg_j)
    params = order_one(jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 4, 3)),
                               jnp.ones((2, 3))), seed)
    return jm, params, tn.load_flax_params(tn.HashGridMLP(cfg_t), params)


def rays(n, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return o, d


# --------------------------------------------------------------- hash --

def jax_hash_rows(xs, cfg):
    """The JAX module's hash of every level and corner, its own lines
    (``touchgs_tpu/models/nerf.py:79-93``) on uint32: (N, levels, 8)."""
    growth = (cfg.max_res / cfg.base_res) ** (1 / max(cfg.num_levels - 1, 1))
    primes = jnp.array([1, 2654435761, 805459861], jnp.uint32)
    out = []
    for lvl in range(cfg.num_levels):
        res = int(cfg.base_res * growth ** lvl)
        p0 = jnp.floor(xs * res).astype(jnp.int32)
        rows = []
        for corner in range(8):
            off = jnp.array([(corner >> k) & 1 for k in range(3)], jnp.int32)
            cpos = (p0 + off).astype(jnp.uint32)
            rows.append((cpos * primes[None, :]).sum(-1) % cfg.hash_size)
        out.append(jnp.stack(rows, -1))
    return np.asarray(jnp.stack(out, 1)).astype(np.int64)


def hash_positions():
    """Positions in [0, 1] grid units: random inside, the far corner of the
    finest grid (cells 512 and 513, whose products with the primes wrap),
    and outside the box (samples reach far = 6: negative cells)."""
    rng = np.random.default_rng(0)
    inside = rng.uniform(0, 1, (500, 3))
    corner = np.array([[1.0, 1.0, 1.0], [0.9999, 1.0, 0.99995]])
    outside = rng.uniform(-3.5, 3.5, (500, 3))
    return np.concatenate([inside, corner, outside]).astype(np.float32)


def test_hash_indices_equal_jax_exactly():
    cfg = jn.NerfConfig()
    xs = hash_positions()
    ref = jax_hash_rows(jnp.asarray(xs), cfg)
    res = torch.tensor(tn.level_resolutions(tn.NerfConfig()),
                       dtype=torch.float32)
    cells, _ = tn.cell_corners(t(xs)[:, None, :] * res[:, None])
    out = tn.hash_index(cells, cfg.hash_size).numpy()
    assert tn.level_resolutions(tn.NerfConfig())[-1] == 512
    assert int(cells[500:502, -1].max()) == 513 and int(cells.min()) < 0
    np.testing.assert_array_equal(out, ref)


def test_hash_rows_through_the_flax_module():
    """At grid points every level's weight sits on corner 0, so with each
    table row holding its own index and Dense_0 an identity on the
    encoding, flax's Dense_0 output is the row its module hashed to."""
    cfg_j, cfg_t = jn.NerfConfig(), tn.NerfConfig()
    jm = jn.HashGridMLP(cfg_j)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 4, 3)), jnp.ones((2, 3))))
    rows = np.arange(cfg_j.hash_size, dtype=np.float32)
    for lvl in range(cfg_j.num_levels):
        params["params"][f"hash_{lvl}"] = np.stack([rows, rows], -1)
    enc = cfg_j.num_levels * cfg_j.features_per_level
    params["params"]["Dense_0"] = {
        "kernel": np.eye(enc, cfg_j.mlp_width, dtype=np.float32),
        "bias": np.zeros(cfg_j.mlp_width, np.float32)}
    g = np.array([0.0, 1.0, -1.0, 2.0, -2.0, 3.0], np.float32)
    xs = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    x = 2.0 * xs - 1.0                       # exact: xs = (x + 1) / 2
    _, state = jm.apply(params, jnp.asarray(x)[None], jnp.ones((1, 3)),
                        capture_intermediates=True)
    ref = np.asarray(state["intermediates"]["Dense_0"]["__call__"][0])
    ref = ref[:, :enc:2].astype(np.int64)
    res = torch.tensor(tn.level_resolutions(cfg_t), dtype=torch.float32)
    cells, w = tn.cell_corners(t(xs)[:, None, :] * res[:, None])
    assert torch.all(w[..., 0] == 1.0)
    out = tn.hash_index(cells[..., 0, :], cfg_t.hash_size).numpy()
    np.testing.assert_array_equal(out, ref)
    # and the port's encoding reads those rows
    model = tn.load_flax_params(tn.HashGridMLP(cfg_t), params)
    with torch.no_grad():
        np.testing.assert_array_equal(
            model.encode(t(xs))[:, ::2].numpy().astype(np.int64), out)


# -------------------------------------------------------------- field --

def test_hash_grid_mlp_matches_flax():
    cfg_j, cfg_t = cfgs()
    jm, params, tm = field(cfg_j, cfg_t, 1)
    o, d = rays(64, 2)
    x = o[:, None, :] + np.linspace(0.5, 4.0, 24, dtype=np.float32)[
        None, :, None] * d[:, None, :]
    jd, jr = jm.apply(params, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        td, tr = tm(t(x), t(d))
    assert_close_range(td.numpy(), jd)
    assert_close_range(tr.numpy(), jr)


def test_init_shapes_match_flax():
    """The port's random field has flax's parameter shapes, tables in
    [0, 1e-4)."""
    cfg_j, cfg_t = cfgs()
    params = jn.HashGridMLP(cfg_j).init(jax.random.PRNGKey(0),
                                        jnp.zeros((2, 4, 3)),
                                        jnp.ones((2, 3)))["params"]
    m = tn.HashGridMLP(cfg_t).init_random(torch.Generator().manual_seed(0))
    for lvl in range(cfg_t.num_levels):
        assert tuple(m.tables[lvl].shape) == params[f"hash_{lvl}"].shape
    for i, lin in enumerate(m.dense):
        assert tuple(lin.weight.T.shape) == params[f"Dense_{i}"]["kernel"].shape
    assert 0.0 <= float(m.tables.min()) and float(m.tables.max()) < 1e-4


def _render_inputs(seed, R=32, S=16):
    rng = np.random.default_rng(seed)
    density = rng.uniform(0, 5, (R, S)).astype(np.float32)
    density[:, S // 2:] *= 20.0
    rgb = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    ts = np.sort(rng.uniform(0.5, 4.0, (R, S)), -1).astype(np.float32)
    norm = rng.uniform(1.0, 1.3, R).astype(np.float32)
    return density, rgb, ts, norm


def test_volume_render_matches_jax():
    density, rgb, ts, norm = _render_inputs(3)
    ref = jn.volume_render(*map(jnp.asarray, (density, rgb, ts, norm)))
    out = tn.volume_render(*map(t, (density, rgb, ts, norm)))
    for name in ("rgb", "depth", "acc", "weights", "ts"):
        assert_close_range(getattr(out, name).numpy(), getattr(ref, name))


def test_sample_rays_matches_jax():
    cam = look_at_camera(eye=(1.5, 0.8, 2.0), width=W, height=H, focal=40.0)
    px = np.random.default_rng(4).integers(0, [W, H], (100, 2)).astype(
        np.float32)
    ref = jn.sample_rays(cam, jnp.asarray(px))
    tcam = TCamera(fx=t(cam.fx), fy=t(cam.fy), cx=t(cam.cx), cy=t(cam.cy),
                   c2w=t(cam.c2w), width=W, height=H)
    out = tn.sample_rays(tcam, t(px))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


@pytest.mark.parametrize("loss", ["ds_nerf", "urf", "distortion"])
def test_losses_match_jax(loss):
    density, rgb, ts, norm = _render_inputs(5)
    td = np.random.default_rng(6).uniform(0.5, 4.0, ts.shape[0]).astype(
        np.float32)
    td[::5] = 0.0                                   # rays without depth
    jr = jn.volume_render(*map(jnp.asarray, (density, rgb, ts, norm)))
    tr = tn.volume_render(*map(t, (density, rgb, ts, norm)))
    sigma = np.float32(0.05)
    if loss == "ds_nerf":
        ref = jn.ds_nerf_depth_loss(jr.weights, jr.ts, jnp.asarray(td), sigma)
        out = tn.ds_nerf_depth_loss(tr.weights, tr.ts, t(td),
                                    torch.tensor(sigma))
    elif loss == "urf":
        ref = jn.urf_depth_loss(jr, jnp.asarray(td), sigma)
        out = tn.urf_depth_loss(tr, t(td), torch.tensor(sigma))
    else:
        ref = jn.distortion_loss(jr.weights, jr.ts)
        out = tn.distortion_loss(tr.weights, tr.ts)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


def jax_uniforms(key, n, cfg, stratified=True):
    """``render_rays``'s draws from ``key``: (u, u2); without
    stratification it splits the key once, for u2."""
    u = None
    if stratified:
        key, sub = jax.random.split(key)
        u = t(jax.random.uniform(sub, (n, cfg.num_coarse)))
    key, sub = jax.random.split(key)
    return u, t(jax.random.uniform(sub, (n, cfg.num_fine)))


@pytest.mark.parametrize("stratified", [True, False])
def test_render_rays_with_injected_uniforms(stratified):
    cfg_j, cfg_t = cfgs()
    jm, params, tm = field(cfg_j, cfg_t, 7)
    o, d = rays(128, 8, spread=1.0)
    key = jax.random.PRNGKey(3)
    ref = jn.render_rays(jm, params, jnp.asarray(o), jnp.asarray(d), cfg_j,
                         key, stratified=stratified)
    with torch.no_grad():
        out = tn.render_rays(tm, t(o), t(d), cfg_t, stratified=stratified,
                             uniforms=jax_uniforms(key, 128, cfg_j,
                                                   stratified))
    for name in ("rgb", "depth", "acc", "weights", "ts"):
        assert_close_range(getattr(out, name).numpy(), getattr(ref, name))


# ------------------------------------------------------------ trainer --

@pytest.fixture(scope="module")
def scene_arrays():
    rng = np.random.default_rng(9)
    cams = [look_at_camera(eye=(2.0 * np.cos(a), 0.5, 2.0 * np.sin(a)),
                           width=W, height=H, focal=40.0)
            for a in np.linspace(0.2, 1.4, VIEWS)]
    depths = rng.uniform(1.5, 3.0, (VIEWS, H, W)).astype(np.float32)
    depths[:, :4] = 0.0                              # pixels without depth
    return dict(
        fx=np.array([float(c.fx) for c in cams], np.float32),
        fy=np.array([float(c.fy) for c in cams], np.float32),
        cx=np.array([float(c.cx) for c in cams], np.float32),
        cy=np.array([float(c.cy) for c in cams], np.float32),
        c2w=np.stack([np.asarray(c.c2w) for c in cams]),
        images=rng.uniform(0, 1, (VIEWS, H, W, 3)).astype(np.float32),
        depths=depths)


def make_scene(a, cameras_cls, scene_cls):
    cams = cameras_cls(fx=a["fx"], fy=a["fy"], cx=a["cx"], cy=a["cy"],
                       c2w=a["c2w"], width=W, height=H)
    return scene_cls(cameras=cams, images=a["images"], depths=a["depths"],
                     uncertainties=None, i_train=np.arange(VIEWS),
                     i_eval=np.array([], int), seed_points=None,
                     seed_colors=None, scale_factor=1.0,
                     transform=np.eye(4)[:3], name="nerf")


def trainer_pair(scene_arrays, **kw):
    """JAX's trainer and the port's on the CPU from the same order-one
    parameters; the port draws JAX's uniforms (its key, split as JAX's
    ``run`` and ``render_rays`` split it)."""
    cfg_j, cfg_t = cfgs(**kw)
    jt = jn.NerfTrainer(make_scene(scene_arrays, JCameras, JScene), cfg_j)
    jt.params = jax.tree.map(jnp.asarray, order_one(jt.params, 11))
    jt.opt_state = jt.opt.init(jt.params)
    tt = tn.NerfTrainer(make_scene(scene_arrays, TCameras, TScene), cfg_t,
                        device="cpu")
    tn.load_flax_params(tt.model, jax.tree.map(np.asarray, jt.params))
    key = jt.key

    def draw():
        nonlocal key
        key, sub = jax.random.split(key)
        return jax_uniforms(sub, cfg_j.rays_per_batch, cfg_j)

    tt.draw_uniforms = draw
    return jt, tt


def _params_apart(jt, tt) -> tuple:
    ref = tn.load_flax_params(tn.HashGridMLP(tt.cfg),
                              jax.tree.map(np.asarray, jt.params))
    with torch.no_grad():
        diff = torch.cat([(p - r).abs().flatten() for p, r in zip(
            tt.model.parameters(), ref.parameters())])
    return float((diff > 1e-5).float().mean()), float(diff.max())


@pytest.mark.parametrize("loss", ["DS_NERF", "URF"])
def test_trainer_three_steps_match_jax(scene_arrays, loss):
    """Three ``run`` steps, logged every step, against JAX's; URF with σ
    decay.  Every metric within rtol 1e-4 (measured at most 2e-6; the PSNR
    and the depth loss sum thousands of float32 terms in another order).
    The parameters: Adam turns float32 noise in near-zero gradients into
    steps of up to lr (ROADMAP.md C32); measured
    at most 0.3% of entries more than 1e-5 apart, held at 2% within 1e-5
    and all within 3·lr."""
    kw = {"depth_loss_type": jn.NerfDepthLossType[loss]}
    if loss == "URF":
        kw.update(should_decay_sigma=True, starting_depth_sigma=0.2,
                  sigma_decay_rate=0.5)
    jt, tt = trainer_pair(scene_arrays, **kw)
    jlog, tlog = [], []
    jt.run(3, log_every=1, log_fn=jlog.append)
    tt.run(3, log_every=1, log_fn=tlog.append)
    assert len(jlog) == len(tlog) == 3
    for a, b in zip(tlog, jlog):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(tt.sigma), float(jt.sigma), rtol=1e-7)
    if loss == "URF":
        assert float(tt.sigma) == pytest.approx(0.025)
    share, worst = _params_apart(jt, tt)
    print(f"{loss}: {share:.3%} of the parameters more than 1e-5 apart, at "
          f"most {worst:.3e}")
    assert share <= 0.02 and worst <= 3 * tt.cfg.lr


def test_sigma_decay_matches_jax(scene_arrays):
    kw = dict(should_decay_sigma=True, starting_depth_sigma=0.2,
              depth_sigma=0.01, sigma_decay_rate=0.7)
    jt, tt = trainer_pair(scene_arrays, **kw)
    for _ in range(12):
        jt.decay_sigma()
        tt.decay_sigma()
        assert float(tt.sigma) == float(jt.sigma)
    assert float(tt.sigma) == pytest.approx(0.01)


def test_render_view(scene_arrays):
    """``render_view`` renders unstratified with a generator seeded 0 each
    chunk: equal to ``render_rays`` on the same rays and draws, in chunks
    or not."""
    _, tt = trainer_pair(scene_arrays)
    img = tt.render_view(1, chunk=500)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    cam = tt.camera(1)
    ys, xs = np.mgrid[0:H, 0:W]
    px = t(np.stack([xs.ravel(), ys.ravel()], -1)[:500])
    o, d, _ = tn.sample_rays(cam, px)
    with torch.no_grad():
        ref = tn.render_rays(tt.model, o, d, tt.cfg,
                             torch.Generator().manual_seed(0),
                             stratified=False)
    np.testing.assert_array_equal(img.reshape(-1, 3)[:500], ref.rgb.numpy())
