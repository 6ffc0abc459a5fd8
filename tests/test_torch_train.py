"""The port's training slice against the JAX trainer, on the CPU.

Both packages train the same in-memory scene (96x64, 300 seed points,
capacity 512, SH degree 3) with the tile kernels (JAX: Pallas in interpret
mode; the port: the kernels' plain versions).  The port starts from the JAX
trainer's state through ``state_from_numpy``, and both pick the same views
(``np.random.default_rng(seed)``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.data.cameras import Cameras as JCameras
from touchgs_tpu.data.scene import Scene as JScene
from touchgs_tpu.models.splatfacto import compute_losses as j_losses
from touchgs_tpu.models.splatfacto import render as j_render
from touchgs_tpu.train import trainer as jtr
from touchgs_torch.data.cameras import Cameras as TCameras
from touchgs_torch.data.scene import Scene as TScene
from touchgs_torch.models.splatfacto import compute_losses as t_losses
from touchgs_torch.models.splatfacto import render as t_render
from touchgs_torch.train import trainer as ttr
from touchgs_torch.train.optim import PARAM_GROUPS

from tests.synthetic import look_at_camera

W, H, N_VIEWS, N_SEED, CAP = 96, 64, 4, 300, 512
STEPS = 5


def _scene_arrays(seed=0):
    rng = np.random.default_rng(seed)
    cams = [look_at_camera(eye=(2.0 * np.cos(a), 0.6, 2.0 * np.sin(a)),
                           width=W, height=H, focal=90.0)
            for a in np.linspace(0.3, 1.5, N_VIEWS)]
    return dict(
        fx=np.array([float(c.fx) for c in cams], np.float32),
        fy=np.array([float(c.fy) for c in cams], np.float32),
        cx=np.array([float(c.cx) for c in cams], np.float32),
        cy=np.array([float(c.cy) for c in cams], np.float32),
        c2w=np.stack([np.asarray(c.c2w) for c in cams]),
        images=rng.uniform(0, 1, (N_VIEWS, H, W, 3)).astype(np.float32),
        depths=rng.uniform(1.5, 3.0, (N_VIEWS, H, W)).astype(np.float32),
        unc=rng.uniform(0, 1, (N_VIEWS, H, W)).astype(np.float32),
        points=rng.uniform(-0.5, 0.5, (N_SEED, 3)).astype(np.float32),
        colors=rng.uniform(0, 1, (N_SEED, 3)).astype(np.float32),
    )


def _scene(a, cameras_cls, scene_cls):
    cams = cameras_cls(fx=a["fx"], fy=a["fy"], cx=a["cx"], cy=a["cy"],
                       c2w=a["c2w"], width=W, height=H)
    return scene_cls(cameras=cams, images=a["images"], depths=a["depths"],
                     uncertainties=a["unc"], i_train=np.arange(N_VIEWS),
                     i_eval=np.array([], int), seed_points=a["points"],
                     seed_colors=a["colors"], scale_factor=1.0,
                     transform=np.eye(4)[:3], name="parity")


def _cfg(mod, use_pallas=True, sh_degree=3, **kw):
    return mod.TrainConfig(
        model=mod.ModelConfig(
            max_gaussians=CAP, sh_degree=sh_degree,
            rasterize=mod.RasterizeConfig(use_pallas=use_pallas)),
        sh_degree_interval=1, log_every=1, seed=0, **kw)


def _leaves(state) -> dict:
    """The JAX TrainState's leaves as numpy."""
    opt = state.opt_state
    return {
        "params": {f.name: np.asarray(getattr(state.params, f.name))
                   for f in dataclasses.fields(state.params)},
        "count": int(opt.count),
        "mu": {k: np.asarray(v) for k, v in opt.mu.items()},
        "nu": {k: np.asarray(v) for k, v in opt.nu.items()},
        "densify": {f.name: np.asarray(getattr(state.densify, f.name))
                    for f in dataclasses.fields(state.densify)},
        "step": int(state.step),
    }


@pytest.fixture(scope="module")
def arrays():
    return _scene_arrays()


def _run_both(arrays, use_pallas):
    """``STEPS`` steps of ``Trainer.run`` in both packages from the JAX
    trainer's initial state; each step's loss, PSNR, depth and SSIM loss
    agree within rtol 1e-3.  Returns both logs."""
    jt = jtr.Trainer(_scene(arrays, JCameras, JScene), _cfg(jcfg, use_pallas))
    tt = ttr.Trainer(_scene(arrays, TCameras, TScene),
                     _cfg(tcfg, use_pallas), device="cpu")
    tt.state = ttr.state_from_numpy(_leaves(jt.state), "cpu")
    assert tt.state.params.capacity == CAP
    jlog, tlog = [], []
    jt.run(STEPS, log_fn=jlog.append)
    tt.run(STEPS, log_fn=tlog.append)
    assert [m["step"] for m in tlog] == list(range(STEPS))
    gaps = {}
    for key in ("loss", "psnr", "depth_loss", "ssim_loss"):
        j = np.array([m[key] for m in jlog])
        t = np.array([m[key] for m in tlog])
        gaps[key] = float(np.max(np.abs(t - j) / np.abs(j)))
        np.testing.assert_allclose(t, j, rtol=1e-3, err_msg=key)
    print(f"measured relative gaps over {STEPS} steps: {gaps}")
    assert tt.state.step == int(jt.state.step) == STEPS
    assert int(tt.state.opt_state.count) == int(jt.state.opt_state.count)
    return jlog, tlog


def test_slice_matches_jax_trainer(arrays):
    """5 steps of ``Trainer.run`` through the tile kernels; SH bands 0–3
    all activate.  Per-step loss and PSNR agree within rtol 1e-3: Adam
    normalises each gradient, so an f32 summation-order difference in a
    near-zero gradient can move a parameter by up to 2·lr."""
    _run_both(arrays, use_pallas=True)


def test_scan_path_matches_jax_trainer(arrays):
    """The same 5 steps on the default scan path (``use_pallas=False``):
    no step reports ``lossy_tiles``, so the truncation guard's window stays
    empty and reads 0.0, in both packages alike."""
    assert not tcfg.RasterizeConfig().use_pallas  # the default path
    jlog, tlog = _run_both(arrays, use_pallas=False)
    for j, t in zip(jlog, tlog):
        assert "lossy_tiles" not in t and "lossy_tiles" not in j
        assert set(t) == set(j)
        assert t.get("lossy_tiles_window_max", 0.0) == 0.0
        assert "k_tile_escalated_to" not in t


def test_one_step_gradients_match(arrays):
    """Gradients of one step's loss, every parameter group and the screen
    gradient, at the rasterizer's gradient tolerance 5e-6."""
    jt = jtr.Trainer(_scene(arrays, JCameras, JScene), _cfg(jcfg))
    leaves = _leaves(jt.state)
    rng = np.random.default_rng(1)
    # non-trivial higher SH bands so every band carries gradient
    leaves["params"]["sh_rest"] = rng.normal(
        0, 0.1, leaves["params"]["sh_rest"].shape).astype(np.float32)
    jparams = dataclasses.replace(
        jt.state.params, sh_rest=jnp.asarray(leaves["params"]["sh_rest"]))
    view = 1
    jcam, jimg, jdep, junc = jt._batch(view)
    cfg = _cfg(jcfg)

    def j_loss(diff, off):
        p = dataclasses.replace(jparams, **diff)
        out, _ = j_render(p, jcam, cfg.model, active_sh_degree=3,
                          means2d_offset=off)
        return j_losses(out, jimg, jdep, junc, cfg.depth, cfg.ssim_lambda).total

    jdiff = {g: getattr(jparams, g) for g in PARAM_GROUPS}
    jg, jg_off = jax.grad(j_loss, argnums=(0, 1))(
        jdiff, jnp.zeros((CAP, 2), jnp.float32))

    ts = ttr.state_from_numpy(leaves, "cpu")
    tscene = _scene(arrays, TCameras, TScene)
    tcam = tscene.cameras.at(view, "cpu")
    t = lambda a: torch.as_tensor(np.asarray(a)[view])
    tdiff = {g: getattr(ts.params, g).clone().requires_grad_(True)
             for g in PARAM_GROUPS}
    off = torch.zeros((CAP, 2), requires_grad=True)
    tcfg_ = _cfg(tcfg)
    out, _ = t_render(dataclasses.replace(ts.params, **tdiff), tcam,
                      tcfg_.model, active_sh_degree=3, means2d_offset=off)
    loss = t_losses(out, t(arrays["images"]), t(arrays["depths"]),
                    t(arrays["unc"]), tcfg_.depth, tcfg_.ssim_lambda).total
    tg = torch.autograd.grad(loss, [tdiff[g] for g in PARAM_GROUPS] + [off])
    errs = {}
    for g, a in zip(PARAM_GROUPS + ("means2d_offset",), tg):
        b = np.asarray(jg_off if g == "means2d_offset" else jg[g])
        assert np.isfinite(b).any() and np.abs(np.nan_to_num(b)).max() > 0, g
        np.testing.assert_allclose(a.numpy(), b, atol=5e-6, err_msg=g)
        errs[g] = float(np.nanmax(np.abs(a.numpy() - b)))
    print(f"one-step gradients: max |port - JAX| {errs}")


def test_grow_state_matches(arrays):
    jt = jtr.Trainer(_scene(arrays, JCameras, JScene), _cfg(jcfg))
    ts = ttr.state_from_numpy(_leaves(jt.state), "cpu")
    jg = jtr.grow_state(jt.state, 2 * CAP)
    tg = ttr.grow_state(ts, 2 * CAP)
    assert tg.params.capacity == 2 * CAP
    for name, tv in _leaves_torch(tg).items():
        np.testing.assert_array_equal(tv, _flat(_leaves(jg))[name],
                                      err_msg=name)


def _flat(leaves, prefix=""):
    out = {}
    for k, v in leaves.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _leaves_torch(state) -> dict:
    opt = state.opt_state
    return _flat({
        "params": {f.name: getattr(state.params, f.name).numpy()
                   for f in dataclasses.fields(state.params)},
        "count": int(opt.count),
        "mu": {k: v.numpy() for k, v in opt.mu.items()},
        "nu": {k: v.numpy() for k, v in opt.nu.items()},
        "densify": {f.name: getattr(state.densify, f.name).numpy()
                    for f in dataclasses.fields(state.densify)},
        "step": state.step,
    })


def test_sh_degree_0_matches_jax_trainer(arrays):
    """SH degree 0, whose ``sh_rest`` is (C, 0, 3), as the hard scene
    trains it: 3 steps of each trainer (Adam and the densify statistics),
    then from JAX's state a refine with JAX's split noise injected and a
    capacity growth, whose states agree; then 2 more steps of each.
    Per-step loss and PSNR within rtol 1e-3."""
    jc, tc = _cfg(jcfg, sh_degree=0), _cfg(tcfg, sh_degree=0)
    jt = jtr.Trainer(_scene(arrays, JCameras, JScene), jc)
    tt = ttr.Trainer(_scene(arrays, TCameras, TScene), tc, device="cpu")
    tt.state = ttr.state_from_numpy(_leaves(jt.state), "cpu")
    assert tuple(tt.state.params.sh_rest.shape) == (CAP, 0, 3)
    jlog, tlog = [], []
    jt.run(3, log_fn=jlog.append)
    tt.run(3, log_fn=tlog.append)

    key = jax.random.PRNGKey(3)
    noise, k = [], key
    for _ in range(max(1, jc.densify.split_samples)):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (CAP, 3))))
    tt.state = ttr.refine_state(
        ttr.state_from_numpy(_leaves(jt.state), "cpu"), tc, True, True,
        False, split_noise=torch.as_tensor(np.stack(noise)))
    jt.state = jtr.make_refine_step(jc)(jt.state, key, True, True, False)
    jt.state = jtr.grow_state(jt.state, 2 * CAP)
    tt.state = ttr.grow_state(tt.state, 2 * CAP)
    jl, tl = _flat(_leaves(jt.state)), _leaves_torch(tt.state)
    assert tl["params.sh_rest"].shape == (2 * CAP, 0, 3)
    assert tl["params.alive"].sum() > N_SEED      # the refine densified
    for name, tv in tl.items():
        np.testing.assert_allclose(tv, jl[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)

    jt.run(5, log_fn=jlog.append)
    tt.run(5, log_fn=tlog.append)
    assert [m["step"] for m in tlog] == list(range(5))
    for key in ("loss", "psnr"):
        np.testing.assert_allclose([m[key] for m in tlog],
                                   [m[key] for m in jlog], rtol=1e-3,
                                   err_msg=key)


def test_render_view_lossless_on_cpu(arrays):
    tt = ttr.Trainer(_scene(arrays, TCameras, TScene), _cfg(tcfg),
                     device="cpu")
    out = tt.render_view(2)
    assert tuple(out.rgb.shape) == (H, W, 3)
    assert bool(torch.isfinite(out.rgb).all()) and int(out.lossy_tiles) == 0
    dense = tt.render_view(2, use_dense=True)
    np.testing.assert_allclose(out.rgb.numpy(), dense.rgb.numpy(), atol=1e-4)


def test_out_of_slice_options_raise(arrays):
    """``run(viewer=...)`` publishes each log point's status to the viewer
    (here at every step: ``log_every=1``), the last one not training, as
    the JAX trainer does (``touchgs_tpu/train/trainer.py:389-394``)."""
    tt = ttr.Trainer(_scene(arrays, TCameras, TScene), _cfg(tcfg),
                     device="cpu")

    class Recorder:
        def __init__(self):
            self.calls = []

        def update_status(self, step, loss, num_alive, training=True):
            self.calls.append((step, loss, num_alive, training))

    rec, log = Recorder(), []
    tt.run(2, log_fn=log.append, viewer=rec)
    assert tt.state.step == 2
    assert rec.calls == [(m["step"], m["loss"], m["num_alive"], m["step"] < 1)
                         for m in log]
    assert [c[0] for c in rec.calls] == [0, 1]


def test_default_device_is_cuda(arrays):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.Trainer(_scene(arrays, TCameras, TScene), _cfg(tcfg))
