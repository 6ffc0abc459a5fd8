"""Parity of the PyTorch port's ops against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through each JAX function and
its counterpart in ``touchgs_torch`` (``device="cpu"``).  Small sizes: a
96x64 image, 300 Gaussians.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.models import densify as jdens
from touchgs_tpu.models.gaussians import init_random as j_init_random
from touchgs_tpu.models.splatfacto import depth_supervision_loss as j_depth_loss
from touchgs_tpu.ops.projection import project_gaussians as j_project
from touchgs_tpu.ops.sh import eval_sh as j_eval_sh
from touchgs_tpu.ops.ssim import ssim_cm as j_ssim_cm
from touchgs_tpu.ops.tiles import bin_gaussians as j_bin
from touchgs_tpu.train.optim import make_optimizer, reset_opt_slots
from touchgs_torch.models import densify as tdens
from touchgs_torch.models.gaussians import init_random as t_init_random
from touchgs_torch.models.splatfacto import depth_supervision_loss as t_depth_loss
from touchgs_torch.ops.projection import project_gaussians as t_project
from touchgs_torch.ops.sh import eval_sh as t_eval_sh
from touchgs_torch.ops.ssim import ssim_cm as t_ssim_cm
from touchgs_torch.ops.ssim import ssim_cm_band, ssim_cm_fused
from touchgs_torch.ops.tiles import bin_gaussians as t_bin
from touchgs_torch.train import optim as toptim

from tests.synthetic import look_at_camera, random_gaussians

W, H = 96, 64


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- config copy -----------------------------------------------------------

_CONFIG_CLASSES = ["RasterizeConfig", "ModelConfig", "DepthLossConfig",
                   "DensifyConfig", "OptimConfig", "PoseOptConfig",
                   "TrainConfig"]


def _plain(obj):
    """Dataclass → nested dict with enums as values, for comparison."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (jcfg.DepthLossType, tcfg.DepthLossType)):
        return ("DepthLossType", obj.value)
    return obj


@pytest.mark.parametrize("name", _CONFIG_CLASSES)
def test_config_class_matches_reference(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert _plain(t()) == _plain(j())
    assert t.__dataclass_params__.frozen == j.__dataclass_params__.frozen


def test_config_presets_match_reference():
    assert [m.value for m in tcfg.DepthLossType] == \
        [m.value for m in jcfg.DepthLossType]
    assert sorted(tcfg.SCENE_PRESETS) == sorted(jcfg.SCENE_PRESETS)
    for key in jcfg.SCENE_PRESETS:
        tp, jp = tcfg.SCENE_PRESETS[key], jcfg.SCENE_PRESETS[key]
        assert _plain(tp) == _plain(jp)
        assert _plain(tcfg.train_config_for_preset(tp, seed=3)) == \
            _plain(jcfg.train_config_for_preset(jp, seed=3))


# --- parameters, projection, SH --------------------------------------------

def test_init_random_bit_identical():
    jp = j_init_random(n=300, capacity=512, sh_degree=3, seed=2)
    tp = t_init_random(n=300, capacity=512, sh_degree=3, seed=2, device="cpu")
    for f in dataclasses.fields(jp):
        np.testing.assert_array_equal(_np(getattr(tp, f.name)),
                                      np.asarray(getattr(jp, f.name)),
                                      err_msg=f.name)


@pytest.fixture(scope="module")
def proj_inputs():
    means, quats, scales, colors, opac = random_gaussians(300, seed=5)
    cam = look_at_camera(eye=(0.4, 0.3, 2.5), width=W, height=H)
    return dict(means=means, quats=quats, scales=scales, colors=colors,
                opac=opac, cam=cam)


def _cam_args(cam, to):
    return (to(cam.w2c), to(cam.fx), to(cam.fy), to(cam.cx), to(cam.cy))


def test_project_gaussians_matches(proj_inputs):
    p = proj_inputs
    rng = np.random.default_rng(0)
    wts = [rng.normal(size=s).astype(np.float32)
           for s in ((300, 2), (300, 3), (300,))]
    jcfg_r, tcfg_r = jcfg.RasterizeConfig(), tcfg.RasterizeConfig()

    def j_fn(means, quats, scales):
        pr = j_project(means, quats, scales, *_cam_args(p["cam"], jnp.asarray),
                       W, H, jcfg_r, opacities=p["opac"])
        loss = (jnp.sum(pr.means2d * wts[0]) + jnp.sum(pr.conics * wts[1])
                + jnp.sum(pr.depths * wts[2]))
        return loss, pr

    (_, jpr), jg = jax.value_and_grad(j_fn, argnums=(0, 1, 2), has_aux=True)(
        p["means"], p["quats"], p["scales"])

    tin = [_t(p[k], True) for k in ("means", "quats", "scales")]
    tpr = t_project(*tin, *_cam_args(p["cam"], _t), W, H, tcfg_r,
                    opacities=_t(p["opac"]))
    loss = (torch.sum(tpr.means2d * _t(wts[0])) + torch.sum(tpr.conics * _t(wts[1]))
            + torch.sum(tpr.depths * _t(wts[2])))
    tg = torch.autograd.grad(loss, tin)

    for name in ("means2d", "conics", "depths"):
        np.testing.assert_allclose(_np(getattr(tpr, name)),
                                   np.asarray(getattr(jpr, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("radii", "cull_radii", "valid"):
        np.testing.assert_array_equal(_np(getattr(tpr, name)),
                                      np.asarray(getattr(jpr, name)),
                                      err_msg=name)
    for a, b, name in zip(tg, jg, ("means", "quats", "scales")):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=f"grad {name}")


@pytest.mark.parametrize("active", [0, 1, 2, 3])
def test_eval_sh_matches(active):
    rng = np.random.default_rng(active)
    sh = rng.normal(size=(200, 16, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    wts = rng.normal(size=(200, 3)).astype(np.float32)

    def j_fn(sh, d):
        return jnp.sum(j_eval_sh(sh, d, 3, jnp.int32(active)) * wts)

    jv = j_eval_sh(jnp.asarray(sh), jnp.asarray(d), 3, jnp.int32(active))
    jg = jax.grad(j_fn, argnums=(0, 1))(jnp.asarray(sh), jnp.asarray(d))
    tsh, td = _t(sh, True), _t(d, True)
    tv = t_eval_sh(tsh, td, 3, active)
    tg = torch.autograd.grad(torch.sum(tv * _t(wts)), (tsh, td))
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-6, atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def _ssim_pair(shape, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


# the test image, one under the 11x11 window, a non-square odd size; the
# port's CPU path (band-matrix products, autograd) and the kernels' plain
# versions (the analytic two-pass backward)
@pytest.mark.parametrize("fn", [t_ssim_cm, ssim_cm_fused],
                         ids=["ssim_cm", "ssim_cm_fused"])
@pytest.mark.parametrize("shape", [(3, H, W), (1, 7, 9), (3, 33, 97)])
def test_ssim_matches(shape, fn):
    """The value, and the gradient into ``img0``, against JAX's
    ``value_and_grad`` of its SSIM."""
    a, b = _ssim_pair(shape)
    jv, jg = jax.value_and_grad(j_ssim_cm)(jnp.asarray(a), jnp.asarray(b))
    ta = _t(a, True)
    tv = fn(ta, _t(b))
    (tg,) = torch.autograd.grad(tv, ta)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), atol=5e-8)


def test_ssim_analytic_backward_gradcheck():
    """The analytic two-pass backward, into both images, against finite
    differences in float64 on a tiny image."""
    a, b = _ssim_pair((2, 6, 8), seed=2)
    ta = torch.tensor(a, dtype=torch.float64, requires_grad=True)
    tb = torch.tensor(b, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(ssim_cm_fused, (ta, tb))


def test_ssim_fused_matches_the_band_path():
    """The kernels' plain forward gives the CPU path's value bit for bit,
    and the analytic gradients into each image are within 1e-5 of the
    largest of autograd's through the band-matrix products (measured:
    1.3e-6, float32 rounding of two orders of the same sums)."""
    a, b = _ssim_pair((3, 24, 31), seed=3)
    grads = {}
    for fn in (ssim_cm_fused, ssim_cm_band):
        ta, tb = _t(a, True), _t(b, True)
        v = fn(ta, tb)
        grads[fn] = (v.detach(), *torch.autograd.grad(v, (ta, tb)))
    fused, band = grads[ssim_cm_fused], grads[ssim_cm_band]
    assert torch.equal(fused[0], band[0])
    for g, want in zip(fused[1:], band[1:]):
        torch.testing.assert_close(g, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


# --- binning -----------------------------------------------------------------

def test_bin_gaussians_matches(proj_inputs):
    p = proj_inputs
    cfg_j = jcfg.RasterizeConfig()
    jpr = j_project(p["means"], p["quats"], p["scales"],
                    *_cam_args(p["cam"], jnp.asarray), W, H, cfg_j,
                    opacities=p["opac"])
    tpr = t_project(*(_t(p[k]) for k in ("means", "quats", "scales")),
                    *_cam_args(p["cam"], _t), W, H, tcfg.RasterizeConfig(),
                    opacities=_t(p["opac"]))
    jb = j_bin(jpr, W, H, cfg_j)
    tb = t_bin(tpr, W, H, tcfg.RasterizeConfig())
    starts, counts = _np(tb.tile_starts), _np(tb.tile_counts)
    np.testing.assert_array_equal(starts, np.asarray(jb.tile_starts))
    np.testing.assert_array_equal(counts, np.asarray(jb.tile_counts))
    assert counts.sum() > 0
    # tie order within a tile is unspecified (unstable sort): compare sets
    jg, tg = np.asarray(jb.sorted_gauss), _np(tb.sorted_gauss)
    for s, c in zip(starts, counts):
        assert sorted(tg[s:s + c]) == sorted(jg[s:s + c])


# --- optimizer, densify, losses ----------------------------------------------

def test_fused_adam_matches():
    rng = np.random.default_rng(3)
    shapes = {"means": (64, 3), "quats": (64, 4), "log_scales": (64, 3),
              "logit_opacities": (64,), "sh_dc": (64, 3), "sh_rest": (64, 15, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    ocfg = jcfg.OptimConfig(means_lr_max_steps=10)
    jopt = make_optimizer(ocfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init(jp)
    topt = toptim.FusedAdam(tcfg.OptimConfig(means_lr_max_steps=10))
    tp = {k: _t(v) for k, v in params.items()}
    tst = topt.init(tp)
    for step in range(12):  # past means_lr_max_steps: the lr floor holds
        g = {k: rng.normal(size=s).astype(np.float32) * 10.0 ** (step % 3 - 1)
             for k, s in shapes.items()}
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst)
        jp = {k: jp[k] + upd[k] for k in jp}
        topt.step(tp, {k: _t(v) for k, v in g.items()}, tst)
    assert int(tst.count) == int(jst.count)
    for k in shapes:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(_np(tst.mu[k]), np.asarray(jst.mu[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(_np(tst.nu[k]), np.asarray(jst.nu[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    touched = np.zeros(64, bool)
    touched[::5] = True
    jst = reset_opt_slots(jst, jnp.asarray(touched), 64)
    toptim.reset_opt_slots(tst, torch.as_tensor(touched))
    for k in shapes:
        np.testing.assert_array_equal(_np(tst.mu[k]) == 0,
                                      np.asarray(jst.mu[k]) == 0)


def _densify_inputs(seed=4, C=256, n_alive=160):
    rng = np.random.default_rng(seed)
    jp = j_init_random(n=n_alive, capacity=C, sh_degree=1, seed=seed)
    quats = rng.normal(size=(C, 4)).astype(np.float32)
    jp = dataclasses.replace(
        jp, quats=jnp.asarray(quats),
        log_scales=jnp.asarray(rng.uniform(-6, -1, (C, 3)).astype(np.float32)),
        logit_opacities=jnp.asarray(rng.normal(0, 2, C).astype(np.float32)))
    stats = dict(
        grad_accum=rng.uniform(0, 0.004, C).astype(np.float32),
        grad_count=rng.integers(0, 10, C).astype(np.float32),
        max_radii=rng.uniform(0, 0.2, C).astype(np.float32))
    return jp, stats


@pytest.mark.parametrize("flags", [(True, True, False), (True, True, True),
                                   (False, False, False)])
def test_refine_matches_with_injected_noise(flags):
    do_densify, size_cull, screen = flags
    jp, stats = _densify_inputs()
    C = jp.capacity
    dcfg_j = jcfg.DensifyConfig()
    key = jax.random.PRNGKey(7)
    jparams, jstate, jtouched = jdens.refine(
        jp, jdens.DensifyState(**{k: jnp.asarray(v) for k, v in stats.items()}),
        key, dcfg_j, do_densify, size_cull, screen)
    # the JAX split noise, re-drawn from the same key
    noise, k = [], key
    for _ in range(max(1, dcfg_j.split_samples)):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (C, 3))))
    tp_in = dataclasses.replace(
        t_init_random(n=160, capacity=C, sh_degree=1, seed=4, device="cpu"),
        **{f: _t(getattr(jp, f)) for f in ("quats", "log_scales",
                                           "logit_opacities")})
    tparams, tstate, ttouched = tdens.refine(
        tp_in, tdens.DensifyState(**{k: _t(v) for k, v in stats.items()}),
        tcfg.DensifyConfig(), do_densify, size_cull, screen,
        split_noise=_t(np.stack(noise)))
    np.testing.assert_array_equal(_np(ttouched), np.asarray(jtouched))
    np.testing.assert_array_equal(_np(tparams.alive), np.asarray(jparams.alive))
    assert int(_np(ttouched).sum()) > 0 or not do_densify
    for f in ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
              "sh_rest"):
        np.testing.assert_allclose(_np(getattr(tparams, f)),
                                   np.asarray(getattr(jparams, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    assert float(tstate.grad_accum.abs().sum()) == 0.0


def test_update_stats_and_reset_opacities_match():
    rng = np.random.default_rng(9)
    C = 128
    g2 = rng.normal(size=(C, 2)).astype(np.float32)
    radii = rng.uniform(0, 30, C).astype(np.float32)
    vis = rng.uniform(size=C) > 0.3
    base = {k: rng.uniform(0, 1, C).astype(np.float32)
            for k in ("grad_accum", "grad_count", "max_radii")}
    js = jdens.update_stats(jdens.DensifyState(**base), jnp.asarray(g2),
                            jnp.asarray(radii), jnp.asarray(vis), W, H)
    ts = tdens.update_stats(tdens.DensifyState(**{k: _t(v) for k, v in base.items()}),
                            _t(g2), _t(radii), _t(vis), W, H)
    for k in base:
        np.testing.assert_allclose(_np(getattr(ts, k)), np.asarray(getattr(js, k)),
                                   rtol=1e-6, err_msg=k)
    jp = j_init_random(n=50, capacity=64, seed=1)
    jp = dataclasses.replace(jp, logit_opacities=jnp.linspace(-3, 3, 64))
    tp = dataclasses.replace(t_init_random(n=50, capacity=64, seed=1, device="cpu"),
                             logit_opacities=torch.linspace(-3, 3, 64))
    np.testing.assert_allclose(
        _np(tdens.reset_opacities(tp, 0.2).logit_opacities),
        np.asarray(jdens.reset_opacities(jp, 0.2).logit_opacities), rtol=1e-6)


@pytest.mark.parametrize("form", ["inv", "inv_sq", "exp", "simple"])
def test_depth_loss_matches(form):
    rng = np.random.default_rng(2)
    rd = rng.uniform(0.5, 3, (H, W)).astype(np.float32)
    td = np.where(rng.uniform(size=(H, W)) > 0.2,
                  rng.uniform(0.5, 3, (H, W)), 0).astype(np.float32)
    unc = rng.uniform(0, 2, (H, W)).astype(np.float32)
    if form == "simple":
        kw = dict(depth_loss_type=jcfg.DepthLossType.SIMPLE_LOSS)
        tkw = dict(depth_loss_type=tcfg.DepthLossType.SIMPLE_LOSS)
    else:
        kw = tkw = dict(uncertainty_form=form, uncertainty_weight=0.7)
    jv = j_depth_loss(jnp.asarray(rd), jnp.asarray(td), jnp.asarray(unc),
                      jcfg.DepthLossConfig(**kw))
    tv = t_depth_loss(_t(rd), _t(td), _t(unc), tcfg.DepthLossConfig(**tkw))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)


def test_unknown_uncertainty_form_raises():
    """Deliberate deviation (ROADMAP.md C5): the JAX package falls through
    to inv_sq; the port rejects an unknown form."""
    x = torch.ones((4, 4))
    with pytest.raises(ValueError, match="uncertainty_form"):
        t_depth_loss(x, x, x, tcfg.DepthLossConfig(uncertainty_form="bogus"))
