"""The port's multi-scene training (``touchgs_torch/parallel/
multiscene.py``, ``Cameras.stacked``) against the JAX package's on the
CPU, at ``tests/test_multiscene.py``'s batch: S = 4 scenes of 100 seeds
in a capacity of 256, SH degree 1, 64x48 views.

- The batched step against JAX's over 3 steps: the mean loss and each
  scene's PSNR within rtol 1e-3 (the trainers' own tolerance,
  ``tests/test_torch_train.py``).
- The 1-vs-N parity against the port's own single-scene step, on the scan
  path and on the tile kernels' path (one launch of each kernel for all
  scenes; their plain versions here): each scene's loss within rtol 1e-4
  and its parameters within atol 1e-5 (``tests/test_sharded.py:52-61``),
  its densify statistics too.
- Refine per scene with JAX's split noise injected, on JAX's state: the
  parameters, the alive masks and the per-scene Adam-moment reset.
- ``run_multiscene`` densifies per scene.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.data.cameras import Cameras as JCameras
from touchgs_tpu.models.gaussians import init_from_points as j_init
from touchgs_tpu.parallel import multiscene as jms
from touchgs_tpu.train.optim import make_optimizer
from touchgs_torch.data.cameras import Camera, Cameras as TCameras
from touchgs_torch.models.densify import DensifyState
from touchgs_torch.models.gaussians import params_from_numpy
from touchgs_torch.parallel import multiscene as tms
from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam
from touchgs_torch.train.trainer import (TrainState, make_train_step,
                                         state_from_numpy)

from tests.synthetic import look_at_camera, random_gaussians
from tests.test_torch_train import _leaves

S, W, H, CAP = 4, 64, 48, 256


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(mod, use_pallas=False, **kw):
    return mod.TrainConfig(model=mod.ModelConfig(
        max_gaussians=CAP, sh_degree=1,
        rasterize=mod.RasterizeConfig(gaussian_chunk=64,
                                      use_pallas=use_pallas)), **kw)


@pytest.fixture(scope="module")
def batch():
    """JAX's params, cameras and targets, and the port's from the same
    numpy arrays."""
    jparams = []
    for i in range(S):
        means, _, _, colors, _ = random_gaussians(100, seed=i)
        jparams.append(j_init(np.asarray(means), np.asarray(colors),
                              capacity=CAP, sh_degree=1, seed=i))
    jcams = [look_at_camera(eye=(1.5, i * 0.3, 1.0), width=W, height=H)
             for i in range(S)]
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (S, H, W, 3)).astype(np.float32)
    depths = rng.uniform(1, 3, (S, H, W)).astype(np.float32)
    uncs = np.ones((S, H, W), np.float32)
    tparams = [params_from_numpy({f.name: np.asarray(getattr(p, f.name))
                                  for f in dataclasses.fields(p)}, "cpu")
               for p in jparams]
    tcams = [Camera(fx=torch.tensor(np.asarray(c.fx)),
                    fy=torch.tensor(np.asarray(c.fy)),
                    cx=torch.tensor(np.asarray(c.cx)),
                    cy=torch.tensor(np.asarray(c.cy)),
                    c2w=torch.tensor(np.asarray(c.c2w)), width=W, height=H)
             for c in jcams]
    return dict(jparams=jparams, jcams=jcams, tparams=tparams, tcams=tcams,
                images=images, depths=depths, uncs=uncs)


def _targets(b):
    return tuple(torch.tensor(b[k]) for k in ("images", "depths", "uncs"))


def test_cameras_stacked_matches_jax(batch):
    rng = np.random.default_rng(3)
    arrays = dict(fx=rng.uniform(50, 90, 5), fy=rng.uniform(50, 90, 5),
                  cx=rng.uniform(20, 40, 5), cy=rng.uniform(20, 30, 5),
                  c2w=rng.normal(size=(5, 4, 4)))
    j = JCameras(**arrays, width=W, height=H).stacked()
    t = TCameras(**arrays, width=W, height=H).stacked("cpu")
    for k in ("fx", "fy", "cx", "cy", "c2w"):
        assert getattr(t, k).dtype == torch.float32
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)))
    assert (t.width, t.height) == (j.width, j.height)
    stacked = tms.stack_cameras(batch["tcams"])
    for s in range(S):
        cam = tms.camera_at(stacked, s)
        for k in ("fx", "fy", "cx", "cy", "c2w"):
            assert torch.equal(getattr(cam, k), getattr(batch["tcams"][s], k))
    with pytest.raises(ValueError, match="resolution"):
        tms.stack_cameras([batch["tcams"][0],
                           dataclasses.replace(batch["tcams"][1], width=32)])


def test_step_matches_jax(batch):
    jc, tc = _cfg(jcfg), _cfg(tcfg)
    jopt = make_optimizer(jc.optim)
    jstate = jms.make_multiscene_state(batch["jparams"], jc, jopt)
    jstep = jms.make_multiscene_train_step(jc, jopt)
    jcams = jms.stack_cameras(batch["jcams"])
    topt = FusedAdam(tc.optim)
    tstate = tms.make_multiscene_state(copy.deepcopy(batch["tparams"]), tc,
                                       topt)
    tstep = tms.make_multiscene_train_step(tc, topt)
    tcams = tms.stack_cameras(batch["tcams"])
    args = (batch["images"], batch["depths"], batch["uncs"])
    for _ in range(3):
        jstate, jm = jstep(jstate, jcams, *(jnp.asarray(a) for a in args),
                           jnp.int32(1))
        tstate, tm = tstep(tstate, tcams, *_targets(batch), 1)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(tm["psnr_per_scene"].numpy(),
                                   np.asarray(jm["psnr_per_scene"]),
                                   rtol=1e-3)
    assert tstate.step == 3 and int(tstate.opt_state.count) == 3
    alive = np.asarray(jstate.params.alive)
    np.testing.assert_allclose(tstate.params.means.numpy()[alive],
                               np.asarray(jstate.params.means)[alive],
                               atol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["scan", "tile_kernels"])
def test_step_parity_vs_single_scene(batch, use_pallas):
    """Each scene of the batched step trains as the single-scene step
    trains it alone: the loss summed over scenes differentiates to each
    scene's own gradient."""
    cfg = _cfg(tcfg, use_pallas)
    opt = FusedAdam(cfg.optim)
    ms = tms.make_multiscene_state(copy.deepcopy(batch["tparams"]), cfg, opt)
    ms_step = tms.make_multiscene_train_step(cfg, opt)
    cams = tms.stack_cameras(batch["tcams"])
    images, depths, uncs = _targets(batch)
    for _ in range(2):
        ms, mm = ms_step(ms, cams, images, depths, uncs, 1)
    single = make_train_step(cfg, opt)
    for s in range(S):
        p = copy.deepcopy(batch["tparams"][s])
        st = TrainState(params=p, opt_state=opt.init(
            {g: getattr(p, g) for g in PARAM_GROUPS}),
            densify=DensifyState.zeros(CAP, "cpu"), step=0)
        for _ in range(2):
            st, m = single(st, batch["tcams"][s], images[s], depths[s],
                           uncs[s], 1)
        alive = st.params.alive
        np.testing.assert_allclose(float(mm["psnr_per_scene"][s]),
                                   float(m["psnr"]), rtol=1e-4)
        for g in PARAM_GROUPS:
            np.testing.assert_allclose(getattr(ms.params, g)[s][alive].numpy(),
                                       getattr(st.params, g)[alive].numpy(),
                                       atol=1e-5, err_msg=g)
        for f in ("grad_accum", "grad_count", "max_radii"):
            np.testing.assert_allclose(getattr(ms.densify, f)[s].numpy(),
                                       getattr(st.densify, f).numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=f)


def test_refine_matches_jax(batch):
    """From JAX's batched state after 3 steps, the port's per-scene refine
    with JAX's split noise injected equals JAX's vmapped refine."""
    jc, tc = _cfg(jcfg), _cfg(tcfg)
    jopt = make_optimizer(jc.optim)
    jstate = jms.make_multiscene_state(batch["jparams"], jc, jopt)
    jstep = jms.make_multiscene_train_step(jc, jopt)
    jcams = jms.stack_cameras(batch["jcams"])
    for _ in range(3):
        jstate, _ = jstep(jstate, jcams, jnp.asarray(batch["images"]),
                          jnp.asarray(batch["depths"]),
                          jnp.asarray(batch["uncs"]), jnp.int32(1))
    tstate = state_from_numpy(_leaves(jstate), "cpu")
    keys = jax.random.split(jax.random.PRNGKey(7), S)
    noise = []
    for s in range(S):
        k, scene = keys[s], []
        for _ in range(max(1, jc.densify.split_samples)):
            k, sub = jax.random.split(k)
            scene.append(np.asarray(jax.random.normal(sub, (CAP, 3))))
        noise.append(np.stack(scene))
    before = tstate.params.alive.sum(dim=-1)
    mu_before = tstate.opt_state.mu["means"].clone()
    jref = jms.make_multiscene_refine_step(jc)(
        jax.tree.map(jnp.copy, jstate), keys, True, True, False)
    tref = tms.make_multiscene_refine_step(tc)(
        tstate, None, True, True, False,
        split_noise=torch.tensor(np.stack(noise)))
    np.testing.assert_array_equal(tref.params.alive.numpy(),
                                  np.asarray(jref.params.alive))
    alive = np.asarray(jref.params.alive)
    for g in ("means", "log_scales", "sh_dc"):
        np.testing.assert_allclose(getattr(tref.params, g).numpy()[alive],
                                   np.asarray(getattr(jref.params, g))[alive],
                                   atol=1e-6, err_msg=g)
    for k in ("mu", "nu"):
        np.testing.assert_allclose(
            getattr(tref.opt_state, k)["means"].numpy()[alive],
            np.asarray(getattr(jref.opt_state, k)["means"])[alive],
            atol=1e-7, err_msg=k)
    after = tref.params.alive.sum(dim=-1)
    assert (after != before).any(), "the refine changed no scene"
    touched = (tref.opt_state.mu["means"] == 0).all(-1) \
        & (mu_before != 0).any(-1)
    assert touched.any(), "no Adam moment was reset"
    assert not tref.densify.grad_accum.any()


def test_run_multiscene_densifies_per_scene(batch):
    cfg = _cfg(tcfg, densify=tcfg.DensifyConfig(
        warmup_steps=2, refine_every=4, stop_refine_at=100,
        reset_opacity_every=10 ** 6, grad_threshold=1e-6), log_every=10)
    opt = FusedAdam(cfg.optim)
    state = tms.make_multiscene_state(copy.deepcopy(batch["tparams"]), cfg,
                                      opt)
    alive0 = state.params.alive.sum(dim=-1)
    cams = tms.stack_cameras(batch["tcams"])
    targets = _targets(batch)
    logs = []
    state, metrics = tms.run_multiscene(
        state, cfg, tms.make_multiscene_train_step(cfg, opt),
        lambda step, rng: (cams, *targets, 1), steps=13, n_train_views=1,
        log_fn=logs.append)
    alive1 = state.params.alive.sum(dim=-1)
    assert (alive1 != alive0).any(), "densification never fired"
    assert len(set(alive1.tolist())) > 1, "the scenes densified alike"
    assert [m["step"] for m in logs] == [0, 10, 12]
    assert logs[-1]["alive_per_scene"] == alive1.tolist()
    assert np.isfinite(float(metrics["loss"]))
    spec = tms.multiscene_shardings(state)
    assert spec["params.means"] == ("data", "model")
    assert spec["opt_state.count"] == () and spec["step"] == ()
