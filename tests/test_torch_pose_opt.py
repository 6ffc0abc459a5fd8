"""The SO3xR3 pose optimizer (``touchgs_torch/models/pose_opt.py`` and the
trainer's pose deltas) against the JAX package's, on the CPU: ``exp_so3``
and ``apply_pose_delta`` within 1e-6 at θ = 0, 1e-7 and large angles, with
finite gradients at θ = 0 (the double-where guard), then three trainer
steps with ``--camera-optimizer SO3xR3`` through the tile path (JAX:
Pallas interpreted; the port: the kernels' plain versions) from the JAX
trainer's state."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.data.cameras import Camera as JCamera
from touchgs_tpu.data.cameras import Cameras as JCameras
from touchgs_tpu.data.scene import Scene as JScene
from touchgs_tpu.models import pose_opt as jpo
from touchgs_tpu.train import trainer as jtr
from touchgs_torch.data.cameras import Cameras as TCameras
from touchgs_torch.data.scene import Scene as TScene
from touchgs_torch.models import pose_opt as tpo
from touchgs_torch.train import trainer as ttr

from tests.test_torch_train import CAP, _cfg, _leaves, _scene, _scene_arrays

STEPS = 3
ANGLES = [0.0, 1e-7, 1e-3, 0.3, 2.5, 3.1, 10.0]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one intra-op thread for this module: the suite runs
    several workers on the same cores, where each worker's threads would
    wait on the others' (and the CPU renders' results do not depend on it).
    The count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _omega(theta: float, seed: int) -> np.ndarray:
    d = np.random.default_rng(seed).normal(size=3)
    return (theta * d / np.linalg.norm(d)).astype(np.float32)


@pytest.mark.parametrize("theta", ANGLES)
def test_exp_so3_matches_jax(theta):
    w = _omega(theta, 0)
    got = tpo.exp_so3(torch.as_tensor(w)).numpy()
    want = np.asarray(jpo.exp_so3(jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-5)


@pytest.mark.parametrize("theta", [0.0, 1e-7, 0.3, 2.5])
def test_gradient_matches_jax_and_is_finite_at_zero(theta):
    """d/dω of Σ exp(ω)·G for a fixed G: finite at θ = 0 exactly, where
    every pose delta starts, and JAX's within 1e-6."""
    w = _omega(theta, 1)
    g = np.random.default_rng(2).normal(size=(3, 3)).astype(np.float32)
    wt = torch.as_tensor(w).requires_grad_(True)
    (tpo.exp_so3(wt) * torch.as_tensor(g)).sum().backward()
    jg = jax.grad(lambda o: jnp.sum(jpo.exp_so3(o) * g))(jnp.asarray(w))
    assert bool(torch.isfinite(wt.grad).all())
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jg), atol=1e-6)


def test_apply_pose_delta_matches_jax():
    rng = np.random.default_rng(3)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.asarray(jpo.exp_so3(jnp.asarray(_omega(1.1, 4))))
    c2w[:3, 3] = rng.normal(size=3)
    for tau in (np.zeros(6, np.float32),
                np.r_[rng.normal(0, 0.01, 3), _omega(0.05, 5)].astype(
                    np.float32)):
        s = dict(fx=200.0, fy=210.0, cx=32.0, cy=24.0)
        jc = JCamera(**{k: jnp.float32(v) for k, v in s.items()},
                     c2w=jnp.asarray(c2w), width=64, height=48)
        tc = TCameras(**{k: np.array([v], np.float32) for k, v in s.items()},
                      c2w=c2w[None], width=64, height=48).at(0, "cpu")
        got = tpo.apply_pose_delta(tc, torch.as_tensor(tau))
        want = jpo.apply_pose_delta(jc, jnp.asarray(tau))
        np.testing.assert_allclose(got.c2w.numpy(), np.asarray(want.c2w),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.w2c.numpy(), np.asarray(want.w2c),
                                   atol=1e-5, rtol=0)


def _pose_cfg(mod):
    return dataclasses.replace(_cfg(mod),
                               pose_opt=mod.PoseOptConfig(mode="SO3xR3"))


def _full_arrays():
    """tests/test_torch_train.py's scene with as many seeds as slots: the
    JAX trainer's pose deltas turn NaN once a dead slot exists (ROADMAP.md
    C21), so the parity runs with none."""
    arrays = _scene_arrays()
    rng = np.random.default_rng(11)
    arrays["points"] = rng.uniform(-0.5, 0.5, (CAP, 3)).astype(np.float32)
    arrays["colors"] = rng.uniform(0, 1, (CAP, 3)).astype(np.float32)
    return arrays


def test_trainer_steps_match_jax():
    """Three ``Trainer.run`` steps with the pose optimizer, the port from
    the JAX trainer's initial state: per-step loss and PSNR
    within rtol 1e-3 (as tests/test_torch_train.py), the pose deltas and
    their Adam moments within the gradient tolerance 5e-6."""
    arrays = _full_arrays()
    jt = jtr.Trainer(_scene(arrays, JCameras, JScene), _pose_cfg(jcfg))
    tt = ttr.Trainer(_scene(arrays, TCameras, TScene), _pose_cfg(tcfg),
                     device="cpu")
    leaves = _leaves(jt.state)
    leaves["pose_deltas"] = np.asarray(jt.state.pose_deltas)
    assert leaves["pose_deltas"].shape == (len(arrays["fx"]), 6)
    tt.state = ttr.state_from_numpy(leaves, "cpu")
    assert bool(tt.state.params.alive.all())
    assert set(tt.state.opt_state.mu) == set(leaves["mu"]) >= {"pose_deltas"}
    jlog, tlog = [], []
    jt.run(STEPS, log_fn=jlog.append)
    tt.run(STEPS, log_fn=tlog.append)
    for key in ("loss", "psnr"):
        np.testing.assert_allclose([m[key] for m in tlog],
                                   [m[key] for m in jlog], rtol=1e-3,
                                   err_msg=key)
    got = tt.state.pose_deltas.numpy()
    want = np.asarray(jt.state.pose_deltas)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
    for moments in ("mu", "nu"):
        np.testing.assert_allclose(
            getattr(tt.state.opt_state, moments)["pose_deltas"].numpy(),
            np.asarray(getattr(jt.state.opt_state, moments)["pose_deltas"]),
            atol=5e-6, rtol=0, err_msg=moments)


def test_dead_slots_keep_pose_deltas_finite():
    """With dead slots (300 seeds in 512), the port's pose deltas stay
    finite where the JAX trainer's turn NaN (ROADMAP.md C21)."""
    arrays = _scene_arrays()
    jt = jtr.Trainer(_scene(arrays, JCameras, JScene), _pose_cfg(jcfg))
    tt = ttr.Trainer(_scene(arrays, TCameras, TScene), _pose_cfg(tcfg),
                     device="cpu")
    jt.run(STEPS)
    log = []
    tt.run(STEPS, log_fn=log.append)
    assert not np.isfinite(np.asarray(jt.state.pose_deltas)).all()
    got = tt.state.pose_deltas.numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert all(np.isfinite(m["loss"]) for m in log)


def test_pose_deltas_survive_growth_and_refine():
    """``grow_state`` pads the Gaussians' moments and keeps the cameras'
    pose deltas; a refine zeroes only the Gaussian slots it rewrote."""
    arrays = _scene_arrays()
    tt = ttr.Trainer(_scene(arrays, TCameras, TScene), _pose_cfg(tcfg),
                     device="cpu")
    tt.run(2)
    before = tt.state.pose_deltas.clone()
    mu_before = tt.state.opt_state.mu["pose_deltas"].clone()
    grown = ttr.grow_state(tt.state, 2 * tt.state.params.capacity)
    assert grown.params.capacity == 2 * tt.state.params.capacity
    assert torch.equal(grown.pose_deltas, before)
    assert torch.equal(grown.opt_state.mu["pose_deltas"], mu_before)
    refined = ttr.refine_state(grown, tt.cfg, generator=tt.generator)
    assert torch.equal(refined.opt_state.mu["pose_deltas"], mu_before)
