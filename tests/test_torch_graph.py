"""The graphed train step's CPU side (``touchgs_torch/train/graphs.py``).

A CUDA graph cannot be captured on the CPU, so this holds what the capture
relies on: the step's device work asks the host for nothing (no sync, no
host data), the state keeps its tensors through steps, refine and the
opacity reset (the graph reads and writes them in place), and that
in-place path still trains as the JAX package's jitted, donated
``make_train_step``, ``make_refine_step`` and ``make_reset_opacity_step``.
The capture itself is held on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py --graph``).  One scene of 3 views at 64x64, 400 seeds,
capacity 1024, SH degree 1, the tile kernels' path (their plain versions
here; JAX's Pallas kernels in interpret mode).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.data.cameras import Cameras as JCameras
from touchgs_tpu.data.scene import Scene as JScene
from touchgs_tpu.train import trainer as jtr
from touchgs_torch.data.cameras import Cameras as TCameras
from touchgs_torch.data.scene import Scene as TScene
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.train import trainer as ttr
from touchgs_torch.train.graphs import GraphedStep, state_tensors

from tests.synthetic import look_at_camera

W = H = 64
N_VIEWS, N_SEED, CAP, SH = 3, 400, 1024, 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one intra-op thread for this module (restored after
    it), as in ``tests/test_torch_hard_scene.py``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(4)
    cams = [look_at_camera(eye=(2.0 * np.cos(a), 0.5, 2.0 * np.sin(a)),
                           width=W, height=H, focal=60.0)
            for a in np.linspace(0.2, 1.2, N_VIEWS)]
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
                     transform=np.eye(4)[:3], name="graph")


def _cfg(mod):
    return mod.TrainConfig(model=mod.ModelConfig(
        max_gaussians=CAP, sh_degree=SH,
        rasterize=mod.RasterizeConfig(use_pallas=True)), seed=0)


def _trainer(arrays):
    tt = ttr.Trainer(_scene(arrays, TCameras, TScene), _cfg(tcfg),
                     device="cpu")
    assert tt.state.params.capacity == CAP
    assert isinstance(tt.train_step, GraphedStep)
    return tt


class _Recorder(TorchDispatchMode):
    """Records every aten op that runs, but those of the tile kernels'
    plain versions, which stand for one kernel launch each on the card."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _host_ops(ops) -> list:
    """The ops of ``ops`` that wait for the device or copy host data in."""
    return [op for op in ops if op.split(".")[1] in (
        "_local_scalar_dense", "nonzero") or op.startswith("aten.lift_fresh")]


def test_step_asks_the_host_for_nothing(arrays, monkeypatch):
    """(i) After one warm step, a second step runs with ``torch.tensor``,
    ``torch.as_tensor`` and ``torch.from_numpy`` raising and under a
    dispatch mode: it calls no ``aten._local_scalar_dense`` (a read to the
    host), no ``aten.nonzero`` and no ``aten.lift_fresh*`` (a tensor from
    host data), outside the tile kernels' plain versions.  The mode does
    see a read when there is one."""
    tt = _trainer(arrays)
    step = tt.train_step
    batch = tt._batch(0)
    tt.state, _ = step(tt.state, *batch, SH)
    rec = _Recorder()

    def exempt(fn):
        def run(*args, **kw):
            rec.paused += 1
            try:
                return fn(*args, **kw)
            finally:
                rec.paused -= 1
        return run

    for name in ("slot_rows_plain", "forward_tiles_plain",
                 "backward_tiles_plain"):
        monkeypatch.setattr(plain, name, exempt(getattr(plain, name)))

    def host_data(*args, **kw):
        raise AssertionError("the step made a tensor from host data")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, host_data)
    with rec:
        tt.state, metrics = step(tt.state, *batch, SH)
    monkeypatch.undo()
    assert tt.state.step == 2 and np.isfinite(float(metrics["loss"]))
    assert "aten.sort.stable" in rec.ops or "aten.sort.default" in rec.ops
    assert "aten._index_put_impl_.default" in rec.ops   # K1's backward
    assert not _host_ops(rec.ops), _host_ops(rec.ops)
    with _Recorder() as probe:
        int(torch.ones(2).sum())
    assert _host_ops(probe.ops) == ["aten._local_scalar_dense.default"]


def test_state_keeps_its_tensors(arrays):
    """(ii) Donation: through 3 steps, a refine and an opacity reset every
    tensor of the state keeps its storage (``data_ptr``), and the refine
    and the reset did change it; ``grow_state`` is the one exception."""
    tt = _trainer(arrays)
    state = tt.state
    ptrs = [t.data_ptr() for t in state_tensors(state)]
    for view in range(3):
        state, _ = tt.train_step(state, *tt._batch(view), SH)
    assert [t.data_ptr() for t in state_tensors(state)] == ptrs
    alive = int(state.params.num_alive)
    refined = ttr.refine_state(state, tt.cfg, True, True, False,
                               generator=tt.generator)
    assert refined is state and int(state.params.num_alive) != alive
    before = state.params.logit_opacities.clone()
    reset = ttr.reset_opacity_state(state, tt.cfg)
    assert reset is state
    assert not torch.equal(state.params.logit_opacities, before)
    assert [t.data_ptr() for t in state_tensors(state)] == ptrs
    grown = ttr.grow_state(state, 2 * CAP)
    assert all(a != b for a, b in zip(
        (t.data_ptr() for t in state_tensors(grown)[:7]), ptrs))


def _leaves(state) -> dict:
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


def test_in_place_path_matches_jax_jitted_steps(arrays):
    """(iii) 3 steps, a refine (JAX's split noise injected), an opacity
    reset and 3 more steps of the port's in-place path against JAX's
    jitted, donated ``make_train_step``, ``make_refine_step`` and
    ``make_reset_opacity_step`` from the same state: each step's loss and
    PSNR within rtol 1e-3, the refine leaves as many Gaussians alive in
    both, and the reset caps both packages' opacities.  (The parameters
    themselves drift apart by up to Adam's 2·lr where a gradient is
    float32 noise, as ``tests/test_torch_train.py`` says.)"""
    jc, tc = _cfg(jcfg), _cfg(tcfg)
    jt = jtr.Trainer(_scene(arrays, JCameras, JScene), jc)
    tt = _trainer(arrays)
    tt.state = ttr.state_from_numpy(_leaves(jt.state), "cpu")
    jstep = jtr.make_train_step(jc, jt.optimizer)
    tstep = tt.train_step
    js, ts = jt.state, tt.state
    got = {"j": [], "t": []}

    def steps(views):
        nonlocal js, ts
        for v in views:
            js, jm = jstep(js, *jt._batch(v), SH)
            ts, tm = tstep(ts, *tt._batch(v), SH)
            got["j"].append((float(jm["loss"]), float(jm["psnr"])))
            got["t"].append((float(tm["loss"]), float(tm["psnr"])))

    steps([0, 1, 2])
    key = jax.random.PRNGKey(3)
    noise, k = [], key
    for _ in range(max(1, jc.densify.split_samples)):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (CAP, 3))))
    alive = int(ts.params.num_alive)
    js = jtr.make_refine_step(jc)(js, key, True, True, False)
    ts = ttr.refine_state(ts, tc, True, True, False,
                          split_noise=torch.as_tensor(np.stack(noise)))
    assert int(ts.params.num_alive) == int(js.params.num_alive) != alive
    js = jtr.make_reset_opacity_step(jc)(js)
    ts = ttr.reset_opacity_state(ts, tc)
    cap = np.log(jc.densify.reset_opacity_value
                 / (1 - jc.densify.reset_opacity_value))
    for x in (ts.params.logit_opacities.numpy(),
              np.asarray(js.params.logit_opacities)):
        assert x.max() <= cap + 1e-6
    steps([1, 2, 0])
    j, t = np.array(got["j"]), np.array(got["t"])
    np.testing.assert_allclose(t, j, rtol=1e-3)
    print(f"loss, psnr over 6 steps: max relative gap "
          f"{np.max(np.abs(t - j) / np.abs(j), axis=0)}")
    assert ts.step == int(js.step) == 6
