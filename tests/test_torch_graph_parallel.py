"""The other graphed train steps' CPU side: the SO3xR3 pose step, the
``tile_shards`` step, ``make_sharded_train_step`` and the multi-scene step
with and without a mesh (``touchgs_torch/train/graphs.py``).

A CUDA graph cannot be captured on the CPU, so this holds what each
capture relies on, as ``tests/test_torch_graph.py`` does for the
single-scene step: the step's device work asks the host for nothing, the
multi-scene state keeps its tensors through steps, a refine and the
opacity reset, which ``make_*`` returns a ``GraphedStep``, and that the
in-place paths still train as the JAX package's jitted, donated steps.
The captures themselves are held on the card
(``tests/test_torch_cuda.py``).  Sizes as in
``tests/test_torch_graph.py``: 3 views at 64x64, capacity 1024, SH degree
1, the tile kernels' path (their plain versions here; JAX's Pallas kernels
in interpret mode); the multi-scene parity at
``tests/test_torch_multiscene.py``'s batch (4 scenes of 64x48, capacity
256).
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
from touchgs_tpu.data.scene import Scene as JScene
from touchgs_tpu.parallel import multiscene as jms
from touchgs_tpu.train import trainer as jtr
from touchgs_tpu.train.optim import make_optimizer
from touchgs_torch.data.cameras import Cameras as TCameras
from touchgs_torch.data.scene import Scene as TScene
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.parallel import multiscene as tms
from touchgs_torch.parallel.mesh import make_mesh
from touchgs_torch.parallel.sharded import make_sharded_train_step, shard_state
from touchgs_torch.train import trainer as ttr
from touchgs_torch.train.graphs import GraphedStep, state_tensors, view_index
from touchgs_torch.train.optim import FusedAdam

from tests.test_torch_graph import (CAP, SH, _Recorder, _cfg, _host_ops,
                                    _leaves, _scene)
from tests.test_torch_graph import arrays  # noqa: F401  (a fixture)
from tests.test_torch_multiscene import CAP as MS_CAP
from tests.test_torch_multiscene import S as MS_S
from tests.test_torch_multiscene import _cfg as _ms_cfg
from tests.test_torch_multiscene import (_jax_split_noise, _make_batch,
                                         _targets)

SHARDS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one intra-op thread for this module (restored after
    it), as in ``tests/test_torch_graph.py``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def full(arrays):  # noqa: F811
    """``arrays`` with as many seeds as slots: the JAX trainer's pose
    deltas turn NaN once a dead slot exists (ROADMAP.md C21), so the pose
    parity runs with none."""
    rng = np.random.default_rng(12)
    return dict(arrays,
                points=rng.uniform(-0.5, 0.5, (CAP, 3)).astype(np.float32),
                colors=rng.uniform(0, 1, (CAP, 3)).astype(np.float32))


def _pose_cfg(mod):
    return dataclasses.replace(_cfg(mod),
                               pose_opt=mod.PoseOptConfig(mode="SO3xR3"))


def _trainer(a, cfg) -> ttr.Trainer:
    tt = ttr.Trainer(_scene(a, TCameras, TScene), cfg, device="cpu")
    assert tt.state.params.capacity == CAP
    return tt


def _multiscene(a, mesh=None):
    """Two scenes (the trainer's Gaussians and a copy), a stacked batch of
    views 0 and 1, and the multi-scene step; with ``mesh`` the state is
    placed on it."""
    cfg = _cfg(tcfg)
    tt = _trainer(a, cfg)
    state = tms.make_multiscene_state(
        [tt.state.params, copy.deepcopy(tt.state.params)], cfg, tt.optimizer)
    if mesh is not None:
        state = tms.shard_multiscene_state(state, mesh)
    batches = [tt._batch(v) for v in (0, 1)]
    args = (tms.stack_cameras([b[0] for b in batches]),
            *(torch.stack([b[k] for b in batches]) for k in (1, 2, 3)), SH)
    return (tms.make_multiscene_train_step(cfg, tt.optimizer, mesh), state,
            args, cfg)


def _case(name: str, a: dict):
    """(step, state, args) of one graphed step on the CPU."""
    if name == "pose":
        tt = _trainer(a, _pose_cfg(tcfg))
        return tt.train_step, tt.state, (*tt._batch(1), SH, tt.view_index(1))
    tt = _trainer(a, _cfg(tcfg))
    args = (*tt._batch(0), SH)
    if name == "tile_shards":
        return (ttr.make_train_step(tt.cfg, tt.optimizer, tile_shards=SHARDS),
                tt.state, args)
    if name == "sharded":
        mesh = make_mesh()
        assert mesh.size == 1 and mesh.group is None
        return (make_sharded_train_step(tt.cfg, mesh, tt.optimizer),
                shard_state(tt.state, mesh), args)
    step, state, args, _ = _multiscene(
        a, make_mesh(data=1, model=1) if name == "multiscene_mesh" else None)
    return step, state, args


CASES = ("pose", "tile_shards", "sharded", "multiscene", "multiscene_mesh")


@pytest.mark.parametrize("name", CASES)
def test_step_asks_the_host_for_nothing(name, full, monkeypatch):
    """(i) After one warm step, a second step of each graphed step runs
    under ``tests/test_torch_graph.py``'s dispatch mode with
    ``torch.tensor``, ``torch.as_tensor`` and ``torch.from_numpy``
    raising: no ``aten._local_scalar_dense``, no ``aten.nonzero`` and no
    ``aten.lift_fresh*`` outside the tile kernels' plain versions.  The
    pose step takes its view as a tensor, the sharded and mesh steps run
    on a groupless world of one."""
    step, state, args = _case(name, full)
    assert isinstance(step, GraphedStep)
    state, _ = step(state, *args)
    rec = _Recorder()

    def exempt(fn):
        def run(*a, **kw):
            rec.paused += 1
            try:
                return fn(*a, **kw)
            finally:
                rec.paused -= 1
        return run

    for fn in ("slot_rows_plain", "forward_tiles_plain",
               "backward_tiles_plain"):
        monkeypatch.setattr(plain, fn, exempt(getattr(plain, fn)))

    def host_data(*a, **kw):
        raise AssertionError("the step made a tensor from host data")

    for fn in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, fn, host_data)
    with rec:
        state, metrics = step(state, *args)
    monkeypatch.undo()
    assert state.step == 2 and np.isfinite(float(metrics["loss"]))
    assert "aten._index_put_impl_.default" in rec.ops   # K1's backward
    if name == "pose":
        assert "aten.index_select.default" in rec.ops
    assert not _host_ops(rec.ops), _host_ops(rec.ops)


def test_multiscene_state_keeps_its_tensors(full):
    """(ii) Donation: every tensor of a multi-scene state keeps its storage
    through 3 steps, a refine and an opacity reset, which return the state
    itself and did change it."""
    step, state, args, cfg = _multiscene(full)
    ptrs = [t.data_ptr() for t in state_tensors(state)]
    for _ in range(3):
        state, _ = step(state, *args)
    assert [t.data_ptr() for t in state_tensors(state)] == ptrs
    alive = state.params.alive.sum(dim=-1)
    refined = tms.make_multiscene_refine_step(cfg)(
        state, tms.scene_generators(0, 2, "cpu"), True, True, False)
    assert refined is state
    assert not torch.equal(state.params.alive.sum(dim=-1), alive)
    state.params.logit_opacities[:, :16] = 0.0   # above the reset's cap
    before = state.params.logit_opacities.clone()
    assert tms.make_multiscene_reset_opacity_step(cfg)(state) is state
    assert not torch.equal(state.params.logit_opacities, before)
    assert [t.data_ptr() for t in state_tensors(state)] == ptrs


def test_multiscene_in_place_matches_jax_jitted_steps():
    """(iii) 3 steps, a refine with JAX's split noise, an opacity reset and
    3 more steps of the port's in-place multi-scene path against JAX's
    jitted, donated ``make_multiscene_train_step``,
    ``make_multiscene_refine_step`` and
    ``make_multiscene_reset_opacity_step``, both on the tile kernels' path
    from JAX's state: the mean loss and each scene's PSNR within rtol
    1e-3, as many Gaussians alive in each scene after the refine, and
    both packages' opacities capped by the reset.  (The parameters drift
    apart by up to Adam's 2·lr where a gradient is float32 noise, as
    ``tests/test_torch_graph.py`` says.)"""
    b = _make_batch(MS_CAP)
    jc, tc = _ms_cfg(jcfg, True), _ms_cfg(tcfg, True)
    jopt = make_optimizer(jc.optim)
    js = jms.make_multiscene_state(b["jparams"], jc, jopt)
    ts = ttr.state_from_numpy(_leaves(js), "cpu")
    jstep = jms.make_multiscene_train_step(jc, jopt)
    tstep = tms.make_multiscene_train_step(tc, FusedAdam(tc.optim))
    assert isinstance(tstep, GraphedStep)
    jcams = jms.stack_cameras(b["jcams"])
    tcams = tms.stack_cameras(b["tcams"])
    jargs = tuple(jnp.asarray(b[k]) for k in ("images", "depths", "uncs"))
    got = {"j": [], "t": []}

    def steps(n):
        nonlocal js, ts
        for _ in range(n):
            js, jm = jstep(js, jcams, *jargs, jnp.int32(1))
            ts, tm = tstep(ts, tcams, *_targets(b), 1)
            got["j"].append([float(jm["loss"])]
                            + np.asarray(jm["psnr_per_scene"]).tolist())
            got["t"].append([float(tm["loss"])]
                            + tm["psnr_per_scene"].tolist())

    steps(3)
    keys = jax.random.split(jax.random.PRNGKey(7), MS_S)
    noise = torch.as_tensor(_jax_split_noise(keys, MS_CAP,
                                             jc.densify.split_samples))
    alive = ts.params.alive.sum(dim=-1)
    js = jms.make_multiscene_refine_step(jc)(js, keys, True, True, False)
    refined = tms.make_multiscene_refine_step(tc)(ts, None, True, True,
                                                  False, split_noise=noise)
    assert refined is ts
    np.testing.assert_array_equal(ts.params.alive.sum(dim=-1).numpy(),
                                  np.asarray(js.params.alive).sum(-1))
    assert not torch.equal(ts.params.alive.sum(dim=-1), alive)
    js = jms.make_multiscene_reset_opacity_step(jc)(js)
    assert tms.make_multiscene_reset_opacity_step(tc)(ts) is ts
    cap = np.log(jc.densify.reset_opacity_value
                 / (1 - jc.densify.reset_opacity_value))
    for x in (ts.params.logit_opacities.numpy(),
              np.asarray(js.params.logit_opacities)):
        assert x.max() <= cap + 1e-6
    steps(3)
    j, t = np.array(got["j"]), np.array(got["t"])
    np.testing.assert_allclose(t, j, rtol=1e-3)
    print(f"loss and PSNRs over 6 steps: max relative gap "
          f"{np.max(np.abs(t - j) / np.abs(j)):.3e}")
    assert ts.step == int(js.step) == 6


def test_pose_step_matches_jax_jitted_step(full):
    """(iii) The graphed pose step's plain side over views 0, 1 and 2,
    each taking its view as a (1,) int64 tensor, against JAX's jitted step
    with the same ``view_idx``, from JAX's state with no dead slot: each
    step's loss within rtol 1e-3; the pose deltas within atol 1e-6 (the
    largest gap measured over these steps is printed)."""
    jc, tc = _pose_cfg(jcfg), _pose_cfg(tcfg)
    jt = jtr.Trainer(_scene(full, JCameras, JScene), jc)
    tt = _trainer(full, tc)
    leaves = _leaves(jt.state)
    leaves["pose_deltas"] = np.asarray(jt.state.pose_deltas)
    tt.state = ttr.state_from_numpy(leaves, "cpu")
    assert bool(tt.state.params.alive.all())
    jstep = jtr.make_train_step(jc, jt.optimizer)
    tstep = tt.train_step
    assert isinstance(tstep, GraphedStep) and tstep.view_input
    js, ts = jt.state, tt.state
    gaps = []
    for v in (0, 1, 2):
        js, jm = jstep(js, *jt._batch(v), SH, jnp.int32(v))
        ts, tm = tstep(ts, *tt._batch(v), SH, tt.view_index(v))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        got, want = ts.pose_deltas.numpy(), np.asarray(js.pose_deltas)
        assert np.isfinite(got).all()
        gaps.append(float(np.abs(got - want).max()))
    print(f"pose deltas: largest gap after each step {gaps}")
    assert np.abs(ts.pose_deltas.numpy()).max() > 0
    np.testing.assert_allclose(ts.pose_deltas.numpy(),
                               np.asarray(js.pose_deltas), atol=1e-6, rtol=0)


def test_which_steps_are_graphed(arrays):  # noqa: F811
    """(iv) On the kernel path ``make_train_step`` (plain, with SO3xR3, with
    ``tile_shards``), ``make_sharded_train_step`` and
    ``make_multiscene_train_step`` (with and without a mesh) return a
    ``GraphedStep``; only the scan path keeps the plain step.  On a CPU
    state a ``GraphedStep`` runs its plain step: no graph, no capture;
    ``view_index`` puts an int on the device as a (1,) int64 tensor."""
    cfg, opt = _cfg(tcfg), FusedAdam(_cfg(tcfg).optim)
    mesh = make_mesh(data=1, model=1)
    graphed = {
        "kernel path": ttr.make_train_step(cfg, opt),
        "SO3xR3": ttr.make_train_step(_pose_cfg(tcfg), opt),
        "tile_shards": ttr.make_train_step(cfg, opt, tile_shards=SHARDS),
        "sharded": make_sharded_train_step(cfg, mesh, opt),
        "multiscene": tms.make_multiscene_train_step(cfg, opt),
        "multiscene mesh": tms.make_multiscene_train_step(cfg, opt, mesh),
    }
    for name, step in graphed.items():
        assert isinstance(step, GraphedStep), name
        assert step.view_input == (name == "SO3xR3"), name
    scan = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rasterize=dataclasses.replace(cfg.model.rasterize,
                                                 use_pallas=False)))
    for c in (scan, dataclasses.replace(
            scan, pose_opt=tcfg.PoseOptConfig(mode="SO3xR3"))):
        assert not isinstance(ttr.make_train_step(c, opt), GraphedStep)
    events: dict = {}
    tt = _trainer(arrays, _cfg(tcfg))
    step = ttr.make_train_step(tt.cfg, tt.optimizer, tile_shards=SHARDS,
                               events=events)
    state, _ = step(tt.state, *tt._batch(0), SH)
    assert state.step == 1 and not step.graphs and events["capture"] == 0
    idx = view_index(2, "cpu")
    assert idx.dtype == torch.int64 and idx.tolist() == [2]
    assert view_index(torch.tensor(1), "cpu").shape == (1,)
    assert tt.view_index(2) is tt.view_index(2)
