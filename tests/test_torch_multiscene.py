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
import os
import pickle
import subprocess
import sys
from pathlib import Path

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
from touchgs_tpu.parallel.mesh import make_mesh as j_make_mesh
from touchgs_tpu.train.optim import make_optimizer
from touchgs_torch.data.cameras import Camera, Cameras as TCameras
from touchgs_torch.models.densify import DensifyState
from touchgs_torch.models.gaussians import params_from_numpy
from touchgs_torch.parallel import multiscene as tms
from touchgs_torch.parallel.mesh import make_mesh, named_leaves
from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam
from touchgs_torch.train.trainer import (TrainState, make_train_step,
                                         state_from_numpy)

from tests.synthetic import look_at_camera, random_gaussians
from tests.test_torch_train import _leaves

ROOT = Path(__file__).resolve().parents[1]
S, W, H, CAP = 4, 64, 48, 256


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(mod, use_pallas=False, cap=CAP, **kw):
    return mod.TrainConfig(model=mod.ModelConfig(
        max_gaussians=cap, sh_degree=1,
        rasterize=mod.RasterizeConfig(gaussian_chunk=64,
                                      use_pallas=use_pallas)), **kw)


def _make_batch(cap: int) -> dict:
    """JAX's params, cameras and targets, and the port's from the same
    numpy arrays, at capacity ``cap``."""
    jparams = []
    for i in range(S):
        means, _, _, colors, _ = random_gaussians(100, seed=i)
        jparams.append(j_init(np.asarray(means), np.asarray(colors),
                              capacity=cap, sh_degree=1, seed=i))
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


@pytest.fixture(scope="module")
def batch():
    return _make_batch(CAP)


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
    spec = tms.multiscene_shardings(make_mesh(), state)
    assert spec["params.means"] == ("data", "model")
    assert spec["opt_state.count"] == () and spec["step"] == ()


# ---- the (data, model) mesh --------------------------------------------

def _jax_split_noise(keys, cap: int, samples: int) -> np.ndarray:
    """(S, samples, cap, 3): the split noise JAX's refine draws from each
    scene's key."""
    noise = []
    for k in keys:
        scene = []
        for _ in range(max(1, samples)):
            k, sub = jax.random.split(k)
            scene.append(np.asarray(jax.random.normal(sub, (cap, 3))))
        noise.append(np.stack(scene))
    return np.stack(noise)


def _jax_leaves(tree) -> dict:
    """A JAX pytree's leaves by the port's dotted names
    (``parallel.mesh.named_leaves``)."""
    def name(path):
        return ".".join(str(getattr(k, "name", getattr(k, "key", None)))
                        for k in path)

    return {name(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["scan", "tile_kernels"])
def test_mesh_of_one_is_the_batch(batch, use_pallas):
    """A data=1, model=1 mesh with no process group runs the mesh code
    (placement, the ``model`` gathers and the ``data`` gathers, here
    copies) and gives the unsharded batch's three steps, refine (split
    noise injected) and opacity reset bit for bit, every leaf and metric."""
    cfg = _cfg(tcfg, use_pallas)
    opt = FusedAdam(cfg.optim)
    cams = tms.stack_cameras(batch["tcams"])
    targets = _targets(batch)
    noise = torch.tensor(np.random.default_rng(4).normal(
        size=(S, cfg.densify.split_samples, CAP, 3)).astype(np.float32))
    out = {}
    for name, mesh in (("batch", None), ("mesh", make_mesh(data=1,
                                                           model=1))):
        state = tms.make_multiscene_state(copy.deepcopy(batch["tparams"]),
                                          cfg, opt)
        if mesh is not None:
            state = tms.shard_multiscene_state(state, mesh)
        step = tms.make_multiscene_train_step(cfg, opt, mesh)
        metrics = []
        for _ in range(3):
            state, m = step(state, cams, *targets, 1)
            metrics.append(m)
        alive = tms.alive_per_scene(state, mesh)
        state = tms.make_multiscene_refine_step(cfg, mesh)(
            state, None, True, True, False, split_noise=noise)
        assert (tms.alive_per_scene(state, mesh) != alive).any()
        state = tms.make_multiscene_reset_opacity_step(cfg)(state)
        if mesh is not None:
            state = tms.gather_multiscene_state(state, mesh)
        out[name] = (dict(named_leaves(state)), metrics)
    (ref, ref_m), (got, got_m) = out["batch"], out["mesh"]
    for m, rm in zip(got_m, ref_m):
        for k in rm:
            assert torch.equal(m[k], rm[k]), k
    assert got.keys() == ref.keys()
    for k, v in ref.items():  # the dead slots' means are NaN in both
        if isinstance(v, torch.Tensor):
            torch.testing.assert_close(got[k], v, rtol=0, atol=0,
                                       equal_nan=True, msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("data, model", [(1, 1), (2, 2), (4, 2)])
def test_multiscene_shardings_match_jax(batch, data, model):
    """``multiscene_shardings(mesh, state)`` gives JAX's spec leaf by leaf,
    and ``shard_multiscene_state`` gives each rank (d, m) exactly the
    shard JAX's ``device_put`` places on device (d, m) of its mesh."""
    jc = _cfg(jcfg)
    jstate = jms.make_multiscene_state(batch["jparams"], jc,
                                       make_optimizer(jc.optim))
    jmesh = j_make_mesh(jax.devices()[:data * model], data=data,
                        model=model)
    jspecs = _jax_leaves(jms.multiscene_shardings(jmesh, jstate))
    placed = _jax_leaves(jax.device_put(jstate, jms.multiscene_shardings(
        jmesh, jstate)))
    tstate = state_from_numpy(_leaves(jstate), "cpu")
    mesh = make_mesh(world=data * model, data=data, model=model)
    specs = tms.multiscene_shardings(mesh, tstate)
    assert set(jspecs) <= set(specs)
    for name, spec in specs.items():
        want = tuple(jspecs[name].spec) if name in jspecs else ()
        assert spec == want, name
    for d in range(data):
        for m in range(model):
            dev = jmesh.devices[d, m]
            mine = dict(named_leaves(tms.shard_multiscene_state(
                tstate, dataclasses.replace(mesh, rank=d * model + m))))
            for name, arr in placed.items():
                shard = [s.data for s in arr.addressable_shards
                         if s.device == dev]
                np.testing.assert_array_equal(
                    np.asarray(mine[name]), np.asarray(shard[0]),
                    err_msg=f"{name} on ({d}, {m})")


@pytest.mark.parametrize("axis", ["data", "model"])
def test_mesh_split_must_divide(batch, axis):
    """S = 4 scenes on 3 ``data`` ranks, or a capacity of 256 on 3
    ``model`` ranks, raise ValueError, as JAX's ``device_put`` does."""
    jc, tc = _cfg(jcfg), _cfg(tcfg)
    jstate = jms.make_multiscene_state(batch["jparams"], jc,
                                       make_optimizer(jc.optim))
    shape = {"data": 3, "model": 1} if axis == "data" else \
        {"data": 1, "model": 3}
    with pytest.raises(ValueError):
        jax.device_put(jstate, jms.multiscene_shardings(
            j_make_mesh(jax.devices()[:3], **shape), jstate))
    mesh = make_mesh(world=3, **shape)
    state = tms.make_multiscene_state(copy.deepcopy(batch["tparams"]), tc)
    with pytest.raises(ValueError, match="C % model == 0"):
        tms.multiscene_shardings(mesh, state)
    with pytest.raises(ValueError, match="C % model == 0"):
        tms.shard_multiscene_state(state, mesh)


def test_mesh_needs_a_process_group(batch):
    """A mesh of more than one rank with no process group raises when a
    step or a refine is made for it; a batch whose scene count does not
    fit the state on the mesh raises."""
    cfg = _cfg(tcfg)
    mesh = make_mesh(world=4, data=2, model=2)
    with pytest.raises(RuntimeError, match="process group"):
        tms.make_multiscene_train_step(cfg, mesh=mesh)
    with pytest.raises(RuntimeError, match="process group"):
        tms.make_multiscene_refine_step(cfg, mesh)
    with pytest.raises(RuntimeError, match="process group"):
        tms.gather_multiscene_state(tms.make_multiscene_state(
            copy.deepcopy(batch["tparams"]), cfg), mesh)
    state = tms.make_multiscene_state(copy.deepcopy(batch["tparams"][:2]),
                                      cfg)
    cams = tms.stack_cameras(batch["tcams"])
    with pytest.raises(ValueError, match="a batch of 4 scenes"):
        tms.make_multiscene_train_step(cfg, mesh=make_mesh())(
            state, cams, *_targets(batch), 1)


def test_groupless_data_mesh_raises(batch):
    """A data=2, model=1 mesh with no process group, whose ``model`` axis
    is one rank: gathering its state or counting its live Gaussians
    raises rather than return this rank's scenes alone."""
    cfg = _cfg(tcfg)
    mesh = make_mesh(world=2, data=2, model=1)
    state = tms.shard_multiscene_state(tms.make_multiscene_state(
        copy.deepcopy(batch["tparams"]), cfg), mesh)
    with pytest.raises(RuntimeError, match="process group"):
        tms.gather_multiscene_state(state, mesh)
    with pytest.raises(RuntimeError, match="process group"):
        tms.alive_per_scene(state, mesh)


@pytest.mark.parametrize("shards", [2, 4])
def test_packed_grid_slices(shards):
    """The CPU half of ``tests/test_torch_cuda.py::
    test_packed_grid_slices_on_card``: the packed grid of 3 scenes in 2 or
    4 slices through K1 (each slice's ``tile0``), K2 and K3's plain
    versions equals the whole grid's, as each ``model`` rank composites
    its slice."""
    from tests.test_torch_cuda import (assert_slices_equal_whole,
                                       composite_slices, packed_scenes)

    x = packed_scenes(torch.device("cpu"))
    assert x["tile_ids"].tolist() == list(range(6)) * 3
    sliced, whole = composite_slices(x, shards)
    assert float(whole[2][:, 6].max()) > 0
    assert_slices_equal_whole(sliced, whole)


def test_train_multiscene_demo_mesh_of_one(monkeypatch):
    """``train_multiscene_demo.main`` with ``--data 1 --model 1 --device
    cpu`` on 2 scenes of 3 views at 48x32 (80 Gaussians, capacity 256),
    refining every 4 steps from step 2: the mesh run, its gather and
    eval, then the single-scene runs; ``--data 2`` without a process group
    raises."""
    from touchgs_torch.tools import train_multiscene_demo as tmd

    scene, demo_cfg = tmd.synthetic_scene, tmd.demo_cfg
    monkeypatch.setattr(tmd, "synthetic_scene", lambda seed, **kw: scene(
        seed, n_views=3, width=48, height=32, n_gauss=80, **kw))
    monkeypatch.setattr(tmd, "demo_cfg", lambda *a: dataclasses.replace(
        demo_cfg(*a), densify=tcfg.DensifyConfig(
            warmup_steps=2, refine_every=4, stop_refine_at=100,
            reset_opacity_every=10 ** 6, grad_threshold=1e-6)))
    args = ["--device", "cpu", "--scenes", "2", "--steps", "9",
            "--capacity", "256"]
    out = tmd.main(args + ["--data", "1", "--model", "1"])
    assert [r["scene"] for r in out["rows"]] == [0, 1]
    assert all(np.isfinite(r["ms_psnr"]) and np.isfinite(r["single_psnr"])
               for r in out["rows"])
    assert any(r["ms_alive"] != r["alive0"] for r in out["rows"])
    with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
        tmd.main(args + ["--data", "2"])


CAP_MESH, STEPS_MESH = 1024, 3
# run_multiscene on the mesh: refines at steps 2 and 4, a reset at step 3
SCHEDULE_STEPS = 5
SCHEDULE = dict(warmup_steps=1, refine_every=2, reset_opacity_every=3,
                stop_refine_at=100, grad_threshold=1e-6)
_MESH_WORKER = r"""
import dataclasses, os, pickle, sys, time
import torch
torch.set_num_threads(1)
from touchgs_torch.data.cameras import Camera
from touchgs_torch.parallel import multiscene as ms
from touchgs_torch.parallel.distributed import init_distributed
from touchgs_torch.parallel.mesh import make_mesh
from touchgs_torch.train.optim import FusedAdam
from touchgs_torch.train.trainer import state_from_numpy

rank, job = int(sys.argv[1]), pickle.load(open(sys.argv[2], "rb"))
assert init_distributed(job["address"], job["world"], rank, device="cpu")
mesh = make_mesh(data=2, model=2)
assert mesh.coords == divmod(rank, 2)
again = make_mesh(data=2, model=2)  # the axis groups are made once
assert (again.model_group, again.data_group) == (mesh.model_group,
                                                 mesh.data_group)
cams = Camera(**{k: torch.tensor(v) for k, v in job["cams"].items()},
              width=job["width"], height=job["height"])
targets = tuple(torch.tensor(job[k]) for k in ("images", "depths", "uncs"))
noise = torch.tensor(job["noise"])
KEEP = ("params.means", "params.sh_dc", "params.log_scales",
        "params.alive", "params.logit_opacities", "densify.grad_accum",
        "opt_state.mu.means", "opt_state.nu.means")


def snap(state, m=None):
    if m is not None:
        state = ms.gather_multiscene_state(state, m)
    leaves = dict(ms.named_leaves(state))
    return {k: leaves[k].numpy().copy() for k in KEEP}


def steps(cfg, opt, m):
    state = state_from_numpy(job["leaves"], "cpu")
    if m is not None:
        state = ms.shard_multiscene_state(state, m)
    step = ms.make_multiscene_train_step(cfg, opt, m)
    metrics = []
    for _ in range(job["steps"]):
        state, met = step(state, cams, *targets, 1)
        metrics.append({k: v.numpy().copy() for k, v in met.items()})
    return state, metrics


def refine_reset(cfg, state, m):
    # state: a whole one; on a mesh, this rank's share of it is refined
    if m is not None:
        state = ms.shard_multiscene_state(state, m)
    state = ms.make_multiscene_refine_step(cfg, m)(
        state, None, True, True, False, split_noise=noise)
    out = {"refine": snap(state, m),
           "alive": ms.alive_per_scene(state, m).numpy()}
    out["reset"] = snap(ms.make_multiscene_reset_opacity_step(cfg)(state),
                        m)
    return out


def schedule(cfg, m):
    # run_multiscene's refines and reset; on the mesh only rank 0 logs,
    # as train_multiscene_demo does
    cfg = dataclasses.replace(cfg, log_every=1, densify=dataclasses.replace(
        cfg.densify, **job["schedule"]))
    state = state_from_numpy(job["leaves"], "cpu")
    if m is not None:
        state = ms.shard_multiscene_state(state, m)
    logs = []
    state, met = ms.run_multiscene(
        state, cfg, ms.make_multiscene_train_step(cfg, FusedAdam(cfg.optim),
                                                  m),
        lambda i, rng: (cams, *targets, 1), job["schedule_steps"],
        log_fn=logs.append if m is None or rank == 0 else None, mesh=m)
    return dict(logs=logs, metrics={k: v.numpy().copy()
                                    for k, v in met.items()},
                alive=ms.alive_per_scene(state, m).numpy())


out = {}
for name, cfg in job["cfgs"].items():
    opt = FusedAdam(cfg.optim)
    ref, ref_m = steps(cfg, opt, None)
    state, met = steps(cfg, opt, mesh)
    out[name] = dict(rows=tuple(state.params.means.shape[:2]),
                     metrics=met, ref_metrics=ref_m,
                     steps=snap(state, mesh), ref_steps=snap(ref),
                     refined=refine_reset(cfg, ref, mesh),
                     ref_refined=refine_reset(cfg, ref, None),
                     schedule=schedule(cfg, mesh),
                     ref_schedule=schedule(cfg, None))
path = job["jax_steps"]
t0 = time.time()
while not os.path.exists(path):
    assert time.time() - t0 < 200, "no JAX state"
    time.sleep(0.05)
jstate = state_from_numpy(pickle.load(open(path, "rb")), "cpu")
out["jax"] = refine_reset(job["cfgs"]["scan"], jstate, mesh)
pickle.dump(out, open(job["out"] + f".{rank}", "wb"))
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def mesh_job(tmp_path_factory):
    """Four gloo processes on a data=2, model=2 mesh, S = 4 scenes at
    capacity 1024, on both render paths: STEPS_MESH steps on the mesh and
    unsharded; a refine with JAX's split noise and an opacity reset on the
    mesh and unsharded from the unsharded state after the steps, and on
    the mesh from JAX's state after its steps.  Meanwhile JAX's mesh
    step, refine and reset run here on 4 of the virtual devices.  Returns
    each rank's outputs and JAX's."""
    from tests.test_torch_parallel import _free_port

    tmp = tmp_path_factory.mktemp("mesh")
    b = _make_batch(CAP_MESH)
    jc = _cfg(jcfg, cap=CAP_MESH)
    jopt = make_optimizer(jc.optim)
    jstate = jms.make_multiscene_state(b["jparams"], jc, jopt)
    keys = jax.random.split(jax.random.PRNGKey(7), S)
    jcams = jms.stack_cameras(b["jcams"])
    job = dict(
        address=f"127.0.0.1:{_free_port()}", world=4,
        leaves=_leaves(jstate), out=str(tmp / "out.pkl"),
        jax_steps=str(tmp / "jax_steps.pkl"), steps=STEPS_MESH, width=W,
        height=H, cams={k: np.asarray(getattr(jcams, k))
                        for k in ("fx", "fy", "cx", "cy", "c2w")},
        images=b["images"], depths=b["depths"], uncs=b["uncs"],
        noise=_jax_split_noise(keys, CAP_MESH, jc.densify.split_samples),
        schedule=SCHEDULE, schedule_steps=SCHEDULE_STEPS,
        cfgs={"scan": _cfg(tcfg, False, cap=CAP_MESH),
              "tile_kernels": _cfg(tcfg, True, cap=CAP_MESH)})
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _MESH_WORKER, str(r),
                               str(tmp / "job.pkl")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(4)]
    try:
        jmesh = j_make_mesh(jax.devices()[:4], data=2, model=2)
        state = jax.device_put(jstate, jms.multiscene_shardings(jmesh,
                                                                jstate))
        step = jms.make_multiscene_train_step(jc, jopt, mesh=jmesh)
        jm = []
        for _ in range(STEPS_MESH):
            state, m = step(state, jcams, *(jnp.asarray(b[k]) for k in
                                            ("images", "depths", "uncs")),
                            jnp.int32(1))
            jm.append({k: np.asarray(v) for k, v in m.items()})

        def snap(p):  # before the next call donates the state
            return {f"params.{f}": np.asarray(getattr(p, f))
                    for f in ("means", "log_scales", "sh_dc", "alive",
                              "logit_opacities")}

        with open(tmp / "jax_steps.part", "wb") as f:
            pickle.dump(_leaves(state), f)
        os.rename(tmp / "jax_steps.part", tmp / "jax_steps.pkl")
        snaps = {"steps": snap(state.params)}
        state = jms.make_multiscene_refine_step(jc, mesh=jmesh)(
            state, keys, True, True, False)
        snaps["refine"] = snap(state.params)
        state = jms.make_multiscene_reset_opacity_step(jc)(state)
        snaps["reset"] = snap(state.params)
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    ranks = []
    for r in range(4):
        with open(f"{tmp / 'out.pkl'}.{r}", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, dict(metrics=jm, snaps=snaps)


PATHS = ["scan", "tile_kernels"]


def _same_refine(got: dict, ref: dict, atol: float, msg: str) -> None:
    """Refined states: the alive masks equal, the live means, scales and
    SH within ``atol``."""
    alive = ref["params.alive"]
    np.testing.assert_array_equal(got["params.alive"], alive, err_msg=msg)
    for k in ("params.means", "params.log_scales", "params.sh_dc"):
        np.testing.assert_allclose(got[k][alive], ref[k][alive], atol=atol,
                                   err_msg=f"{msg} {k}")


@pytest.mark.parametrize("path", PATHS)
def test_mesh_four_gloo_matches_batch(mesh_job, path):
    """On a data=2, model=2 mesh of four gloo processes each rank holds 2
    scenes of 512 rows and returns the same metrics.  Against the port's
    unsharded batch in the same process: the steps' losses and PSNRs rtol
    1e-5, the live means and SH atol 1e-5 (``tests/test_sharded.py:
    52-61``), the densify statistics rtol 1e-3; the refine (split noise
    injected) and the opacity reset from one state bit for bit, the Adam
    moments of the rewritten slots zeroed alike."""
    ranks, _ = mesh_job
    outs = [r[path] for r in ranks]
    assert [o["rows"] for o in outs] == [(2, CAP_MESH // 2)] * 4
    for o in outs[1:]:
        for m, m0 in zip(o["metrics"], outs[0]["metrics"]):
            for k in m0:
                np.testing.assert_array_equal(m[k], m0[k], err_msg=k)
        np.testing.assert_array_equal(o["refined"]["alive"],
                                      outs[0]["refined"]["alive"])
    for o in outs:  # each rank against its own unsharded run
        for m, rm in zip(o["metrics"], o["ref_metrics"]):
            assert m["loss_per_scene"].shape == (S,)
            for k in rm:
                np.testing.assert_allclose(m[k], rm[k], rtol=1e-5,
                                           err_msg=k)
    o = outs[0]
    got, ref = o["steps"], o["ref_steps"]
    alive = ref["params.alive"]
    np.testing.assert_array_equal(got["params.alive"], alive)
    for k in ("params.means", "params.sh_dc"):
        np.testing.assert_allclose(got[k][alive], ref[k][alive], atol=1e-5,
                                   err_msg=k)
    # rtol 1e-3: on the scan path one entry of 4096 sits 4.1e-4 apart, a
    # screen-space gradient whose terms cancel, summed over the two model
    # ranks' tiles in another order
    np.testing.assert_allclose(got["densify.grad_accum"],
                               ref["densify.grad_accum"], rtol=1e-3,
                               atol=1e-7)
    refined, ref_refined = o["refined"], o["ref_refined"]
    assert (ref_refined["refine"]["params.alive"].sum(-1)
            != alive.sum(-1)).any(), "the refine changed no scene"
    touched = (ref_refined["refine"]["opt_state.mu.means"] == 0).all(-1) \
        & (ref["opt_state.mu.means"] != 0).any(-1)
    assert touched.any(), "no Adam moment was reset"
    for stage in ("refine", "reset"):
        for k, v in ref_refined[stage].items():
            np.testing.assert_array_equal(refined[stage][k], v,
                                          err_msg=f"{stage} {k}")
    np.testing.assert_array_equal(
        refined["alive"], ref_refined["refine"]["params.alive"].sum(-1))


@pytest.mark.parametrize("path", PATHS)
def test_mesh_four_gloo_run_multiscene(mesh_job, path):
    """``run_multiscene`` on the data=2, model=2 mesh with its log_fn on
    rank 0 alone, as ``train_multiscene_demo`` gives it: every rank runs
    the schedule's gathers, rank 0 logs every step, the live counts of
    each log equal the unsharded run's, and its losses and the last step's
    metrics on every rank are within rtol 1e-3 of them.  Not 1e-5 as for
    the steps alone: a split rotates its children's offsets by quaternions
    whose gradients are float noise, which Adam moves by up to lr either
    way (ROADMAP C32), so the losses after the split drift by ~1e-4."""
    ranks, _ = mesh_job
    ref = ranks[0][path]["ref_schedule"]
    assert [log["step"] for log in ref["logs"]] == list(range(SCHEDULE_STEPS))
    assert len({tuple(log["alive_per_scene"]) for log in ref["logs"]}) > 1, \
        "the schedule changed no live count"
    got = ranks[0][path]["schedule"]["logs"]
    assert [log["step"] for log in got] == list(range(SCHEDULE_STEPS))
    for log, rlog in zip(got, ref["logs"]):
        assert log["alive_per_scene"] == rlog["alive_per_scene"], log["step"]
        np.testing.assert_allclose(log["loss_per_scene"],
                                   rlog["loss_per_scene"], rtol=1e-3)
    for r in ranks:
        o = r[path]["schedule"]
        assert r is ranks[0] or o["logs"] == []
        np.testing.assert_array_equal(o["alive"], ref["alive"])
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(o["metrics"][k], v, rtol=1e-3,
                                       err_msg=k)


@pytest.mark.parametrize("path", PATHS)
def test_mesh_four_gloo_matches_jax(mesh_job, path):
    """The same run against JAX's ``make_multiscene_train_step`` on its own
    data=2, model=2 mesh of virtual devices, with ``test_step_matches_
    jax``'s tolerances: each step's loss and PSNRs rtol 1e-3, the alive
    masks equal and the live means atol 1e-4 after the steps.  From JAX's
    state after its steps, the port's mesh refine with JAX's split noise
    against JAX's mesh refine and reset at ``test_refine_matches_jax``'s
    tolerance (alive equal, live means, scales, SH atol 1e-6), the live
    opacities after the reset atol 1e-6."""
    ranks, jout = mesh_job
    o = ranks[0][path]
    for m, jm in zip(o["metrics"], jout["metrics"]):
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(m["psnr_per_scene"], jm["psnr_per_scene"],
                                   rtol=1e-3)
    got, want = o["steps"], jout["snaps"]["steps"]
    alive = want["params.alive"]
    np.testing.assert_array_equal(got["params.alive"], alive)
    np.testing.assert_allclose(got["params.means"][alive],
                               want["params.means"][alive], atol=1e-4)
    for r in ranks:
        for stage in ("refine", "reset"):
            _same_refine(r["jax"][stage], jout["snaps"][stage], 1e-6, stage)
    alive = jout["snaps"]["reset"]["params.alive"]
    np.testing.assert_allclose(
        ranks[0]["jax"]["reset"]["params.logit_opacities"][alive],
        jout["snaps"]["reset"]["params.logit_opacities"][alive], atol=1e-6)
