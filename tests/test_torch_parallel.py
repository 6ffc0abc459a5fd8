"""The port's multi-GPU training (``touchgs_torch/parallel/mesh.py``,
``distributed.py``, ``sharded.py`` and the renderers' ``tile_shards``)
against the JAX package's on the CPU.

- ``make_mesh``'s splits equal JAX's for 1, 2, 4 and 8 ranks;
  ``local_batch_slice``, ``init_distributed`` with nothing set (a no-op)
  and with a bad explicit address (it raises).
- ``tile_shards = 4`` in one process renders what ``tile_shards = 0``
  renders, on the tile kernels' path (their plain versions) and on the scan
  path, and K1's lists of each slice, with its ``tile0``, are the global
  lists' slice bit for bit; a mesh of one rank without a process group
  runs the sharded render's code and renders the same.
- Four gloo processes (a 2x2 mesh) take the sharded step on
  ``tests/test_train.py``'s scene (4 views of 128x96, 200 Gaussians in a
  capacity of 512, SH 1) on both render paths, held against the
  single-process port step and, on the scan path, the JAX single-device
  step: loss within rtol 1e-4, ``means`` and ``sh_dc`` within atol 1e-5
  (``tests/test_sharded.py:52-61``).  Against JAX a parameter whose
  gradient is exactly 0 in one package and float32 noise in the other
  moves by a whole Adam step (ROADMAP.md C32), so those are held as a
  share of the entries.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_torch.config as tcfg
from touchgs_tpu.parallel.mesh import make_mesh as j_make_mesh
from touchgs_tpu.train.trainer import Trainer as JTrainer
from touchgs_torch.data.cameras import Camera
from touchgs_torch.models.gaussians import init_random
from touchgs_torch.models.splatfacto import render
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops.tiles import bin_gaussians
from touchgs_torch.parallel import distributed as pdist
from touchgs_torch.parallel import mesh as pmesh

from tests.test_torch_train import _leaves
from tests.test_train import _make_synthetic_scene, _tiny_cfg

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_splits_match_jax(n):
    j = j_make_mesh(jax.devices()[:n])
    t = pmesh.make_mesh(world=n)
    assert t.shape == dict(j.shape) and t.size == n
    assert t.group is None and t.rank == 0
    if n >= 2:
        assert pmesh.make_mesh(world=n, model=2).shape == dict(
            j_make_mesh(jax.devices()[:n], model=2).shape)
        assert pmesh.make_mesh(world=n, data=1).shape == {"data": 1,
                                                          "model": n}
    with pytest.raises(ValueError, match="mesh"):
        pmesh.make_mesh(world=n, data=n + 1, model=1)


def test_single_process_helpers(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert pdist.init_distributed() is False
    assert not torch.distributed.is_initialized()
    np.testing.assert_array_equal(pdist.local_batch_slice(10), np.arange(10))
    assert pdist.global_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="host:port"):
        pdist.init_distributed("localhost:notaport", 2, 0, device="cpu")
    with pytest.raises(ValueError, match="host:port"):
        pdist.init_distributed("localhost", 2, 0, device="cpu")
    with pytest.raises(ValueError, match="number of processes"):
        pdist.init_distributed("localhost:29500", device="cpu")
    assert not torch.distributed.is_initialized()
    mesh = pmesh.make_mesh(world=4)
    x = torch.arange(10.0)
    rows = [pmesh.shard_rows(x, dataclasses.replace(mesh, rank=r))
            for r in range(4)]
    assert [r.tolist() for r in rows] == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                          [9, 0, 0]]
    with pytest.raises(RuntimeError, match="process group"):
        mesh.gather_rows(rows[0])
    assert set(pmesh.param_pspecs().values()) == {("model", "data")}


@pytest.mark.parametrize("data, model", [(1, 1), (2, 2), (4, 2), (1, 4)])
def test_mesh_axes(data, model):
    """``Mesh.axis``: rank r of a data x model mesh sits at (r // model,
    r % model); its ``model`` axis is the 1 x model mesh of the ranks that
    share its ``data`` coordinate, its ``data`` axis the data x 1 mesh of
    those that share its ``model`` coordinate.  Without a process group the
    axes only describe (a gather over more than one rank raises); a mesh
    with a group but no axis groups raises; ``gather_scene_rows`` of one
    rank keeps the scenes' rows."""
    mesh = pmesh.make_mesh(world=data * model, data=data, model=model)
    for r in range(data * model):
        m = dataclasses.replace(mesh, rank=r)
        assert m.coords == (r // model, r % model)
        assert m.axis("model") == pmesh.Mesh(1, model, r % model)
        assert m.axis("data") == pmesh.Mesh(data, 1, r // model)
        for name, n in (("model", model), ("data", data)):
            if n > 1:
                with pytest.raises(RuntimeError, match="process group"):
                    m.axis(name).gather_rows(torch.zeros(2))
    with pytest.raises(ValueError, match="mesh axis"):
        mesh.axis("tiles")
    with pytest.raises(RuntimeError, match="no model group"):
        dataclasses.replace(mesh, group=object()).axis("model")
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(pmesh.make_mesh().gather_scene_rows(x), x)


@pytest.fixture(scope="module")
def view():
    """300 random Gaussians in a capacity of 512, SH 1, seen at 160x96
    (5x3 tiles of 32x32)."""
    params = init_random(n=300, capacity=512, sh_degree=1, seed=3,
                         device="cpu")
    params = dataclasses.replace(params, logit_opacities=torch.full(
        (512,), 0.5), log_scales=params.log_scales - 1.0)
    from chip_smoke import look_at_c2w
    cam = Camera(fx=torch.tensor(np.float32(110)),
                 fy=torch.tensor(np.float32(110)),
                 cx=torch.tensor(np.float32(80)),
                 cy=torch.tensor(np.float32(48)),
                 c2w=torch.tensor(look_at_c2w((0.4, 0.3, 2.6))),
                 width=160, height=96)
    return params, cam


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["scan", "tile_kernels"])
def test_tile_shards_in_one_process(view, use_pallas):
    params, cam = view
    cfg = tcfg.ModelConfig(max_gaussians=512, sh_degree=1,
                           rasterize=tcfg.RasterizeConfig(
                               use_pallas=use_pallas))

    def run(**kw):
        p = dataclasses.replace(params,
                                sh_dc=params.sh_dc.clone().requires_grad_(),
                                means=params.means.clone().requires_grad_())
        out, _ = render(p, cam, cfg, active_sh_degree=1, **kw)
        loss = out.rgb.square().mean() + 0.1 * out.depth.mean()
        return out, torch.autograd.grad(loss, (p.means, p.sh_dc))

    ref, ref_g = run()
    assert float(ref.acc.detach().max()) > 0.5
    for kw in ({"tile_shards": 4}, {"mesh": pmesh.make_mesh()}):
        out, g = run(**kw)
        for name in ("rgb", "depth", "acc"):
            torch.testing.assert_close(getattr(out, name), getattr(ref, name),
                                       rtol=0, atol=0, msg=f"{kw} {name}")
        for a, b in zip(g, ref_g):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-9)
    if use_pallas:  # K1's lists of each slice of 4 (15 tiles: 4, 4, 4, 3+1)
        from touchgs_torch.models.splatfacto import shade
        proj, _, _, _ = shade(params, cam, cfg)
        bins = bin_gaussians(proj, 160, 96, cfg.rasterize)
        capped = torch.clamp(bins.tile_counts, max=512)
        full = rc.slot_lists(bins.sorted_gauss, bins.tile_starts, capped, 15,
                             512, 512)
        for t0 in range(0, 15, 4):
            t1 = min(t0 + 4, 15)
            part = rc.slot_lists(bins.sorted_gauss, bins.tile_starts[t0:t1],
                                 capped[t0:t1], t1 - t0, 512, 512, tile0=t0)
            assert torch.equal(part, full[t0:t1])


_WORKER = r"""
import pickle, sys
import torch
torch.set_num_threads(1)
from touchgs_torch.data.cameras import Cameras
from touchgs_torch.data.scene import Scene
from touchgs_torch.parallel.distributed import init_distributed
from touchgs_torch.parallel.mesh import make_mesh
from touchgs_torch.parallel.sharded import (gather_state,
                                            make_sharded_train_step,
                                            shard_state)
from touchgs_torch.train.trainer import (Trainer, make_train_step,
                                         state_from_numpy)

rank, job = int(sys.argv[1]), pickle.load(open(sys.argv[2], "rb"))
assert init_distributed(job["address"], job["world"], rank, device="cpu")
mesh = make_mesh(data=2, model=2)
assert (mesh.size, mesh.rank) == (job["world"], rank)
scene = Scene(cameras=Cameras(**job["cameras"]), **job["scene"])
out = {}
for name, cfg in job["cfgs"].items():
    tr = Trainer(scene, cfg, device="cpu")
    batch = tr._batch(0)
    ref, ref_m = make_train_step(cfg, tr.optimizer)(
        state_from_numpy(job["leaves"], "cpu"), *batch, 0)
    state = shard_state(state_from_numpy(job["leaves"], "cpu"), mesh)
    rows = state.params.capacity
    state, m = make_sharded_train_step(cfg, mesh, tr.optimizer)(
        state, *batch, 0)
    full = gather_state(state, mesh)
    out[name] = dict(rows=rows, loss=float(m["loss"]),
                     ref_loss=float(ref_m["loss"]),
                     num_alive=int(m["num_alive"]), step=full.step)
    for k in ("means", "sh_dc", "alive"):
        out[name][k] = getattr(full.params, k).numpy()
        out[name]["ref_" + k] = getattr(ref.params, k).numpy()
    out[name]["grad_accum"] = full.densify.grad_accum.numpy()
    out[name]["ref_grad_accum"] = ref.densify.grad_accum.numpy()
if rank == 0:
    pickle.dump(out, open(job["out"], "wb"))
torch.distributed.destroy_process_group()
"""


def _port_tiny_cfg(use_pallas: bool) -> tcfg.TrainConfig:
    """The port's copy of ``tests/test_train.py::_tiny_cfg()``."""
    return tcfg.TrainConfig(
        max_steps=120,
        model=tcfg.ModelConfig(max_gaussians=512, sh_degree=1,
                               rasterize=tcfg.RasterizeConfig(
                                   gaussian_chunk=128,
                                   use_pallas=use_pallas)),
        depth=tcfg.DepthLossConfig(),
        densify=tcfg.DensifyConfig(warmup_steps=40, refine_every=40,
                                   stop_refine_at=100,
                                   reset_opacity_every=10_000,
                                   prune_opacity_threshold=0.005,
                                   reset_opacity_value=0.01),
        optim=tcfg.OptimConfig(means_lr_max_steps=200),
        sh_degree_interval=50, log_every=20, seed=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_step_four_gloo_processes(tmp_path):
    scene = _make_synthetic_scene(n_views=4, width=128, height=96,
                                  n_gauss=200)
    jt = JTrainer(scene, _tiny_cfg())
    leaves = _leaves(jt.state)
    cam, image, depth, unc = jt._batch(0)
    jstate, jm = jt.train_step(jax.tree.map(lambda x: x, jt.state), cam,
                               image, depth, unc, jnp.int32(0))
    cams = scene.cameras
    job = dict(
        address=f"127.0.0.1:{_free_port()}", world=WORLD, leaves=leaves,
        out=str(tmp_path / "out.pkl"),
        cameras=dict(fx=cams.fx, fy=cams.fy, cx=cams.cx, cy=cams.cy,
                     c2w=cams.c2w, width=cams.width, height=cams.height),
        scene={f.name: getattr(scene, f.name)
               for f in dataclasses.fields(scene) if f.name != "cameras"},
        cfgs={"scan": _port_tiny_cfg(False),
              "tile_kernels": _port_tiny_cfg(True)})
    with open(tmp_path / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r),
                               str(tmp_path / "job.pkl")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-3000:]}"
    with open(tmp_path / "out.pkl", "rb") as f:
        out = pickle.load(f)

    for name, o in out.items():
        assert o["rows"] == 512 // WORLD and o["step"] == 1
        assert o["num_alive"] == int(o["alive"].sum()) > 0
        np.testing.assert_allclose(o["loss"], o["ref_loss"], rtol=1e-4)
        alive = o["ref_alive"]
        np.testing.assert_array_equal(o["alive"], alive)
        for k in ("means", "sh_dc"):
            np.testing.assert_allclose(o[k][alive], o["ref_" + k][alive],
                                       atol=1e-5, err_msg=f"{name} {k}")
        np.testing.assert_allclose(o["grad_accum"], o["ref_grad_accum"],
                                   rtol=1e-4, atol=1e-7)

    o = out["scan"]
    np.testing.assert_allclose(o["loss"], float(jm["loss"]), rtol=1e-4)
    alive = np.asarray(jstate.params.alive)
    lr = _tiny_cfg().optim.means_lr_init
    for k in ("means", "sh_dc"):
        diff = np.abs(o[k][alive] - np.asarray(getattr(jstate.params, k))[
            alive])
        share = float((diff > 1e-5).mean())
        print(f"sharded vs JAX {k}: {share:.3%} of the entries more than "
              f"1e-5 apart, at most {diff.max():.3e}")
        assert share <= 0.02 and diff.max() <= 3 * max(
            lr, _tiny_cfg().optim.features_dc_lr), k
