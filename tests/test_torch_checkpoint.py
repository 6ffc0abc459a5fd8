"""The port's checkpoints (``touchgs_torch/train/checkpoint.py``), on the
CPU: a resumed run bitwise equal to the same trainer continuing in memory
(with a refine and its split noise inside the resumed window), restores
after a capacity growth and with an escalated k_tile, the sidecar's
``densify_units`` marker, ``max_to_keep``, and ``config.json`` /
``capacities.json`` equal to what the JAX package writes."""
import dataclasses
import json
import re

import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.data.cameras import Cameras as JCameras
from touchgs_tpu.data.scene import Scene as JScene
from touchgs_tpu.train import checkpoint as jck
from touchgs_tpu.train import trainer as jtr
from touchgs_torch.data.cameras import Cameras as TCameras
from touchgs_torch.data.scene import Scene as TScene
from touchgs_torch.train import checkpoint as tck
from touchgs_torch.train import trainer as ttr

from tests.test_torch_train import _cfg, _scene, _scene_arrays


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


def _resume_cfg(mod):
    """The scan path with a refine at step 8, inside the resumed window."""
    cfg = _cfg(mod, use_pallas=False)
    return dataclasses.replace(
        cfg, checkpoint_every=3,
        densify=dataclasses.replace(cfg.densify, warmup_steps=4,
                                    refine_every=4))


@pytest.fixture(scope="module")
def arrays():
    return _scene_arrays()


def _trainer(arrays, cfg):
    return ttr.Trainer(_scene(arrays, TCameras, TScene), cfg, device="cpu")


def _tensors(state) -> dict:
    d = tck._state_to_dict(state)
    out = {"step": d.pop("step")}
    for k, v in d.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                if isinstance(v2, dict):
                    out.update({f"{k}.{k2}.{k3}": v3 for k3, v3 in v2.items()})
                else:
                    out[f"{k}.{k2}"] = v2
        else:
            out[k] = v
    return out


def _assert_bitwise(a, b):
    """Every tensor byte for byte (dead slots hold NaN, which torch.equal
    calls unequal), and the step."""
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        if torch.is_tensor(ta[k]):
            assert ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape, k
            assert ta[k].numpy().tobytes() == tb[k].numpy().tobytes(), k
        else:
            assert ta[k] == tb[k], k


def test_resume_is_bitwise_equal(arrays, tmp_path):
    cfg = _resume_cfg(tcfg)
    a = _trainer(arrays, cfg)
    a.run(6)
    a.run(10)
    assert a.events["refine"] == 2          # steps 4 and 8: one after resume

    b = _trainer(arrays, cfg)
    mgr = tck.CheckpointManager(tmp_path / "run", cfg)
    b.run(6, ckpt_manager=mgr)
    assert mgr.all_steps() == [3, 6] and mgr.latest_step() == 6
    c = _trainer(arrays, cfg)
    tck.restore_trainer(c, tck.CheckpointManager(tmp_path / "run"))
    assert c.state.step == 6
    c.run(10)
    _assert_bitwise(a.state, c.state)


def test_restore_after_growth_and_k_tile(arrays, tmp_path):
    """A checkpoint saved at twice the capacity, with the guard's k_tile
    escalated, restores into a fresh, smaller trainer; the restored step
    renders with the escalated k_tile."""
    cfg = _cfg(tcfg, use_pallas=False)
    a = _trainer(arrays, cfg)
    a.run(2)
    a.state = ttr.grow_state(a.state, 2 * a.state.params.capacity)
    mgr = tck.CheckpointManager(tmp_path / "run", cfg)
    mgr.save(2, a.state, extra={"k_tile": 1024})
    assert mgr.saved_capacity() == 2 * _cfg(tcfg).model.max_gaussians
    assert mgr.saved_extra() == {"k_tile": 1024, "densify_units": "normalized"}
    b = _trainer(arrays, cfg)
    assert b.state.params.capacity < a.state.params.capacity
    tck.restore_trainer(b, tck.CheckpointManager(tmp_path / "run"))
    assert b._k_tile == 1024
    _assert_bitwise(a.state, b.state)
    b.run(3)
    assert b.state.step == 3


def test_sidecar_without_units_zeroes_max_radii(arrays, tmp_path):
    cfg = _cfg(tcfg, use_pallas=False)
    a = _trainer(arrays, cfg)
    a.run(3)
    assert float(a.state.densify.max_radii.max()) > 0
    mgr = tck.CheckpointManager(tmp_path / "run", cfg)
    mgr.save(3, a.state)
    idx = json.loads((tmp_path / "run" / "capacities.json").read_text())
    del idx["3"]["densify_units"]
    (tmp_path / "run" / "capacities.json").write_text(json.dumps(idx))
    b = _trainer(arrays, cfg)
    tck.restore_trainer(b, tck.CheckpointManager(tmp_path / "run"))
    assert float(b.state.densify.max_radii.abs().max()) == 0.0
    assert torch.equal(b.state.densify.grad_accum, a.state.densify.grad_accum)


def test_max_to_keep_and_shape_check(arrays, tmp_path):
    cfg = _cfg(tcfg, use_pallas=False)
    a = _trainer(arrays, cfg)
    mgr = tck.CheckpointManager(tmp_path / "run", cfg, max_to_keep=3)
    for step in (1, 2, 3, 4, 5):
        mgr.save(step, a.state)
    assert mgr.all_steps() == [3, 4, 5]
    assert sorted(p.name for p in (tmp_path / "run" / "checkpoints").iterdir()
                  ) == ["3.pt", "4.pt", "5.pt"]
    small = _trainer(arrays, dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, max_gaussians=256)))
    with pytest.raises(ValueError, match="params.means"):
        mgr.restore(small.state)
    with pytest.raises(FileNotFoundError):
        tck.CheckpointManager(tmp_path / "empty").restore(a.state)


def test_json_files_equal_the_jax_packages(arrays, tmp_path):
    """The same config, steps and extras through both managers: the same
    ``config.json`` and ``capacities.json`` bytes (the step files differ:
    orbax against torch.save)."""
    cfg_t = _cfg(tcfg, use_pallas=False)
    cfg_j = _cfg(jcfg, use_pallas=False)
    a = _trainer(arrays, cfg_t)
    jm = jck.CheckpointManager(tmp_path / "jax", cfg_j)
    tm = tck.CheckpointManager(tmp_path / "torch", cfg_t)

    jt = jtr.Trainer(_scene(arrays, JCameras, JScene), cfg_j)
    for step, extra in ((3, None), (6, {"k_tile": 1024})):
        tm.save(step, a.state, extra=extra)
        jm.save(step, jt.state, extra=extra)
    jm.close()
    for name in ("config.json", "capacities.json"):
        assert ((tmp_path / "torch" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name
    assert tck.latest_run_dir(tmp_path, "nope") is None
    run = tck.make_run_dir(tmp_path / "out", "scene")
    assert run.parent == tmp_path / "out" / "scene" / tck.METHOD_NAME
    assert tck.latest_run_dir(tmp_path / "out", "scene") == run
    assert re.fullmatch(r"\d{4}-\d\d-\d\d_\d{6}", run.name)
