"""The DenseTact sensor, its 30 Hz loop and the sensor nets' train steps
(``touchgs_torch/touch``: ``sensor_nets.DenseTactSensor``, ``sensor_loop``,
``sensor_train``) against the JAX package's (``touchgs_tpu/touch``), on the
CPU, on the same inputs from numpy seeds.

The compact nets share flax's parameters through ``load_flax_params``; the
faithful route reads the TINY DenseNet npz of
``tests/test_torch_sensor_nets.py``.  Tolerances: outputs within 1e-5 of
their range, losses rtol 1e-5, gradients atol 5e-6, unless a test states
another with its measurement.
"""
import copy

import flax.linen
import jax
import numpy as np
import optax
import pytest
import torch

from touchgs_tpu.touch import densetact_nets as jdt
from touchgs_tpu.touch import losses as jl
from touchgs_tpu.touch import sensor_loop as jsl
from touchgs_tpu.touch import sensor_nets as jsn
from touchgs_tpu.touch import sensor_train as jst
from touchgs_torch.data.png import read_png, write_png
from touchgs_torch.touch import losses as tl
from touchgs_torch.touch import sensor_loop as tsl
from touchgs_torch.touch import sensor_nets as tsn
from touchgs_torch.touch import sensor_train as tst

from tests.test_torch_sensor_nets import (TINY, _jparams, assert_close_range,
                                          compact, densetact_npz,
                                          one_torch_thread, t)

__all__ = ["compact", "densetact_npz", "one_torch_thread"]   # fixtures


# ------------------------------------------------------------- sensor --

@pytest.fixture(scope="module")
def sensors():
    """The JAX sensor (compact nets from PRNGKey(0)) and the port's on the
    CPU with those nets' parameters carried across.  The JAX sensor's flax
    init runs jitted here (op by op it takes half a minute on this CPU);
    its draws are the same."""
    init = flax.linen.Module.init

    def jitted_init(self, rng, *args):
        return jax.jit(lambda r, *a: init(self, r, *a))(rng, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, "init", jitted_init)
        js = jsn.DenseTactSensor(input_size=16)
    ts = tsn.DenseTactSensor(input_size=16, device="cpu")
    tsn.load_flax_params(ts.depth_net,
                         jax.tree.map(np.asarray, js.depth_params))
    tsn.load_flax_params(ts.force_net,
                         jax.tree.map(np.asarray, js.force_params))
    return js, ts


def test_rectify_matches_jax(sensors):
    js, ts = sensors
    raw = np.random.default_rng(13).integers(0, 256, (8, 8, 3), np.uint8)
    np.testing.assert_array_equal(ts.rectify(raw), js.rectify(raw))
    calib = np.random.default_rng(14).permutation(64)[:16]
    jr, tr = copy.copy(js), copy.copy(ts)     # the nets stay as they are
    jr.calib_index = tr.calib_index = calib
    np.testing.assert_array_equal(tr.rectify(raw), jr.rectify(raw))
    assert tr.rectify(raw).shape == (4, 4, 3)


def test_get_depth_matches_jax(sensors):
    """uint8, truncated: a float a hair below an integer on one side lands
    one level lower, so the two may differ by 1 at a few pixels."""
    js, ts = sensors
    img = np.random.default_rng(15).integers(0, 256, (64, 64, 3), np.uint8)
    out, ref = ts.get_depth(img), js.get_depth(img)
    assert out.dtype == np.uint8 and out.shape == (64, 64)
    diff = np.abs(out.astype(int) - ref.astype(int))
    print(f"get_depth: {np.mean(diff > 0):.4%} of pixels one level apart")
    assert diff.max() <= 1 and np.mean(diff > 0) <= 0.01


def test_get_force_matches_jax(sensors):
    js, ts = sensors
    img = np.random.default_rng(16).integers(0, 256, (64, 64, 3), np.uint8)
    np.testing.assert_allclose(ts.get_force(img), js.get_force(img),
                               atol=1e-5)


def test_faithful_route_chosen_by_the_same_key(densetact_npz, compact,
                                               tmp_path):
    """A file with ``encoder.densenet.features.conv0.weight`` runs the
    faithful net in both packages; the compact nets' flax npz, a missing
    file and a file that is no npz do not."""
    _, params, _ = compact["depth"]
    flax_npz = tmp_path / "flax.npz"
    np.savez(flax_npz, **tsn.flatten_tree(params))
    bad = tmp_path / "bad.npz"
    bad.write_text("not an npz")
    for path, want in ((densetact_npz["depth"], True), (flax_npz, False),
                       (tmp_path / "missing.npz", False), (bad, False)):
        assert tsn.DenseTactSensor._is_ported(path) is want
        assert jsn.DenseTactSensor._is_ported(path) is want
    ts = tsn.DenseTactSensor(input_size=16, device="cpu",
                             depth_weights=str(densetact_npz["depth"]),
                             force_weights=str(densetact_npz["force"]))
    assert ts._faithful_depth and ts._faithful_force
    img = np.random.default_rng(17).integers(0, 256, (64, 64, 3)).astype(
        np.float32)
    norm = jsn.normalize_tactile(img)
    ref_d = jdt.dense_depth_forward(_jparams(densetact_npz["depth"]), norm,
                                    max_depth=256.0, cfg=TINY)
    ref_f = jdt.densenet_force_forward(_jparams(densetact_npz["force"]), norm,
                                       cfg=TINY)
    assert_close_range(ts.depth(img).numpy(), ref_d)
    assert_close_range(ts.force(img).numpy(), ref_f)
    np.testing.assert_allclose(ts.get_force(img),
                               np.asarray(jsn.denormalize_force(ref_f)),
                               atol=1e-5)


# --------------------------------------------------------------- loop --

def test_synthetic_source_equals_jax():
    for out, ref in zip(tsl.SyntheticSource(size=64, n_frames=3).frames(),
                        jsl.SyntheticSource(size=64, n_frames=3).frames()):
        np.testing.assert_array_equal(out, ref)


def test_sensor_loop_matches_jax(sensors, tmp_path):
    """Both loops on the same three frames: the same files, depth PNGs
    within one level (uint8 truncation), force.csv within 1e-5, and the
    port's per-stage frame times."""
    js, ts = sensors
    jloop = jsl.SensorLoop(sensor=js, out_dir=tmp_path / "jax",
                           rate_hz=1000.0)
    tloop = tsl.SensorLoop(sensor=ts, out_dir=tmp_path / "port",
                           rate_hz=1000.0)
    assert jloop.run(jsl.SyntheticSource(size=64, n_frames=3)) == 3
    assert tloop.run(tsl.SyntheticSource(size=64, n_frames=3)) == 3
    for sub in ("depth", "rect"):
        names = sorted(p.name for p in (tmp_path / "port" / sub).iterdir())
        assert names == sorted(
            p.name for p in (tmp_path / "jax" / sub).iterdir())
        assert names == [f"frame_{i:05d}.png" for i in range(3)]
        for name in names:
            out = read_png(tmp_path / "port" / sub / name)
            ref = read_png(tmp_path / "jax" / sub / name)
            assert out.dtype == np.uint8 and out.shape == ref.shape
            tol = 1 if sub == "depth" else 0
            assert np.abs(out.astype(int) - ref.astype(int)).max() <= tol
    rows = [(tmp_path / d / "force.csv").read_text().splitlines()
            for d in ("port", "jax")]
    assert rows[0][0] == rows[1][0] == "index,fx,fy,fz,tx,ty,tz"
    out = np.array([[float(v) for v in r.split(",")] for r in rows[0][1:]])
    ref = np.array([[float(v) for v in r.split(",")] for r in rows[1][1:]])
    np.testing.assert_array_equal(out[:, 0], [0, 1, 2])
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert len(tloop.frame_times) == 3
    for times in tloop.frame_times:
        assert set(times) == set(tsl.STAGES) | {"total"}
        assert times["total"] >= sum(times[s] for s in tsl.STAGES) - 1e-9


def test_directory_replay(sensors, tmp_path):
    """PNGs written by the port replay through `DirectorySource` in order,
    with the force net off."""
    _, ts = sensors
    cap = tmp_path / "cap"
    cap.mkdir()
    rng = np.random.default_rng(18)
    frames = [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
              for _ in range(2)]
    for i, f in enumerate(frames):
        write_png(cap / f"frame_{i:05d}.png", f)
    (cap / "notes.txt").write_text("skipped")
    got = []
    loop = tsl.SensorLoop(sensor=ts, rate_hz=1000.0, run_force=False,
                          on_frame=lambda i, r: got.append((i, r)))
    assert loop.run(tsl.DirectorySource(cap)) == 2
    assert [i for i, _ in got] == [0, 1]
    for (_, r), f in zip(got, frames):
        np.testing.assert_array_equal(r["rect"], f)
        assert "force" not in r and r["depth"].shape == (64, 64)


def test_directory_source_jpeg_without_pil_raises(tmp_path, monkeypatch):
    import sys

    (tmp_path / "frame_00000.jpg").write_bytes(b"\xff\xd8\xff\xe0not-a-jpeg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(Exception, match="frame_00000.jpg"):
        next(tsl.DirectorySource(tmp_path).frames())


# ----------------------------------------------------------- training --

def _train_batch(seed, b=2, size=32):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, size, size, 3)).astype(np.float32)
    depths = rng.uniform(1.0, 255.0, (b, size, size)).astype(np.float32)
    depths[:, :4] = 0.0                     # no depth: the silog mask drops
    forces = rng.uniform(0, 1, (b, 6)).astype(np.float32)
    return images, depths, forces


def _jax_steps(step, params, opt, batches):
    state = opt.init(params)
    losses = []
    for batch in batches:
        params, state, m = step(params, state, *batch)
        losses.append(float(m["loss"]))
    return params, losses


def _train_case(compact, kind):
    """The flax net, its parameters, the port's net class and three
    batches of (images, targets)."""
    name = "force" if kind == "force" else "depth"
    jnet, params, _ = compact[name]
    batches = []
    for s in range(3):
        images, depths, forces = _train_batch(20 + s)
        batches.append((images, forces if kind == "force" else depths))
    cls = tsn.ForceNet if kind == "force" else tsn.TouchDepthNet
    return jnet, params, cls, batches


TRAIN_LOSSES = {
    "densetact": lambda m, p, y: m.densetact_depth_loss(p, y),
    "silog": lambda m, p, y: m.silog_loss(p, y, y > 0),
    "force": lambda m, p, y: m.rmse_loss(p, y),
}


@pytest.mark.parametrize("kind", sorted(TRAIN_LOSSES))
def test_train_step_gradients_match_jax(compact, kind):
    """The first step's gradients (autograd over the batch) against
    ``jax.grad`` of the JAX step's vmapped loss: atol 5e-6 (measured at
    most 1.4e-6, of gradients up to 3.8)."""
    jnet, params, cls, batches = _train_case(compact, kind)
    images, y = batches[0]
    fn = TRAIN_LOSSES[kind]
    grads = jax.jit(jax.grad(lambda p: fn(
        jl, jax.vmap(lambda im: jnet.apply(p, im))(images), y)))(params)
    tnet = tsn.load_flax_params(cls(), params)
    fn(tl, tnet(t(images)), t(y)).backward()
    ref = tsn.load_flax_params(cls(), jax.tree.map(np.asarray, grads))
    for (k, p), (_, r) in zip(tnet.named_parameters(),
                              ref.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), r.detach().numpy(),
                                   atol=5e-6, err_msg=k)


@pytest.mark.parametrize("kind", sorted(TRAIN_LOSSES))
def test_train_steps_match_jax(compact, kind):
    """Three steps of each train step against the JAX step with
    ``optax.adam`` from the same parameters on the same batches: the loss
    at every step within rtol 1e-5.  The parameters after: Adam divides
    each gradient by its own magnitude, so where the exact gradient is
    about 0 (the attention's key bias, which the softmax ignores; kernel
    entries near a sign change) float32 noise of 1e-9 becomes a step of up
    to lr.  Measured on this CPU: 0.007% (densetact), 2.5% (silog) and
    0.04% (force) of the entries more than 1e-5 apart, at most 1.4e-3 with
    lr 1e-3; held here at 95% within 1e-5 and all within 3·lr."""
    jnet, params, cls, batches = _train_case(compact, kind)
    lr = 1e-3
    if kind == "force":
        jstep = jst.make_force_train_step(jnet, optax.adam(lr))
    else:
        jstep = jst.make_depth_train_step(jnet, optax.adam(lr), loss=kind)
    jparams, jlosses = _jax_steps(jstep, params, optax.adam(lr), batches)

    tnet = tsn.load_flax_params(cls(), params)
    opt = torch.optim.Adam(tnet.parameters(), lr=lr, eps=1e-8)
    tstep = (tst.make_force_train_step(tnet, opt) if kind == "force" else
             tst.make_depth_train_step(tnet, opt, loss=kind))
    metrics = [tstep(t(x), t(y)) for x, y in batches]
    assert set(metrics[0]) == ({"loss"} if kind == "force"
                               else {"loss", "l1"})
    np.testing.assert_allclose([float(m["loss"]) for m in metrics], jlosses,
                               rtol=1e-5)

    ref = tsn.load_flax_params(cls(), jax.tree.map(np.asarray, jparams))
    start = tsn.load_flax_params(cls(), params)
    with torch.no_grad():
        diff = torch.cat([(p - r).abs().flatten() for p, r in zip(
            tnet.parameters(), ref.parameters())])
        moved = max(float((r - s).abs().max()) for r, s in zip(
            ref.parameters(), start.parameters()))
    share = float((diff > 1e-5).float().mean())
    print(f"{kind}: {share:.3%} of the parameters more than 1e-5 apart, at "
          f"most {float(diff.max()):.3e}; moved up to {moved:.3e}")
    assert moved > lr and share <= 0.05 and float(diff.max()) <= 3 * lr
