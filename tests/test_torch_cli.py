"""``python -m touchgs_torch.cli`` against ``python -m touchgs_tpu.cli`` on
two copies of tests/test_cli.py's scene (6 views at 48x64), each CLI with
``--cpu``: the subcommands' outputs compared within the tolerances each
test states.  The JAX CLI runs each subcommand once, in module fixtures."""
import json
import shutil
import signal
import urllib.request

import jax
import numpy as np
import pytest
import torch

from touchgs_tpu import cli as jcli
from touchgs_tpu.data.depth_io import read_depth_mm as j_read_depth_mm
from touchgs_torch import cli as tcli
from touchgs_torch.data.png import read_png, read_rgb
from touchgs_torch.touch import fusion as tfusion

from tests.test_cli import _build_scene_dir

H, W, N = 48, 64, 6
TRAIN = ["--preset", "bunny_blender", "--max-steps", "5", "--is-sim", "--cpu"]


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


def _files(root, sub):
    return sorted((root / sub).iterdir())


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(JAX's copy, the port's copy) after read-touch-depths,
    read-realsense, fuse, add-depth-paths and seed in each CLI."""
    jroot = _build_scene_dir(tmp_path_factory.mktemp("jax_scene"))
    troot = tmp_path_factory.mktemp("torch_scene")
    shutil.rmtree(troot)
    shutil.copytree(jroot, troot)
    rng = np.random.default_rng(1)
    for root in (jroot, troot):
        (root / "realsense_depth").mkdir()
    for i in range(2):
        mm = rng.uniform(300, 3000, (120, 200)).astype(np.float32)
        for root in (jroot, troot):
            np.save(root / "realsense_depth" / f"frame_{i:05d}.npy", mm)

    for cli, root in ((jcli, jroot), (tcli, troot)):
        cli.main(["read-touch-depths", "--root", str(root)])
        cli.main(["read-realsense", "--root", str(root), "--out_dir",
                  "realsense_remapped"] + (["--cpu"] if cli is tcli else []))
    _fuse_both(jroot, troot)
    for cli, root in ((jcli, jroot), (tcli, troot)):
        cli.main(["add-depth-paths", "--root_dir", str(root),
                  "--fused_output_dir", "fused"])
        cli.main(["seed", "--root_dir", str(root), "--train_split", "0.5",
                  "--percent_take", "50", "--cpu"])
    return jroot, troot


def _fuse_both(jroot, troot):
    """``fuse`` in each CLI; the port's 1% masks are JAX's permutations
    (``jax.random.split`` of PRNGKey(--seed) a view, as the JAX CLI draws
    them), injected into ``fuse_view`` (ROADMAP.md C13)."""
    args = ["--aligning_depths", "realsense_depths", "--zoe_depth_path",
            "zoe_out", "--touch_depth", "touch_depth", "--touch_var",
            "touch_var", "--vision_output_dir", "vision",
            "--fused_output_dir", "fused", "--use_uncertainty", "--is_sim",
            "--cpu"]
    jcli.main(["fuse", "--root_dir", str(jroot)] + args)
    key, perms = jax.random.PRNGKey(0), []
    for _ in range(N):
        key, sub = jax.random.split(key)
        perms.append(torch.tensor(np.asarray(
            jax.random.permutation(sub, H * W))))
    real = tfusion.fuse_view
    it = iter(perms)

    def injected(generator, *a, **k):
        return real(generator, *a, perm=next(it), **k)

    tfusion.fuse_view = injected
    try:
        tcli.main(["fuse", "--root_dir", str(troot)] + args)
    finally:
        tfusion.fuse_view = real
    assert next(it, None) is None


def test_read_touch_depths_byte_identical(scenes):
    jroot, troot = scenes
    for sub in ("touch_depth", "touch_var"):
        jf, tf = _files(jroot, sub), _files(troot, sub)
        assert [p.name for p in jf] == [p.name for p in tf] and len(jf) == N
        for a, b in zip(jf, tf):
            np.testing.assert_array_equal(j_read_depth_mm(b),
                                          j_read_depth_mm(a))


def test_read_realsense_matches(scenes):
    """The remap at 1280x720: within 1 mm (a truncating cast after a float
    remap) at under 0.1% of pixels."""
    jroot, troot = scenes
    jf, tf = (_files(r, "realsense_remapped") for r in scenes)
    assert len(jf) == len(tf) == 2
    for a, b in zip(jf, tf):
        da, db = j_read_depth_mm(a), j_read_depth_mm(b)
        assert da.shape == db.shape == (720, 1280)
        diff = np.abs(da - db)
        assert diff.max() <= 1e-3 + 1e-7
        assert (diff > 0).mean() < 1e-3


def test_fuse_matches(scenes):
    """Each fused map, uncertainty and vision output within 1 mm (C14's
    3.3e-6 m, then the truncating mm cast) at under 1% of pixels."""
    jroot, troot = scenes
    for sub in ("fused", "fused_uncertainty", "vision", "vision_baseline"):
        jf, tf = _files(jroot, sub), _files(troot, sub)
        assert len(jf) == len(tf) == N
        for a, b in zip(jf, tf):
            da, db = j_read_depth_mm(a), j_read_depth_mm(b)
            diff = np.abs(da - db)
            assert diff.max() <= 1e-3 + 1e-7, (sub, a.name, diff.max())
            assert (diff > 0).mean() < 1e-2, (sub, a.name)


def test_add_depth_paths_byte_identical(scenes):
    jroot, troot = scenes
    assert ((troot / "transforms.json").read_bytes()
            == (jroot / "transforms.json").read_bytes())


def test_seed_matches(scenes):
    """The same points (numpy's draw over the same pixels) within 1e-5 m
    (f32 backprojection), the same colours."""
    jroot, troot = scenes
    for name, atol in (("points_touch.npy", 1e-5), ("points_colors.npy", 0)):
        a, b = np.load(jroot / name), np.load(troot / name)
        assert a.shape == b.shape and len(a) > 100
        np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def trained(scenes, tmp_path_factory):
    """5 steps of ``train`` on the scan path in each CLI, then ``eval``."""
    jroot, troot = scenes
    out = tmp_path_factory.mktemp("outputs")
    results = {}
    for cli, root, tag in ((jcli, jroot, "jax"), (tcli, troot, "torch")):
        flags = ["--data", str(root), "--output-dir", str(out / tag)] + TRAIN
        cli.main(["train"] + flags)
        cli.main(["eval"] + flags)
        run = sorted((out / tag / root.name / "depth-gaussian-splatting"
                      ).iterdir())[-1]
        results[tag] = (run, json.loads((run / "eval.json").read_text()))
    return results, out


def test_train_eval_match(trained):
    """The eval metrics of the two 5-step runs within rtol 1e-3, as
    tests/test_torch_train.py holds the trainers' losses; SSIM, which sits
    at 0.006 on this scene of uniform noise, within 1e-4 on its [-1, 1]
    scale (measured: 1.9e-5, a relative 3.2e-3)."""
    results, _ = trained
    (jrun, j), (trun, t) = results["jax"], results["torch"]
    assert t["experiment_name"] == trun.parents[1].name
    assert set(t["results"]) == set(j["results"]) >= {"psnr", "ssim", "lpips"}
    gaps = {}
    for k, v in j["results"].items():
        assert np.isfinite(t["results"][k]), k
        gaps[k] = abs(t["results"][k] - v)
        if k == "ssim":
            np.testing.assert_allclose(t["results"][k], v, rtol=0, atol=1e-4)
        else:
            np.testing.assert_allclose(t["results"][k], v, rtol=1e-3,
                                       atol=1e-6, err_msg=k)
    print(f"eval metrics, |port - JAX|: {gaps}; JAX's: {j['results']}")
    for name in ("config.json", "capacities.json"):
        assert ((trun / name).read_text() == (jrun / name).read_text()), name
    assert sorted(p.name for p in (trun / "checkpoints").iterdir()) == ["5.pt"]


def test_render_and_export_write_their_files(scenes, trained):
    _, troot = scenes
    results, out = trained
    run = results["torch"][0]
    flags = ["--data", str(troot), "--output-dir", str(out / "torch"),
             "--load-run", str(run)] + TRAIN
    render_dir = tcli.main(["render"] + flags)
    rgbs = sorted(render_dir.glob("*_rgb.png"))
    assert len(rgbs) == 5 and len(list(render_dir.glob("*_depth.png"))) == 5
    assert read_rgb(rgbs[0]).shape == (H, W, 3)
    trainer, ply = tcli.main(["export-splat"] + flags)
    assert ply == run / "splat.ply" and ply.stat().st_size > 0
    from touchgs_tpu.data.ply import load_gaussians_ply

    back = load_gaussians_ply(ply)
    assert int(back.num_alive) == int(trainer.state.params.num_alive)


def test_pipeline_runs_and_refuses_without_monodepth(tmp_path_factory,
                                                     tmp_path):
    """``pipeline`` without its monocular-depth directory runs that stage
    (the compact trunk on the CPU) and every other to ``eval.json``.  With
    ``--zoe-weights`` a trunk npz saved by the JAX package, its
    ``zoe_depth/`` PNGs equal those of the JAX CLI's ``pipeline`` on a copy
    of the scene within 1 mm (the truncating mm cast of depths that agree
    to about 1e-5 m; measured: at most 1 mm, at under 1% of pixels).  The
    name is kept from when the stage was not ported and refused."""
    import jax.numpy as jnp

    from touchgs_tpu.vision import monodepth as jmono

    jroot = _build_scene_dir(tmp_path_factory.mktemp("pipe_scene"))
    troot = tmp_path / "pipe_scene"
    shutil.copytree(jroot, troot)
    weights = tmp_path / "trunk.npz"
    jmono.save_npz_weights(jmono.DPTDepthModel().init(
        jax.random.PRNGKey(0), jnp.zeros((384, 384, 3))), weights)
    results = {}
    for cli, root in ((jcli, jroot), (tcli, troot)):
        assert not (root / "zoe_depth").exists()
        results[cli] = cli.main([
            "pipeline", "--data", str(root), "--preset", "bunny_real",
            "--max-steps", "3", "--output-dir", str(root / "out"),
            "--zoe-weights", str(weights), "--cpu"])
    assert {"psnr", "ssim", "lpips"} <= set(results[tcli])
    jf, tf = _files(jroot, "zoe_depth"), _files(troot, "zoe_depth")
    assert [p.name for p in tf] == [p.name for p in jf] and len(tf) == N
    for a, b in zip(jf, tf):
        da, db = (read_png(f).astype(np.int64) for f in (a, b))
        assert da.shape == (H, W) and (da > 0).mean() > 0.5
        diff = np.abs(da - db)
        assert diff.max() <= 1, (a.name, diff.max())
        assert (diff > 0).mean() < 1e-2, a.name
    assert len(_files(troot, "touch_depth")) == N
    assert len(_files(troot, "fused_output_dir_uncertainty")) == N
    assert (troot / "points_touch.npy").exists()
    meta = json.loads((troot / "transforms.json").read_text())
    assert meta["frames"][0]["depth_file_path"].startswith("fused_output_dir/")


def test_gpis_render_writes_maps(tmp_path_factory):
    root = _build_scene_dir(tmp_path_factory.mktemp("gpis_scene"))
    shutil.rmtree(root / "gpis_depth")
    shutil.rmtree(root / "gpis_var")
    d = np.random.default_rng(2).normal(size=(200, 3))
    np.save(root / "pts.npy", 0.3 * d / np.linalg.norm(d, axis=1,
                                                         keepdims=True))
    tcli.main(["gpis-render", "--root", str(root), "--points",
               str(root / "pts.npy"), "--samples", "16", "--max-points",
               "100", "--cpu"])
    maps = _files(root, "gpis_depth")
    assert len(maps) == N and np.load(maps[0]).shape == (H, W)


def test_gpu_is_the_default(scenes, tmp_path, capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, troot = scenes
    flags = ["--data", str(troot), "--output-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="--cpu"):
        tcli.main(["train", "--preset", "bunny_blender", "--max-steps", "1"]
                  + flags)
    # the viewer serves: ``train --viewer`` on port 0, then ``viewer`` on
    # the run, its /state read while it waits for the interrupt
    trainer, _ = tcli.main(["train", "--viewer", "--viewer-port", "0",
                            "--preset", "bunny_blender", "--is-sim",
                            "--max-steps", "2", "--cpu"] + flags)
    assert trainer.state.step == 2
    assert "live viewer at http://127.0.0.1:" in capsys.readouterr().out
    seen = []

    def pause():
        url = capsys.readouterr().out.split("viewer at ")[1].split()[0]
        with urllib.request.urlopen(url + "state", timeout=10) as r:
            seen.append(json.loads(r.read()))
        raise KeyboardInterrupt

    monkeypatch.setattr(signal, "pause", pause)
    tcli.main(["viewer", "--port", "0", "--cpu"] + flags)
    assert len(seen) == 1 and np.isnan(seen[0].pop("loss"))
    assert seen[0] == {"step": 2, "num_alive": int(trainer.state.params.num_alive),
                       "training": False}
