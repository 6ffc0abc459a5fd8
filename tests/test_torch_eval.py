"""Parity of the port's evaluation path (``touchgs_torch/eval/``,
``ops/ssim.py::ssim``, ``utils/transforms.py``) with the JAX package on
the CPU: the same numpy-seeded images, scenes and poses through both.

The metrics agree within rtol 1e-5 (PSNR, SSIM) and 1e-4 (LPIPS, at an
even and an odd size, where XLA's stride-2 "SAME" pads differently);
``evaluate_scene`` renders a tiny scene through both packages' scan path.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.data.cameras import Cameras as JCameras
from touchgs_tpu.data.scene import Scene as JScene
from touchgs_tpu.eval import lpips_vgg as jvgg
from touchgs_tpu.eval import metrics as jm
from touchgs_tpu.eval import render_path as jrp
from touchgs_tpu.eval import runner as jrun
from touchgs_tpu.models.gaussians import init_from_points
from touchgs_tpu.ops.ssim import ssim as j_ssim
from touchgs_tpu.utils import transforms as jtf
from touchgs_torch import eval as teval
from touchgs_torch.data.cameras import Cameras as TCameras
from touchgs_torch.data.scene import Scene as TScene
from touchgs_torch.eval import lpips_vgg as tvgg
from touchgs_torch.eval import metrics as tm
from touchgs_torch.eval import render_path as trp
from touchgs_torch.eval import runner as trun
from touchgs_torch.models.gaussians import params_from_numpy
from touchgs_torch.ops.ssim import ssim as t_ssim
from touchgs_torch.utils import transforms as ttf

from tests.synthetic import look_at_camera, random_gaussians

W, H = 64, 48


def _images(h, w, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.fixture
def clean_lpips_caches(monkeypatch):
    """Both packages cache the LPIPS weights named by the environment."""
    caches = (jm._lpips_params, jm._lpips_vgg_params, tm._lpips_params,
              tm._lpips_vgg_params)
    for c in caches:
        c.cache_clear()
    yield monkeypatch
    monkeypatch.delenv("TOUCHGS_LPIPS_WEIGHTS", raising=False)
    for c in caches:
        c.cache_clear()


def test_psnr_and_ssim_match():
    a, b = _images(40, 56)
    np.testing.assert_allclose(float(tm.psnr(torch.tensor(a), torch.tensor(b))),
                               float(jm.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(float(t_ssim(torch.tensor(a), torch.tensor(b))),
                               float(j_ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    assert float(t_ssim(torch.tensor(a), torch.tensor(a))) == pytest.approx(
        1.0, abs=1e-6)


def test_fallback_weights_equal_jax():
    for tw, jw in zip(tm._feature_stack_params(), jm._feature_stack_params()):
        np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("hw", [(32, 32), (33, 31)])
def test_lpips_distance_matches(clean_lpips_caches, hw):
    """Even and odd sizes: the stride-2 layers pad as XLA's "SAME"."""
    clean_lpips_caches.delenv("TOUCHGS_LPIPS_WEIGHTS", raising=False)
    a, b = _images(*hw, seed=1)
    t = float(tm.lpips_distance(torch.tensor(a), torch.tensor(b)))
    j = float(jm.lpips_distance(jnp.asarray(a), jnp.asarray(b)))
    assert t > 0
    np.testing.assert_allclose(t, j, rtol=1e-4)
    assert float(tm.lpips_distance(torch.tensor(a), torch.tensor(a))) < 1e-6


def _vgg_weights(seed=0) -> dict:
    """Random weights of LPIPS-VGG16's shapes (HWIO), He-scaled."""
    rng = np.random.default_rng(seed)
    p, cin = {}, 3
    for block, cout in zip(tvgg.VGG16_CONVS, tvgg.VGG16_CHANNELS):
        for ci in block:
            p[f"features.{ci}.weight"] = rng.normal(
                0, np.sqrt(2.0 / (9 * cin)), (3, 3, cin, cout)).astype(
                np.float32)
            p[f"features.{ci}.bias"] = rng.normal(0, 0.01, cout).astype(
                np.float32)
            cin = cout
    for k, c in enumerate(tvgg.VGG16_CHANNELS):
        p[f"lin{k}.model.1.weight"] = rng.uniform(0, 0.1, (1, 1, c, 1)).astype(
            np.float32)
    return p


def test_lpips_vgg_matches():
    p = _vgg_weights()
    a, b = _images(32, 32, seed=2)
    t = float(tvgg.lpips_vgg(p, torch.tensor(a), torch.tensor(b)))
    j = float(jvgg.lpips_vgg({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(a), jnp.asarray(b)))
    assert t > 0
    np.testing.assert_allclose(t, j, rtol=1e-4)


def test_lpips_weights_from_environment(clean_lpips_caches, tmp_path):
    """``TOUCHGS_LPIPS_WEIGHTS``: an lpips-package npz (``net.sliceK``
    names) selects LPIPS-VGG; any other npz replaces the random stack."""
    a, b = _images(32, 32, seed=3)
    vgg = {("net.slice1." + k.split(".", 1)[1] if k.startswith("features")
            else k): v for k, v in _vgg_weights(4).items()}
    np.savez(tmp_path / "vgg.npz", **vgg)
    stack = {f"w{i}": w * 0.5 for i, w in enumerate(
        jm._feature_stack_params(seed=9))}
    np.savez(tmp_path / "stack.npz", **stack)
    assert tvgg.is_lpips_params(tmp_path / "vgg.npz")
    assert not tvgg.is_lpips_params(tmp_path / "stack.npz")
    assert (set(tvgg.load_lpips_params(tmp_path / "vgg.npz"))
            == set(jvgg.load_lpips_params(tmp_path / "vgg.npz")))
    for name in ("vgg.npz", "stack.npz"):
        clean_lpips_caches.setenv("TOUCHGS_LPIPS_WEIGHTS",
                                  str(tmp_path / name))
        for c in (jm._lpips_params, jm._lpips_vgg_params, tm._lpips_params,
                  tm._lpips_vgg_params):
            c.cache_clear()
        assert (tm._lpips_vgg_params() is None) == (name == "stack.npz")
        t = float(tm.lpips_distance(torch.tensor(a), torch.tensor(b)))
        j = float(jm.lpips_distance(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(t, j, rtol=1e-4, err_msg=name)


def test_eval_metrics_match(clean_lpips_caches):
    clean_lpips_caches.delenv("TOUCHGS_LPIPS_WEIGHTS", raising=False)
    rng = np.random.default_rng(5)
    a, b = _images(H, W, seed=5)
    d0 = rng.uniform(1, 3, (H, W)).astype(np.float32)
    sup = np.where(rng.uniform(size=(H, W)) < 0.7, d0 + 0.1, 0).astype(
        np.float32)
    gt = np.where(rng.uniform(size=(H, W)) < 0.8, d0 - 0.2, 0).astype(
        np.float32)
    mask = rng.uniform(size=(H, W)) < 0.5
    t = teval.eval_metrics(*(torch.tensor(x) for x in (a, d0, b, sup, gt,
                                                        mask)))
    j = jm.eval_metrics(*(jnp.asarray(x) for x in (a, d0, b, sup, gt, mask)))
    assert list(t) == list(j) == ["psnr", "ssim", "lpips", "depth_mse",
                                  "supervised_depth_mse", "gt_depth_mse",
                                  "gt_object_depth_mse"]
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    assert list(teval.eval_metrics(torch.tensor(a), torch.tensor(d0),
                                   torch.tensor(b))) == ["psnr", "ssim",
                                                         "lpips"]


@pytest.mark.parametrize("fn", ["rotation_between", "orient_and_scale",
                                "quat_to_rotmat_np", "focal_from_fov"])
def test_transforms_match(fn):
    rng = np.random.default_rng(6)
    if fn == "rotation_between":
        for a, b in [(rng.normal(size=3), rng.normal(size=3)),
                     ([0, 0, 1.0], [0, 0, 1.0]), ([0, 0, 1.0], [0, 0, -1.0])]:
            np.testing.assert_array_equal(ttf.rotation_between(a, b),
                                          jtf.rotation_between(a, b))
    elif fn == "orient_and_scale":
        poses = np.stack(trp.orbit_path(radius=1.7, height=0.4, n_frames=5))
        for m, c in [("up", "poses"), ("none", "none")]:
            for x, y in zip(ttf.auto_orient_and_center_poses(poses, m, c),
                            jtf.auto_orient_and_center_poses(poses, m, c)):
                np.testing.assert_array_equal(x, y)
        for x, y in zip(ttf.auto_scale_poses(poses, 0.8),
                        jtf.auto_scale_poses(poses, 0.8)):
            np.testing.assert_array_equal(x, y)
    elif fn == "quat_to_rotmat_np":
        q = rng.normal(size=(7, 4))
        np.testing.assert_array_equal(ttf.quat_to_rotmat_np(q),
                                      jtf.quat_to_rotmat_np(q))
    else:
        assert ttf.focal_from_fov(0.9, 640) == jtf.focal_from_fov(0.9, 640)


def test_pose_paths_match(tmp_path):
    a, b, c = trp.orbit_path(radius=2.0, height=0.3, n_frames=3)
    for x, y in zip(trp.orbit_path(n_frames=7), jrp.orbit_path(n_frames=7)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(trp.interpolate_poses([a, b, c], 6),
                    jrp.interpolate_poses([a, b, c], 6)):
        np.testing.assert_array_equal(x, y)
    data = {"render_width": 320, "render_height": 240,
            "camera_path": [{"camera_to_world": p.ravel().tolist(),
                             "fov": 50.0} for p in (a, b)]}
    (tmp_path / "path.json").write_text(json.dumps(data))
    tp, jp = (m.load_camera_path_json(tmp_path / "path.json")
              for m in (trp, jrp))
    assert tp[1:] == jp[1:] == (320, 240, 50.0)
    for x, y in zip(tp[0], jp[0]):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def tiny():
    """150 Gaussians (capacity 256, SH 1) and a 3-view 64x48 scene, with
    the JAX package's initial parameters and the port's copy of them."""
    means, _, _, colors, _ = random_gaussians(150, seed=2)
    jparams = init_from_points(np.asarray(means), np.asarray(colors),
                               capacity=256, sh_degree=1)
    tparams = params_from_numpy({k: np.asarray(getattr(jparams, k))
                                 for k in ("means", "quats", "log_scales",
                                           "logit_opacities", "sh_dc",
                                           "sh_rest", "alive")}, "cpu")
    rng = np.random.default_rng(8)
    cams = [look_at_camera(eye=(2.2 * np.cos(t), 0.5, 2.2 * np.sin(t)),
                           width=W, height=H, focal=70.0)
            for t in (0.2, 0.9, 1.6)]
    arrays = dict(
        fx=np.array([float(c.fx) for c in cams], np.float32),
        fy=np.array([float(c.fy) for c in cams], np.float32),
        cx=np.array([float(c.cx) for c in cams], np.float32),
        cy=np.array([float(c.cy) for c in cams], np.float32),
        c2w=np.stack([np.asarray(c.c2w) for c in cams]))
    images = rng.uniform(0, 1, (3, H, W, 3)).astype(np.float32)
    depths = rng.uniform(1.5, 3.0, (3, H, W)).astype(np.float32)

    def scene(cameras_cls, scene_cls):
        return scene_cls(
            cameras=cameras_cls(**arrays, width=W, height=H), images=images,
            depths=depths, uncertainties=None, i_train=np.array([0]),
            i_eval=np.array([1, 2]), seed_points=None, seed_colors=None,
            scale_factor=1.0, transform=np.eye(4)[:3], name="tiny")

    def cfg(mod):
        return mod.TrainConfig(model=mod.ModelConfig(
            max_gaussians=256, sh_degree=1,
            rasterize=mod.RasterizeConfig(gaussian_chunk=64)))

    return dict(jparams=jparams, tparams=tparams, depths=depths,
                jscene=scene(JCameras, JScene), tscene=scene(TCameras, TScene),
                jcfg=cfg(jcfg), tcfg=cfg(tcfg))


def test_evaluate_scene_matches(tiny, clean_lpips_caches, tmp_path):
    clean_lpips_caches.delenv("TOUCHGS_LPIPS_WEIGHTS", raising=False)
    gt = tiny["depths"] * 1.05
    t = trun.evaluate_scene(tiny["tparams"], tiny["tscene"], tiny["tcfg"],
                            gt_depths=gt, render_dir=str(tmp_path / "r"))
    j = jrun.evaluate_scene(tiny["jparams"], tiny["jscene"], tiny["jcfg"],
                            gt_depths=gt)
    assert list(t) == list(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    assert sorted(p.name for p in (tmp_path / "r").iterdir()) == [
        "00001_depth.png", "00001_rgb.png", "00002_depth.png",
        "00002_rgb.png"]
    # the train split
    ttrain = trun.evaluate_scene(tiny["tparams"], tiny["tscene"],
                                 tiny["tcfg"], split="train")
    jtrain = jrun.evaluate_scene(tiny["jparams"], tiny["jscene"],
                                 tiny["jcfg"], split="train")
    for k in jtrain:
        np.testing.assert_allclose(ttrain[k], jtrain[k], rtol=1e-4)


def test_eval_json_and_averages(tmp_path):
    files = []
    for i, (r, mod) in enumerate([({"psnr": 30.0, "ssim": 0.9}, trun),
                                  ({"psnr": 32.0, "ssim": 0.8}, jrun)]):
        files.append(tmp_path / f"t{i}" / "eval.json")
        mod.write_eval_json(r, files[-1], experiment_name="exp")
    assert (json.loads(files[0].read_text()).keys()
            == json.loads(files[1].read_text()).keys())
    assert trun.compute_averages(files) == jrun.compute_averages(files)
    assert trun.compute_averages(files)["psnr"] == {"mean": 31.0, "std": 1.0}


def test_render_camera_path_matches(tiny, tmp_path):
    poses = trp.orbit_path(radius=2.0, n_frames=3)
    t = trp.render_camera_path(tiny["tparams"], poses, tiny["tcfg"],
                               width=W, height=H, out_dir=tmp_path / "f")
    j = jrp.render_camera_path(tiny["jparams"], poses, tiny["jcfg"],
                               width=W, height=H)
    assert len(t) == 3 and t[0].shape == (H, W, 3) and t[0].dtype == np.uint8
    assert any(f.max() > 0 for f in t)
    for a, b in zip(t, j):
        # uint8 frames: a value on a rounding edge may land one step away
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert len(list((tmp_path / "f").iterdir())) == 3
