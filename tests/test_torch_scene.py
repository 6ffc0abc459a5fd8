"""The port's scene IO (``touchgs_torch/data/scene.py::load_scene`` and the
modules it reads through) against the JAX package's on the same scene
directories, on the CPU: plain, OPENCV and OPENCV_FISHEYE distortion,
``downscale_factor`` 2, with and without depth, uncertainty and seeds, and
a frame whose image is missing.  Images, depths and seeds exact, poses
within 1e-6, the splits equal; then ``linspace_split``,
``undistort_image``, ``Cameras.rescale``, the depth PNG contract and the
RealSense remap on their own."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from touchgs_tpu.data import depth_io as jdio
from touchgs_tpu.data import realsense as jrs
from touchgs_tpu.data import scene as jscene
from touchgs_tpu.data import splits as jsplits
from touchgs_tpu.data import undistort as jund
from touchgs_tpu.data.cameras import Cameras as JCameras
from touchgs_torch.data import depth_io as tdio
from touchgs_torch.data import realsense as trs
from touchgs_torch.data import scene as tscene
from touchgs_torch.data import splits as tsplits
from touchgs_torch.data import undistort as tund
from touchgs_torch.data.cameras import Cameras as TCameras

H, W, N = 48, 64, 6


def _write_scene(root, seed=0, distortion=None, depth=True, unc=True,
                 seeds=True, missing=False):
    """A Touch-GS-layout directory written through PIL, as a capture is:
    RGB and RGBA images, uint16-mm depth and uncertainty PNGs, seeds."""
    rng = np.random.default_rng(seed)
    for d in ("imgs", "depth", "unc"):
        (root / d).mkdir(parents=True)
    frames = []
    for i in range(N):
        name = f"frame_{i:05d}"
        img = rng.integers(0, 256, (H, W, 4 if i % 2 else 3), dtype=np.uint8)
        if not (missing and i == 2):
            Image.fromarray(img).save(root / "imgs" / f"{name}.png")
        jdio.write_depth_mm(root / "depth" / f"{name}.png",
                            rng.uniform(0.5, 3.0, (H, W)))
        jdio.write_depth_mm(root / "unc" / f"{name}.png",
                            rng.uniform(0.0, 0.2, (H, W)))
        ang = 2 * np.pi * i / N
        eye = np.array([2.0 * np.cos(ang), 2.0 * np.sin(ang), 0.7 + 0.1 * i])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
        frame = {"file_path": f"imgs/{name}.png",
                 "transform_matrix": c2w.tolist()}
        if depth:
            frame["depth_file_path"] = f"depth/{name}.png"
        if unc:
            frame["uncertainty_file_path"] = f"unc/{name}.png"
        if i == 3:      # per-frame intrinsics override the global ones
            frame.update(fl_x=61.0, cx=30.5)
        frames.append(frame)
    meta = {"fl_x": 55.0, "fl_y": 57.0, "cx": W / 2, "cy": H / 2,
            "w": W, "h": H, "frames": frames}
    if distortion == "OPENCV":
        meta.update(k1=-0.08, k2=0.01, p1=0.002, p2=-0.001)
    elif distortion == "OPENCV_FISHEYE":
        meta.update(camera_model="OPENCV_FISHEYE", k1=0.05, k2=-0.01)
        frames[1].update(camera_model="OPENCV", k1=0.0, k2=0.0)
    (root / "transforms.json").write_text(json.dumps(meta))
    if seeds:
        np.save(root / "points_touch.npy",
                rng.normal(0, 0.3, (500, 3)).astype(np.float32))
        np.save(root / "points_colors.npy",
                rng.uniform(0, 255, (500, 3)).astype(np.float32))
    return root


CASES = {
    "plain": dict(),
    "opencv": dict(distortion="OPENCV"),
    "fisheye": dict(distortion="OPENCV_FISHEYE"),
    "downscale2": dict(),
    "no_depth_unc_seeds": dict(depth=False, unc=False, seeds=False),
    "depth_only": dict(unc=False),
    "missing_image": dict(missing=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_load_scene_matches_jax(case, tmp_path):
    root = _write_scene(tmp_path / case, seed=len(case), **CASES[case])
    kw = dict(train_split_fraction=0.5,
              downscale_factor=2 if case == "downscale2" else 1)
    j = jscene.load_scene(root, **kw)
    t = tscene.load_scene(root, **kw)
    assert t.name == j.name == case
    assert t.num_views == j.num_views == (N - 1 if case == "missing_image"
                                          else N)
    for k in ("images", "depths", "uncertainties", "seed_points",
              "seed_colors"):
        a, b = getattr(t, k), getattr(j, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("fx", "fy", "cx", "cy", "c2w"):
        np.testing.assert_allclose(getattr(t.cameras, k),
                                   getattr(j.cameras, k), atol=1e-6, err_msg=k)
    assert (t.cameras.width, t.cameras.height) == (j.cameras.width,
                                                   j.cameras.height)
    np.testing.assert_array_equal(t.i_train, j.i_train)
    np.testing.assert_array_equal(t.i_eval, j.i_eval)
    assert t.scale_factor == j.scale_factor
    np.testing.assert_array_equal(t.transform, j.transform)
    # the poses are normalised: every camera inside the +/-1 box
    assert np.abs(t.cameras.c2w[:, :3, 3]).max() == pytest.approx(1.0)


def test_splits_match_jax():
    for n in (1, 6, 12, 100):
        for frac in (0.08, 0.13, 0.5, 0.8, 0.9):
            for variant in ("dataparser", "seeding"):
                a = tsplits.linspace_split(n, frac, variant)
                b = jsplits.linspace_split(n, frac, variant)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        tsplits.linspace_split(6, 0.5, "other")


@pytest.mark.parametrize("fisheye", [False, True])
def test_undistort_matches_jax(fisheye):
    rng = np.random.default_rng(int(fisheye))
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    dep = rng.uniform(0.5, 2.0, (H, W)).astype(np.float32)
    params = np.array([0.05, -0.01, 0.002, 0.0, 0.001, -0.002])
    for a, nearest in ((img, False), (dep, True)):
        np.testing.assert_array_equal(
            tund.undistort_image(a, 55.0, 57.0, 31.0, 23.5, params, fisheye,
                                 nearest=nearest),
            jund.undistort_image(a, 55.0, 57.0, 31.0, 23.5, params, fisheye,
                                 nearest=nearest))


def test_cameras_rescale_matches_jax():
    rng = np.random.default_rng(3)
    arrays = dict(fx=rng.uniform(50, 60, 4).astype(np.float32),
                  fy=rng.uniform(50, 60, 4).astype(np.float32),
                  cx=rng.uniform(30, 34, 4).astype(np.float32),
                  cy=rng.uniform(22, 26, 4).astype(np.float32),
                  c2w=np.tile(np.eye(4, dtype=np.float32), (4, 1, 1)))
    for f in (0.5, 1 / 3, 2.0):
        t = TCameras(**arrays, width=65, height=47).rescale(f)
        j = JCameras(**arrays, width=65, height=47).rescale(f)
        for k in ("fx", "fy", "cx", "cy", "c2w"):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
        assert (t.width, t.height) == (j.width, j.height)


def test_depth_png_contract_matches_jax(tmp_path):
    d = np.random.default_rng(4).uniform(0, 5, (H, W)).astype(np.float32)
    tdio.write_depth_mm(tmp_path / "t.png", d)
    jdio.write_depth_mm(tmp_path / "j.png", d)
    for p in ("t.png", "j.png"):
        np.testing.assert_array_equal(tdio.read_depth_mm(tmp_path / p),
                                      jdio.read_depth_mm(tmp_path / "j.png"))
    nan = np.where(d > 2.5, d, np.nan)
    np.save(tmp_path / "d.npy", nan)
    np.testing.assert_array_equal(tdio.read_npy_depth(tmp_path / "d.npy"),
                                  jdio.read_npy_depth(tmp_path / "d.npy"))


def test_realsense_remap_matches_jax():
    """The K_old·K_new⁻¹ remap at a reduced output size: within 2e-6 m of
    JAX's (one f32 rounding of the bilinear weights)."""
    d = np.random.default_rng(5).uniform(0.3, 3.0, (120, 200)).astype(
        np.float32)
    old = (90.0, 90.0, 100.5, 60.2)
    new = (160.0, 162.0, 80.3, 40.1)
    t = trs.convert_intrinsics(torch.as_tensor(d), old, new, (160, 90))
    j = jrs.convert_intrinsics(jnp.asarray(d), old, new, (160, 90))
    assert t.shape == (90, 160)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-6, rtol=0)
