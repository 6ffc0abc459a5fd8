"""The capture tooling of the port (``touchgs_torch/data``: ``colmap``,
``capture_convert``, ``capture_tools``, ``rosbag``, ``pc_depth``,
``meshing``) against the JAX package's functions on the same inputs from
numpy seeds.  Host code (parsers, converters, the bag reader, the blur
filter, the marching tetrahedra) must agree exactly; the torch ops within
the float32 tolerances each test states.  Meshes are compared as sets of
faces or by their rendered depth, not by vertex order."""
import bz2
import dataclasses
import json
import shutil
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.synthetic import look_at_camera
from tests.test_rosbag import _connection, _message, _record, _ros_header, _string, _tf_msg
from touchgs_tpu.data import capture_convert as jcc
from touchgs_tpu.data import capture_tools as jct
from touchgs_tpu.data import colmap as jcol
from touchgs_tpu.data import meshing as jmesh
from touchgs_tpu.data import pc_depth as jpc
from touchgs_tpu.data import rosbag as jbag
from touchgs_torch.data import capture_convert as tcc
from touchgs_torch.data import capture_tools as tct
from touchgs_torch.data import colmap as tcol
from touchgs_torch.data import meshing as tmesh
from touchgs_torch.data import pc_depth as tpc
from touchgs_torch.data import png
from touchgs_torch.data import rosbag as tbag
from touchgs_torch.data.cameras import Camera


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one intra-op thread for this module (ROADMAP.md C18);
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _camera(eye=(0.0, 0.0, 2.0), w=64, h=48, focal=60.0):
    jc = look_at_camera(eye=eye, width=w, height=h, focal=focal)
    tc = Camera(**{f.name: (getattr(jc, f.name) if f.name in
                            ("width", "height")
                            else torch.tensor(np.asarray(getattr(jc, f.name))))
                   for f in dataclasses.fields(Camera)})
    return jc, tc


def _sphere(n=3000, r=0.5, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True) * r


# ------------------------------------------------------------- colmap --

def test_colmap_parsing_and_scale(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "cameras.txt").write_text(
        "# Camera list\n1 SIMPLE_RADIAL 640 480 500.5 320 240 0.01\n"
        "2 PINHOLE 800 600 700 710 400 300\n3 OPENCV 64 48 50 51 32 24 0 0 "
        "0 0\n")
    lines = ["# Image list", "#"]
    for i in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3)
        lines.append(f"{i + 1} {' '.join(map(str, q))} {' '.join(map(str, t))}"
                     f" 1 frame_{i:03d}.png")
        lines.append("1.0 2.0 -1 3.0 4.0 7")
    (tmp_path / "images.txt").write_text("\n".join(lines) + "\n")

    jcams = jcol.read_colmap_cameras(tmp_path / "cameras.txt")
    tcams = tcol.read_colmap_cameras(tmp_path / "cameras.txt")
    assert jcams.keys() == tcams.keys()
    for k in jcams:
        assert tcams[k].intrinsics == jcams[k].intrinsics
        np.testing.assert_array_equal(tcams[k].params, jcams[k].params)
    for full in (False, True):
        a = jcol.read_colmap_images(tmp_path / "images.txt", full)
        b = tcol.read_colmap_images(tmp_path / "images.txt", full)
        assert list(a) == list(b) and len(a) == 5
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    pos = tcol.read_colmap_images(tmp_path / "images.txt")
    other = {k: 2.5 * v + 1.0 for k, v in pos.items()}
    assert (tcol.compute_scale_factor(other, pos)
            == jcol.compute_scale_factor(other, pos))
    assert abs(tcol.compute_scale_factor(other, pos) - 2.5) < 1e-12
    with pytest.raises(ValueError):
        tcol.compute_scale_factor({"a": np.zeros(3)}, {"b": np.zeros(3)})


# ---------------------------------------------------- capture_convert --

@pytest.mark.parametrize("config", [
    {"fl_x": 500.0, "fl_y": 510.0}, {"fl_x": 400.0}, {"fl_y": 300.0},
    {"camera_angle_x": 0.9, "camera_angle_y": 0.7},
    {"camera_angle_x": 0.8}, {"camera_angle_y": 0.6}, {}])
def test_resolve_focal(config):
    if not config:
        for mod in (jcc, tcc):
            with pytest.raises(RuntimeError):
                mod.resolve_focal(48, 64, config)
        return
    assert tcc.resolve_focal(48, 64, config) == jcc.resolve_focal(48, 64,
                                                                  config)


def test_pose_and_depth_rescale():
    rng = np.random.default_rng(1)
    pose = np.eye(4)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = rng.normal(size=3)
    np.testing.assert_array_equal(tcc.convert_capture_pose(pose, 0.001),
                                  jcc.convert_capture_pose(pose, 0.001))
    raw = rng.integers(0, 256, (20, 30)).astype(np.uint8)
    np.testing.assert_array_equal(tcc.rescale_depth_capture(raw, 0.1, 2.0),
                                  jcc.rescale_depth_capture(raw, 0.1, 2.0))


def test_captures_to_transforms(tmp_path):
    """A color/depth/touch capture (per-camera and top-level intrinsics, a
    frame whose file is missing) → the same transforms.json."""
    rng = np.random.default_rng(2)
    for mode, (h, w) in (("color", (48, 64)), ("depth", (30, 40)),
                         ("touch", (20, 20))):
        d = tmp_path / mode
        d.mkdir()
        frames = []
        for i in range(3):
            name = f"f{i}.png"
            if i < 2:
                Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                                ).save(d / name)
            frames.append({"file_path": name, "camera": i % 2,
                           "transform_matrix": rng.normal(size=(4, 4)
                                                          ).tolist()})
        meta = {"frames": frames}
        if mode == "color":
            meta["cameras"] = [{"fl_x": 50.0, "cx": 30.0},
                               {"camera_angle_x": 0.8}]
        else:
            meta["camera_angle_y"] = 0.5
            for f in frames:
                del f["camera"]
        (d / "transforms_train.json").write_text(json.dumps(meta))
    modes = ("color", "depth", "touch")
    a = jcc.captures_to_transforms(tmp_path, modes, units=0.01,
                                   output_path=tmp_path / "a.json")
    b = tcc.captures_to_transforms(tmp_path, modes, units=0.01,
                                   output_path=tmp_path / "b.json")
    assert a == b and len(b["frames"]) == 6
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json"
                                                 ).read_text()


# ------------------------------------------------------ capture_tools --

def _capture_dir(root, n=14, size=(40, 56)):
    """Sharp noise frames, two blurred ones and a burst of near-duplicates,
    saved by PIL in several modes."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 255, size + (3,), dtype=np.uint8)
    root.mkdir()
    for i in range(n):
        if i in (2, 7):
            img = np.full(size + (3,), 120, np.uint8)
            img[::8] = 130
        elif i >= 9:
            img = np.clip(base.astype(int) + rng.integers(-2, 3, base.shape),
                          0, 255).astype(np.uint8)
        else:
            img = rng.integers(0, 255, size + (3,), dtype=np.uint8)
        im = Image.fromarray(img)
        im = im.convert(("RGB", "L", "RGBA")[i % 3])
        im.save(root / f"frame_{i:03d}.png")
    (root / "notes.txt").write_text("skipped")


def test_blur_and_psnr_scores():
    rng = np.random.default_rng(4)
    for shape in ((40, 56), (40, 56, 3), (40, 56, 4)):
        img = rng.integers(0, 255, shape).astype(np.uint8)
        assert tct.laplacian_blur_score(img) == jct.laplacian_blur_score(img)
    a, b = (rng.integers(0, 255, (40, 56)).astype(np.uint8) for _ in range(2))
    assert tct.pairwise_psnr(a, b) == jct.pairwise_psnr(a, b)
    assert tct.pairwise_psnr(a, a) == jct.pairwise_psnr(a, a) == 100.0


def test_filter_blurry_dir(tmp_path):
    _capture_dir(tmp_path / "caps")
    for kw in ({}, {"similarity_threshold": 30.0, "ring": 4},
               {"similarity_threshold": None}):
        keep, reject = tct.filter_blurry_dir(tmp_path / "caps", **kw)
        assert (keep, reject) == jct.filter_blurry_dir(tmp_path / "caps",
                                                       **kw)
        assert len(keep) + len(reject) == 14
    _, reject = tct.filter_blurry_dir(tmp_path / "caps")
    assert {p.name for p in reject} >= {"frame_002.png", "frame_007.png"}


@pytest.mark.parametrize("size", [(900, 900), (300, 211)],
                         ids=["up_900", "down"])
@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_resize_scene_images_byte_for_byte(tmp_path, size, mode):
    """800x600 images resized by PIL's LANCZOS in the JAX tool and by the
    port's ``png.resize_lanczos``: the same pixels, byte for byte, in the
    same mode; the same rescaled transforms.json."""
    rng = np.random.default_rng(5)
    for root in (tmp_path / "jax", tmp_path / "port"):
        (root / "imgs").mkdir(parents=True)
    for i in range(2):
        img = rng.integers(0, 256, (600, 800, 4), dtype=np.uint8)
        img[:300, :400] = img[:1, :1]   # a flat block with sharp edges
        img[..., 3] = rng.choice([0, 77, 255], size=(600, 800))
        im = Image.fromarray(img, "RGBA").convert(mode)
        im.save(tmp_path / "jax" / "imgs" / f"frame_{i}.png")
    meta = {"fl_x": 700.0, "fl_y": 710.0, "cx": 400.0, "cy": 300.0,
            "w": 800, "h": 600, "frames": [
                {"file_path": "imgs/frame_0.png", "fl_x": 690.0, "w": 800}]}
    (tmp_path / "jax" / "transforms.json").write_text(json.dumps(meta))
    shutil.rmtree(tmp_path / "port")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    assert jct.resize_scene_images(tmp_path / "jax", size) == 2
    assert tct.resize_scene_images(tmp_path / "port", size) == 2
    for i in range(2):
        a = Image.open(tmp_path / "jax" / "imgs" / f"frame_{i}.png")
        b = png.decode_png(tmp_path / "port" / "imgs" / f"frame_{i}.png")
        assert b.mode == a.mode == mode and a.size == size
        np.testing.assert_array_equal(b.pixels, np.asarray(a))
    assert ((tmp_path / "port" / "transforms.json").read_text()
            == (tmp_path / "jax" / "transforms.json").read_text())


def test_resize_refuses_what_it_cannot_write(tmp_path):
    (tmp_path / "imgs").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        tmp_path / "imgs" / "a.jpg")
    with pytest.raises(ValueError, match="PNG"):
        tct.resize_scene_images(tmp_path, (4, 4))


# ------------------------------------------------------------- rosbag --

def _image_msg(h, w, encoding, data: np.ndarray) -> bytes:
    raw = data.tobytes()
    return (_ros_header() + struct.pack("<II", h, w) + _string(encoding)
            + b"\x00" + struct.pack("<I", raw and len(raw) // h)
            + struct.pack("<I", len(raw)) + raw)


@pytest.fixture
def rich_bag(tmp_path):
    """Images of five encodings (one in a bz2 chunk) and two tf messages."""
    rng = np.random.default_rng(6)
    imgs = [("mono8", rng.integers(0, 255, (4, 6), dtype=np.uint8)),
            ("mono16", rng.integers(0, 65535, (4, 6), dtype=np.uint16)),
            ("rgb8", rng.integers(0, 255, (4, 6, 3), dtype=np.uint8)),
            ("bgra8", rng.integers(0, 255, (4, 6, 4), dtype=np.uint8)),
            ("bgr8", rng.integers(0, 255, (5, 3, 3), dtype=np.uint8))]
    msgs = [_message(0, _image_msg(d.shape[0], d.shape[1], enc, d))
            for enc, d in imgs]
    chunk = _connection(2, "/other", "std_msgs/String") + msgs[-1] + \
        _message(1, _tf_msg())
    body = (_connection(0, "/camera/image_raw", "sensor_msgs/Image")
            + _connection(1, "/tf", "tf2_msgs/TFMessage")
            + b"".join(msgs[:-1]) + _message(1, _tf_msg())
            + _message(2, b"raw bytes")
            + _record({b"op": b"\x05", b"compression": b"bz2",
                       b"size": struct.pack("<I", len(chunk))},
                      bz2.compress(chunk)))
    p = tmp_path / "rich.bag"
    p.write_bytes(b"#ROSBAG V2.0\n" + body)
    return p


def test_bag_reader_matches(rich_bag):
    a, b = jbag.BagReader(rich_bag), tbag.BagReader(rich_bag)
    assert a.connections == b.connections and len(b.connections) == 3
    ma, mb = list(a.messages()), list(b.messages())
    assert len(ma) == len(mb) == 8
    for (ta, ya, xa), (tb, yb, xb) in zip(ma, mb):
        assert (ta, ya) == (tb, yb)
        if isinstance(xa, dict):
            np.testing.assert_array_equal(xb["data"], xa["data"])
            assert {k: v for k, v in xb.items() if k != "data"} == {
                k: v for k, v in xa.items() if k != "data"}
        elif isinstance(xa, list):
            for ua, ub in zip(xa, xb):
                np.testing.assert_array_equal(ub["translation"],
                                              ua["translation"])
                np.testing.assert_array_equal(ub["rotation_wxyz"],
                                              ua["rotation_wxyz"])
        else:
            assert xa == xb
    assert list(b.messages({"/tf"}))[0][0] == "/tf"


def test_extract_images_and_tf_matches(rich_bag, tmp_path):
    """The same PNG pixels (8- and 16-bit gray, RGB, RGBA) and poses."""
    a = jbag.extract_images_and_tf(rich_bag, "/camera/image_raw",
                                   tmp_path / "jax")
    b = tbag.extract_images_and_tf(rich_bag, "/camera/image_raw",
                                   tmp_path / "port")
    assert len(a["images"]) == len(b["images"]) == 5
    for pa, pb in zip(a["images"], b["images"]):
        ia = Image.open(pa)
        dec = png.decode_png(pb)
        assert dec.mode == ia.mode
        np.testing.assert_array_equal(dec.pixels, np.asarray(ia))
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "tf_poses.npy"),
                                  np.load(tmp_path / "jax" / "tf_poses.npy"))


# ----------------------------------------------------------- pc_depth --

@pytest.mark.parametrize("splat", [1, 3])
def test_render_pc_depth_matches_jax(splat):
    """The z-buffer of 3000 sphere points at 64x48: the same pixels hit,
    depths within 1e-6 m (float32 projection in another order)."""
    jc, tc = _camera()
    pts = _sphere()
    ref = np.asarray(jpc.render_pc_depth(
        jnp.asarray(pts), jc.w2c, jc.fx, jc.fy, jc.cx, jc.cy, jc.width,
        jc.height, splat))
    out = tpc.render_pc_depth(torch.from_numpy(pts), tc.w2c, tc.fx, tc.fy,
                              tc.cx, tc.cy, tc.width, tc.height, splat)
    out = out.numpy()
    assert ((out > 0) == (ref > 0)).all() and (ref > 0).mean() > 0.1
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_render_pc_depth_for_camera_with_normals():
    jc, tc = _camera(eye=(0.3, 0.2, 1.8))
    pts = _sphere(seed=1)
    normals = pts * 2.0
    ref = jpc.render_pc_depth_for_camera(pts, jc, normals=normals, splat=2)
    out = tpc.render_pc_depth_for_camera(pts, tc, normals=normals, splat=2)
    assert ((out > 0) == (ref > 0)).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    keep = tpc.visibility_by_normals(pts, normals, np.array([0, 0, 5.0]))
    np.testing.assert_array_equal(keep, jpc.visibility_by_normals(
        pts, normals, np.array([0, 0, 5.0])))
    empty = tpc.render_pc_depth_for_camera(pts, tc, normals=-np.ones_like(pts)
                                           * np.array([0, 0, 1.0]))
    assert empty.shape == (48, 64)


# ------------------------------------------------------------ meshing --

def test_estimate_normals_matches_jax():
    """The same k-NN PCA normals, oriented alike: |cos| within 1e-4 of 1
    and the same sign at every point (float32 eigensolvers differ in the
    last bits)."""
    pts = _sphere(1500)
    vp = np.array([0, 0, 5.0], np.float32)
    ref = jmesh.estimate_normals(pts, viewpoint=vp, chunk=512)
    out = tmesh.estimate_normals(pts, viewpoint=vp, chunk=512).numpy()
    cos = np.einsum("ni,ni->n", out, ref)
    assert cos.min() > 1 - 1e-4, cos.min()


def test_poisson_indicator_matches_jax():
    """χ on a 48³ grid within 5e-5 of its range (float32 splats and FFTs
    in another order: measured 1.0e-5); origin, spacing and level alike."""
    pts = _sphere(3000)
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    jchi, jo, js, jl = jmesh.poisson_indicator(pts, nrm, grid_res=48)
    chi, o, s, lvl = tmesh.poisson_indicator(pts, nrm, grid_res=48)
    jchi = np.asarray(jchi)
    rng_ = float(jchi.max() - jchi.min())
    np.testing.assert_allclose(chi.numpy(), jchi, rtol=0, atol=5e-5 * rng_)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
    assert abs(float(lvl) - float(jl)) <= 5e-5 * rng_


def _face_set(verts, faces, decimals=4):
    tri = np.round(np.asarray(verts)[np.asarray(faces)], decimals)
    return {tuple(sorted(map(tuple, t))) for t in tri}


def test_marching_tetrahedra_same_faces():
    """On the same χ the two extract the same set of triangles."""
    pts = _sphere(2000)
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    chi, origin, spacing, level = tmesh.poisson_indicator(pts, nrm,
                                                          grid_res=32)
    a = jmesh.marching_tetrahedra(chi.numpy(), float(level), origin.numpy(),
                                  float(spacing))
    b = tmesh.marching_tetrahedra(chi, float(level), origin, float(spacing))
    assert len(b[1]) == len(a[1]) > 500
    assert _face_set(*b) == _face_set(*a)


def test_marching_tetrahedra_drop_sign_case_7_as_the_reference():
    """A finding in the reference (ROADMAP.md C26): the sign symmetry folds
    case 0b1000 onto 0b0111, which the case table lacks, so a tet whose
    fourth vertex alone lies on its side of the level yields no triangle.
    Every tet of a cell shares corners 0 and 6 (its first and fourth
    vertices): corner 0 alone inside gives six triangles, corner 6 alone
    inside or alone outside none, in both packages."""
    for corner, sign, want in (((0, 0, 0), 1.0, 6), ((1, 1, 1), 1.0, 0),
                               ((1, 1, 1), -1.0, 0)):
        grid = np.full((2, 2, 2), sign, np.float32)
        grid[corner] = -sign
        a = jmesh.marching_tetrahedra(grid, 0.0, np.zeros(3), 1.0)
        b = tmesh.marching_tetrahedra(grid, 0.0, np.zeros(3), 1.0)
        assert len(a[1]) == len(b[1]) == want, (corner, sign)
        assert _face_set(*b) == _face_set(*a)


def test_render_mesh_depth_matches_jax():
    """A reconstructed sphere's mesh at 64x48: hits within 0.2% of pixels
    alike (the inside-test's edge pixels), depths within 1e-5 m."""
    jc, tc = _camera()
    pts = _sphere(3000)
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    chi, origin, spacing, level = jmesh.poisson_indicator(pts, nrm, 40)
    verts, faces = jmesh.marching_tetrahedra(np.asarray(chi), float(level),
                                             np.asarray(origin), float(spacing))
    ref = np.asarray(jmesh.render_mesh_depth(verts, faces, jc, 256))
    out = tmesh.render_mesh_depth(verts, faces, tc, 256).numpy()
    both = (out > 0) & (ref > 0)
    assert ((out > 0) != (ref > 0)).mean() <= 2e-3 and both.mean() > 0.1
    np.testing.assert_allclose(out[both], ref[both], rtol=0, atol=1e-5)
    quad = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0],
                     [-0.5, 0.5, 0]], np.float32)
    flat = tmesh.render_mesh_depth(quad, np.array([[0, 1, 2], [0, 2, 3]]),
                                   tc, 4096).numpy()
    assert abs(flat[24, 32] - 2.0) < 1e-5


def test_point_cloud_to_depth_via_mesh_matches_jax():
    """The whole chain at grid 40 (normals estimated toward the eye): by
    rendered depth, hits alike at all but 1% of pixels and depths within
    1 mm where both hit, the nearest about 1.5 m."""
    jc, tc = _camera(w=48, h=48, focal=48.0)
    pts = _sphere(3000)
    ref = np.asarray(jmesh.point_cloud_to_depth_via_mesh(pts, jc, grid_res=40,
                                                         max_pixels_per_face=256))
    out = tmesh.point_cloud_to_depth_via_mesh(pts, tc, grid_res=40,
                                              max_pixels_per_face=256)
    out = out.numpy()
    both = (out > 0) & (ref > 0)
    assert ((out > 0) != (ref > 0)).mean() <= 1e-2 and both.mean() > 0.05
    np.testing.assert_allclose(out[both], ref[both], rtol=0, atol=1e-3)
    assert abs(out[both].min() - 1.5) < 0.15
