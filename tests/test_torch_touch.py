"""The port's touch pipeline (``touchgs_torch/touch``) against the JAX
package's (``touchgs_tpu/touch``), on the CPU.

The same inputs, made with numpy from seeds, go through both packages:
48x64 maps, 32–48 px views, at most 300 contact points.  Where the JAX
function draws from a ``jax.random`` key, its permutation is injected into
the port.  A GP fitted by JAX is carried across with ``gpis_from_numpy`` for
the tight comparisons; fitted independently in each package the fp32
Cholesky factors differ (ROADMAP.md C14), hence the looser ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchgs_tpu.touch import calibration as jcal
from touchgs_tpu.touch import fusion as jfu
from touchgs_tpu.touch import gpis as jgp
from touchgs_tpu.touch import pointcloud as jpc
from touchgs_tpu.touch import uncertainty as jun
from touchgs_torch.data.cameras import Camera
from touchgs_torch.touch import calibration as tcal
from touchgs_torch.touch import fusion as tfu
from touchgs_torch.touch import gpis as tgp
from touchgs_torch.touch import pointcloud as tpc
from touchgs_torch.touch import uncertainty as tun

from tests.synthetic import look_at_camera


def _maps(seed=0, h=48, w=64):
    """(grounded, touch, vision, touch_var) float32, as tests/test_fusion.py
    makes them."""
    rng = np.random.default_rng(seed)
    vision = rng.uniform(0.5, 3.0, (h, w))
    touch = np.zeros((h, w))
    touch[10:30, 20:40] = rng.uniform(0.8, 1.2, (20, 20))
    touch_var = np.zeros((h, w))
    touch_var[10:30, 20:40] = rng.uniform(0.01, 0.5, (20, 20))
    grounded = np.zeros((h, w))
    mask = rng.random((h, w)) < 0.05
    grounded[mask] = (1.5 * vision + 0.3)[mask]
    return tuple(a.astype(np.float32) for a in (grounded, touch, vision,
                                               touch_var))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


# --- uncertainty --------------------------------------------------------

@pytest.mark.parametrize("mode", ["symmetric", "reflect", "edge"])
@pytest.mark.parametrize("pad", [1, 2, ((3, 2), (0, 4)),
                                 ((125, 124), (125, 124)), ((9, 0), (7, 11))])
def test_pad_matches_numpy(mode, pad):
    """Pads larger than the 5x7 image too: numpy's reflect repeats."""
    img = np.random.default_rng(1).uniform(size=(5, 7)).astype(np.float32)
    np.testing.assert_array_equal(_np(tun._pad(_t(img), pad, mode)),
                                  np.pad(img, pad, mode=mode))


def test_squared_edt_exact():
    mask = np.random.default_rng(3).random((40, 56)) < 0.03
    np.testing.assert_array_equal(_np(tun.squared_edt(_t(~mask))),
                                  np.asarray(jun.squared_edt(
                                      jnp.asarray(~mask))))


# (weights, atol): the main path's; then all four terms at
# tests/test_fusion.py's weights, where the 250x250 box blur's summed-area
# table accumulates in another fp32 order
UNC_CASES = {
    "main_path": (dict(edge_weight=0.0, distance_uncertainty_weight=0.05,
                       proximity_weight=0.0, depth_difference_weight=0.0,
                       dilation_size=5), 1e-6),
    "all_terms": (dict(edge_weight=2.0, distance_uncertainty_weight=0.1,
                       proximity_weight=0.5, depth_difference_weight=1.0,
                       dilation_size=2), 1e-5),
}


@pytest.mark.parametrize("case", sorted(UNC_CASES))
@pytest.mark.parametrize("seed", [0, 7])
def test_uncertainty_matches_jax(case, seed):
    kw, atol = UNC_CASES[case]
    grounded, _, vision, _ = _maps(seed)
    j = jun.compute_uncertainty_map_with_edges(
        jnp.asarray(vision), jnp.asarray(grounded), **kw)
    t = tun.compute_uncertainty_map_with_edges(_t(vision), _t(grounded),
                                               **kw)
    rtol = 1e-6 if case == "main_path" else 0.0
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=rtol, atol=atol)
    if kw["edge_weight"]:
        # the edge term fired, and on the same pixels
        assert (_np(t) >= kw["edge_weight"]).sum() > 0


# --- fusion -------------------------------------------------------------

# (sparse map, bounds): stage 1's bounded fit to the grounded anchors,
# stage 2's pinned fit to the touch, both clipped, and no mask at all
SCALE_CASES = {
    "bounded": (0, ((0.0, None), (None, None))),
    "pinned": (1, ((1.0, 1.0), (None, None))),
    "clipped": (0, ((0.0, 1.2), (-0.1, 0.1))),
    "empty": (None, ((0.0, None), (None, None))),
}


@pytest.mark.parametrize("case", sorted(SCALE_CASES))
def test_scale_and_offset_matches_jax(case):
    which, bounds = SCALE_CASES[case]
    maps = _maps()
    sparse = np.zeros_like(maps[0]) if which is None else maps[which]
    vision = maps[2]
    js, jo = jfu.compute_scale_and_offset(
        jnp.asarray(sparse), jnp.asarray(vision), *bounds)
    ts, to = tfu.compute_scale_and_offset(_t(sparse), _t(vision), *bounds)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)
    np.testing.assert_allclose(float(to), float(jo), rtol=1e-5)
    if case == "empty":
        assert (float(ts), float(to)) == (1.0, 0.0)


def test_sparse_depth_map_takes_the_permutation():
    _, _, vision, _ = _maps()
    key = jax.random.PRNGKey(4)
    perm = np.asarray(jax.random.permutation(key, vision.size))
    j = jfu.create_sparse_depth_map(key, jnp.asarray(vision), 0.01)
    t = tfu.create_sparse_depth_map(None, _t(vision), 0.01,
                                    perm=torch.tensor(perm))
    np.testing.assert_array_equal(_np(t), np.asarray(j))
    assert (_np(t) > 0).sum() == int(vision.size * 0.01)
    g = torch.Generator().manual_seed(0)
    drawn = _np(tfu.create_sparse_depth_map(g, _t(vision), 0.01))
    assert (drawn > 0).sum() == int(vision.size * 0.01)
    with pytest.raises(ValueError, match="perm"):
        tfu.create_sparse_depth_map(None, _t(vision), perm=torch.arange(5))


@pytest.mark.parametrize("use_uncertainty", [True, False])
@pytest.mark.parametrize("is_real_world", [True, False])
def test_fuse_view_matches_jax(use_uncertainty, is_real_world):
    """JAX's permutation injected.  atol 4e-6, not 1e-6: the 1% mask's 30
    anchors are summed in another fp32 order (Σy one ulp apart), and the
    2x2 solve carries that into scale and offset; measured 3.3e-6 on
    vision_depth (values up to 4.4 m, 14 ulps), 1.9e-6 on the fused and
    DS-GS depths, 4.8e-7 on the fused uncertainty."""
    grounded, touch, vision, touch_var = _maps()
    # denser grounded anchors, so the 1% mask keeps some of them
    grounded = np.where(grounded > 0, grounded, 1.5 * vision + 0.3)
    key = jax.random.PRNGKey(2)
    perm = torch.tensor(np.asarray(jax.random.permutation(key,
                                                             vision.size)))
    j = jfu.fuse_view(key, *(jnp.asarray(a) for a in (grounded, touch,
                                                      vision, touch_var)),
                      use_uncertainty=use_uncertainty,
                      is_real_world=is_real_world)
    t = tfu.fuse_view(None, *(_t(a) for a in (grounded, touch, vision,
                                              touch_var)),
                      use_uncertainty=use_uncertainty,
                      is_real_world=is_real_world, perm=perm)
    for name in tfu.FusedView._fields:
        np.testing.assert_allclose(_np(getattr(t, name)),
                                   np.asarray(getattr(j, name)), atol=4e-6,
                                   rtol=0, err_msg=name)
    assert float(t.fused_depth.min()) >= 0


def test_fusion_guards_match_jax():
    """Zero and infinite σ: the inf→0 and nan→0 guards in their order."""
    rng = np.random.default_rng(5)
    touch = rng.uniform(0.5, 1.5, (8, 8)).astype(np.float32)
    vision = rng.uniform(0.5, 3.0, (8, 8)).astype(np.float32)
    tu = rng.uniform(0.0, 0.3, (8, 8)).astype(np.float32)
    vu = rng.uniform(4.0, 6.0, (8, 8)).astype(np.float32)
    tu[:2] = 0.0
    touch[0, :4] = 0.0
    vu[3, :3] = 0.0
    vu[4, :3] = np.inf
    tu[5, :2] = np.inf
    j = jfu.fuse_depth_maps_with_uncertainty(
        *(jnp.asarray(a) for a in (touch, vision, tu, vu)))
    t = tfu.fuse_depth_maps_with_uncertainty(
        *(_t(a) for a in (touch, vision, tu, vu)))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# --- pointcloud ---------------------------------------------------------

def _views(n=3, h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    depths = rng.uniform(0.5, 2.0, (n, h, w)).astype(np.float32)
    depths[rng.random((n, h, w)) < 0.6] = 0.0
    colors = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    c2ws = np.stack([np.asarray(look_at_camera(
        eye=(1.5 * np.cos(a), 0.4, 1.5 * np.sin(a)), width=w, height=h,
        focal=30.0).c2w) for a in np.linspace(0, 2, n)])
    return depths, colors, c2ws, (30.0, 31.0, w / 2 + 0.3, h / 2 - 0.2)


def test_backproject_matches_jax():
    depths, colors, c2ws, intr = _views()
    j = jpc.backproject_depth(jnp.asarray(depths[1]), jnp.asarray(colors[1]),
                              intr, jnp.asarray(c2ws[1]))
    t = tpc.backproject_depth(_t(depths[1]), _t(colors[1]), intr,
                              _t(c2ws[1]))
    np.testing.assert_allclose(_np(t[0]), np.asarray(j[0]), atol=1e-6)
    np.testing.assert_array_equal(_np(t[1]), np.asarray(j[1]))
    np.testing.assert_array_equal(_np(t[2]), np.asarray(j[2]))


@pytest.mark.parametrize("percent_take", [100.0, 5.0])
def test_seed_point_cloud_matches_jax(percent_take):
    depths, colors, c2ws, intr = _views()
    views = np.array([0, 2])
    jp, jc = jpc.seed_point_cloud(depths, colors, intr, c2ws, views,
                                  percent_take=percent_take, seed=3)
    tp, tc = tpc.seed_point_cloud(depths, colors, intr, c2ws, views,
                                  percent_take=percent_take, seed=3,
                                  device="cpu")
    assert tp.shape == jp.shape and len(tp) > 10
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    np.testing.assert_array_equal(tc, jc)   # the same points selected


def test_save_point_cloud(tmp_path):
    pts = np.ones((4, 3), np.float32)
    tpc.save_point_cloud(tmp_path, pts, 255 * pts)
    np.testing.assert_array_equal(np.load(tmp_path / "points_touch.npy"), pts)


# --- GPIS ---------------------------------------------------------------

def _contacts(n=100, seed=0):
    """Contact points in a few patches on a 0.3 m sphere, outward normals."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 3))
    centers[:, 2] = np.abs(centers[:, 2]) + 0.5   # facing the camera
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    v = centers[rng.integers(0, 4, n)] + 0.25 * rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (0.3 * v).astype(np.float32), v.astype(np.float32)


def _carry(j: jgp.GPIS) -> tgp.GPIS:
    return tgp.gpis_from_numpy(
        j.X, j.alpha, j.L, j.lengthscale, j.signal_var, j.noise,
        kernel=j.kernel, off_eps=j.off_eps, device="cpu")


def _camera(eye=(0.1, 0.15, 1.2), w=40, h=32, focal=45.0):
    jc = look_at_camera(eye=eye, width=w, height=h, focal=focal)
    tc = Camera(**{f.name: (getattr(jc, f.name) if f.name in
                            ("width", "height") else _t(getattr(jc, f.name)))
                   for f in dataclasses.fields(Camera)})
    return jc, tc


GP_KW = dict(lengthscale=0.12, noise=1e-3, off_surface_eps=0.05)
MARCH_KW = dict(near=0.5, far=1.5, n_samples=48, support_var_frac=0.5)


@pytest.fixture(scope="module", params=["rbf", "matern52"])
def fitted(request):
    pts, normals = _contacts()
    j = jgp.fit_gpis(pts, normals, kernel=request.param, **GP_KW)
    t = tgp.fit_gpis(pts, normals, kernel=request.param, device="cpu",
                     **GP_KW)
    return j, t


def test_linspace_within_two_ulps_of_jnp():
    """The march's samples: ``torch.linspace`` against ``jnp.linspace``
    (XLA turns its division into a product with the reciprocal)."""
    for a, b, n in [(0.35, 3.1, 96), (0.05, 2.0, 128), (1.234, 2.987, 64)]:
        t = _np(torch.linspace(a, b, n))
        j = np.asarray(jnp.linspace(jnp.float32(a), jnp.float32(b), n))
        assert t[0] == j[0] and t[-1] == j[-1]
        np.testing.assert_array_max_ulp(t, j, maxulp=2)


def test_carried_posterior_matches_jax(fitted):
    """The mean within 1e-6 (measured 2.3e-7); the variance within 1e-5,
    not 1e-6: sv − Σv² takes v from each package's own fp32 triangular
    solve of a factor whose square has a condition number of 7e5
    (measured 4.2e-6 RBF, 1.8e-6 Matérn)."""
    j, _ = fitted
    t = _carry(j)
    q = np.random.default_rng(9).uniform(-0.5, 0.5, (300, 3)).astype(
        np.float32)
    jm, jv = jgp.posterior(j, jnp.asarray(q))
    tm, tv = tgp.posterior(t, _t(q))
    np.testing.assert_allclose(_np(tm), np.asarray(jm), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tgp.posterior_mean(t, _t(q))),
                               np.asarray(jm), atol=1e-6, rtol=0)


def test_carried_render_matches_jax(fitted):
    """Depth within 1e-5 where both are valid (measured 2.3e-6), the same
    valid pixels.  The depth variance is var_x / slope², and var_x = sv −
    Σv² is a few 1e-5 near the contacts, where the two packages' solves
    (4.2e-6 apart, above) move it by percents: rtol 2e-2 (measured 1.7e-2
    RBF, 1.8e-3 Matérn)."""
    j, _ = fitted
    t = _carry(j)
    jc, tc = _camera()
    jd, jv = jgp.render_depth_var(j, jc, pixel_chunk=256, **MARCH_KW)
    td, tv = tgp.render_depth_var(t, tc, pixel_chunk=256, **MARCH_KW)
    jd, jv, td, tv = np.asarray(jd), np.asarray(jv), _np(td), _np(tv)
    valid = ~np.isnan(jd)
    assert valid.sum() > 50      # the patches face the camera
    np.testing.assert_array_equal(~np.isnan(td), valid)
    np.testing.assert_allclose(td[valid], jd[valid], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv[valid], jv[valid], rtol=2e-2, atol=0)


def test_march_independent_of_chunk(fitted):
    """The chunk sets the memory, not the surface: the same valid pixels,
    depth within 2e-6 (measured 1.1e-6: the matvec's rounding follows
    its row count); the variance within rtol 1e-2, since the triangular
    solve's blocking follows its column count (measured 7.5e-3 at 7
    columns, RBF)."""
    _, t = fitted
    _, tc = _camera(w=24, h=20)
    rd, rv = (_np(a) for a in tgp.render_depth_var(t, tc, pixel_chunk=480,
                                                    **MARCH_KW))
    valid = ~np.isnan(rd)
    assert valid.sum() > 20
    for chunk in (7, 128, 1000):
        d, v = (_np(a) for a in tgp.render_depth_var(
            t, tc, pixel_chunk=chunk, **MARCH_KW))
        np.testing.assert_array_equal(~np.isnan(d), valid)
        np.testing.assert_allclose(d[valid], rd[valid], atol=2e-6, rtol=0)
        np.testing.assert_allclose(v[valid], rv[valid], rtol=1e-2, atol=0)


def test_independent_fits_agree(fitted):
    """Each package fits its own GP: posterior mean within 2e-4 and
    variance within 1e-3; the march's validity flips on at most 1% of
    pixels."""
    j, t = fitted
    q = np.random.default_rng(10).uniform(-0.5, 0.5, (400, 3)).astype(
        np.float32)
    jm, jv = jgp.posterior(j, jnp.asarray(q))
    tm, tv = tgp.posterior(t, _t(q))
    np.testing.assert_allclose(_np(tm), np.asarray(jm), atol=2e-4, rtol=0)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=1e-3, rtol=0)
    jc, tc = _camera()
    jd, _ = jgp.render_depth_var(j, jc, pixel_chunk=512, **MARCH_KW)
    td, _ = tgp.render_depth_var(t, tc, pixel_chunk=512, **MARCH_KW)
    flips = (np.isnan(np.asarray(jd)) != np.isnan(_np(td))).mean()
    assert flips <= 0.01


def test_independent_fits_at_hard_scene_shape():
    """The hard scene's GP shape (512 contacts on the 0.5 m sphere, 1536
    points, lengthscale 0.18, ε 0.05; a Gram matrix of condition number
    about 2e6), fitted in each package: over 4096 queries the posterior
    mean within 2e-4 and the variance within 1e-3 (ROADMAP.md C14)."""
    v = np.random.default_rng(3).normal(size=(512, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts, normals = (0.5 * v).astype(np.float32), v.astype(np.float32)
    kw = dict(lengthscale=0.18, off_surface_eps=0.05)
    j = jgp.fit_gpis(pts, normals, **kw)
    t = tgp.fit_gpis(pts, normals, device="cpu", **kw)
    q = np.random.default_rng(4).uniform(-0.7, 0.7, (4096, 3)).astype(
        np.float32)
    jm, jv = jgp.posterior(j, jnp.asarray(q))
    tm, tv = tgp.posterior(t, _t(q))
    errs = [float(np.abs(_np(tm) - np.asarray(jm)).max()),
            float(np.abs(_np(tv) - np.asarray(jv)).max()),
            float(np.abs(_np(t.L) - np.asarray(j.L)).max())]
    print(f"independent fits: mean {errs[0]:.2e}, variance {errs[1]:.2e}, "
          f"factor {errs[2]:.2e}")
    assert errs[0] <= 2e-4 and errs[1] <= 1e-3


def test_fit_subsamples_and_estimates_normals():
    """Above ``max_points`` both packages keep the same contacts; without
    normals both estimate them with the same numpy code."""
    pts, _ = _contacts(n=300, seed=2)
    j = jgp.fit_gpis(pts, None, max_points=80, orient_to=np.zeros(3),
                     seed=5, **GP_KW)
    t = tgp.fit_gpis(pts, None, max_points=80, orient_to=np.zeros(3),
                     seed=5, device="cpu", **GP_KW)
    assert t.num_points == j.num_points == 240
    np.testing.assert_array_equal(_np(t.X), np.asarray(j.X))
    assert t.kernel == "rbf" and float(t.off_eps) == np.float32(0.05)


# --- calibration --------------------------------------------------------

def _radii_angles(seed=0):
    rng = np.random.default_rng(seed)
    r = rng.uniform(5, 120, 60)
    return r, 0.011 * r + 0.02 * np.sin(r / 17.0)


def test_calibration_carried_matches_jax():
    """atol 1e-4 on the mean, not 1e-6: 60 radii on one axis make alphas
    up to 97 that cancel in the 60-term dot, which each package sums in
    its own fp32 order (measured 2.6e-5 on the mean, 3.2e-5 on the
    table); the variance within 1e-5 (measured 2.6e-6)."""
    r, a = _radii_angles()
    j = jcal.fit_radius_angle_gp(r, a)
    t = tcal.radius_angle_gp_from_numpy(j.x, j.alpha, j.L, j.lengthscale,
                                        j.signal_var, j.x_scale,
                                        device="cpu")
    q = np.linspace(0, 130, 77).reshape(7, 11)
    jm, jv = j.predict(q)
    tm, tv = t.predict(q)
    assert tm.shape == (7, 11)
    np.testing.assert_allclose(_np(tm), np.asarray(jm), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tcal.build_lookup_table(t, 127),
                               jcal.build_lookup_table(j, 127), atol=1e-4,
                               rtol=0)
    lut = tcal.build_lookup_table(t, 127)
    np.testing.assert_array_equal(tcal.rectification_indices(lut, 64),
                                  jcal.rectification_indices(lut, 64))


def test_calibration_fit_matches_jax():
    """Each package fits its own 1-D GP: a well-conditioned Gram matrix,
    so the fits agree closely."""
    r, a = _radii_angles(1)
    j = jcal.fit_radius_angle_gp(r, a)
    t = tcal.fit_radius_angle_gp(r, a, device="cpu")
    np.testing.assert_array_equal(_np(t.x), np.asarray(j.x))
    np.testing.assert_allclose(tcal.build_lookup_table(t, 127),
                               jcal.build_lookup_table(j, 127), atol=1e-4,
                               rtol=0)


def test_calibrate_sensor_matches_jax():
    """Line detection (OpenCV) on a synthetic radial target, the same
    segments, then each package's own fit: the segments' endpoints repeat
    radii, so the Gram matrix is near-singular and the two fp32 fits'
    tables differ by up to 5.1e-4 rad (measured): atol 1e-3."""
    pytest.importorskip("cv2")
    img = np.zeros((128, 128), np.uint8)
    for k in range(8):
        ang = k * np.pi / 8
        for rr in np.linspace(10, 59, 200):
            x = int(round(64 + rr * np.cos(ang)))
            y = int(round(64 + rr * np.sin(ang)))
            img[y, x] = 255
            img[y, min(x + 1, 127)] = 255
    np.testing.assert_array_equal(tcal.detect_radial_lines(img),
                                  jcal.detect_radial_lines(img))

    def angles(radii):
        return 0.012 * radii

    j = jcal.calibrate_sensor(img, angles)
    t = tcal.calibrate_sensor(img, angles, device="cpu")
    np.testing.assert_allclose(tcal.build_lookup_table(t, 64),
                               jcal.build_lookup_table(j, 64), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("entry", ["fit_gpis", "seed_point_cloud",
                                   "fit_radius_angle_gp"])
def test_entry_points_want_cuda_by_default(entry):
    """The touch entry points that take numpy run on the card unless the
    caller asks for the CPU; without a GPU the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    pts, normals = _contacts(n=20)
    depths, colors, c2ws, intr = _views(n=1)
    call = {
        "fit_gpis": lambda: tgp.fit_gpis(pts, normals, **GP_KW),
        "seed_point_cloud": lambda: tpc.seed_point_cloud(
            depths, colors, intr, c2ws, np.array([0])),
        "fit_radius_angle_gp": lambda: tcal.fit_radius_angle_gp(
            *_radii_angles()),
    }[entry]
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|NVIDIA"):
        call()
