"""The port's hard-scene slice (``touchgs_torch/tools/train_hard_scene.py``
and the touch modules it drives) against the JAX package's pipeline, on the
CPU, on one tiny scene: 4 views at 48x48, 6 contact patches, a GPIS of at
most 64 contacts.

The GT renders and the synthetic sensors are made once by the port's tool
and are the shared input.  Then stage by stage, each package takes the same
inputs, as the JAX tool chains them (``tools/train_hard_scene.py:355-515``):
the GPIS (JAX's fit carried across), ``render_depth_var`` a view,
``fuse_view`` with JAX's permutations injected, ``seed_point_cloud``, then
three ``Trainer`` steps of each arm from the JAX trainer's state, at SH
degree 0 and 2, on the scan path.  Last, ``main`` end to end on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
from touchgs_tpu.data.cameras import Cameras as JCameras
from touchgs_tpu.data.scene import Scene as JScene
from touchgs_tpu.touch import fusion as jfu
from touchgs_tpu.touch import gpis as jgp
from touchgs_tpu.touch import pointcloud as jpc
from touchgs_tpu.train import trainer as jtr
from touchgs_torch.touch import gpis as tgp
from touchgs_torch.tools import exp_gpis_precision as egp
from touchgs_torch.tools import train_hard_scene as ths
from touchgs_torch.train import trainer as ttr
from tools import train_scale_demo as jdemo

VIEWS, SIZE, PATCHES, MAX_POINTS = 4, 48, 6, 64
PATCH_RADIUS = 0.09
CAP, STEPS = 1024, 3
# the arms' steps start from every 10th seed: all of them (every valid
# pixel, 3,000 here) put more than k_tile 512 entries in each of the 4
# tiles, and which of a quantised-depth tie the scan path then keeps
# follows each package's sort (ROADMAP.md C3): the first step's loss
# differs by 0.12%.  A tenth keeps every tile under k_tile
SEED_STRIDE = 10
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one intra-op thread for this module (restored after it).
    With several, the GT render's torch.exp of the log-scales came out of
    one worker thread's chunk 4.8e-6 off (about 80 ulps) in some fresh
    processes, and the GPIS magnified that past
    test_fused_maps_match_jax's atol (ROADMAP.md C18).  One thread is also
    the faster choice when the suite runs several workers on the same
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    gt = ths.render_gt(VIEWS, SIZE, CPU, use_pallas=False)
    sensors = ths.synth_sensors(gt, PATCHES, PATCH_RADIUS, CPU)
    assert len(sensors["contacts"]) > 10
    return gt, sensors


@pytest.fixture(scope="module")
def gpis_pair(inputs):
    """JAX's fit as the JAX tool makes it, and the port's copy of it."""
    _, sensors = inputs
    c = sensors["contacts"]
    j = jgp.fit_gpis(c, normals=c / np.linalg.norm(c, axis=1, keepdims=True),
                     lengthscale=2.0 * PATCH_RADIUS, off_surface_eps=0.05,
                     max_points=MAX_POINTS, seed=0)
    t = tgp.gpis_from_numpy(j.X, j.alpha, j.L, j.lengthscale, j.signal_var,
                            j.noise, kernel=j.kernel, off_eps=j.off_eps,
                            device="cpu")
    return j, t


def _jax_touch_maps(g, cams, near, far):
    """The JAX tool's march a view (``tools/train_hard_scene.py:385-401``)."""
    touch, sig = [], []
    for cam in cams:
        dep, var = jgp.render_depth_var(g, cam, near=near, far=far,
                                        n_samples=96, pixel_chunk=1024,
                                        support_var_frac=0.15)
        dep = np.nan_to_num(np.asarray(dep), nan=0.0)
        var = np.nan_to_num(np.asarray(var), nan=0.0)
        touch.append(np.where(dep > 0, dep, 0.0))
        sig.append(np.where(dep > 0, np.maximum(var, 1e-4), 0.0))
    return np.stack(touch), np.stack(sig)


@pytest.fixture(scope="module")
def touch_pair(inputs, gpis_pair):
    gt, sensors = inputs
    j, t = gpis_pair
    near, far = ths.march_range(gt["depths"], sensors["sphere_masks"])
    jmaps = _jax_touch_maps(j, jdemo.ring_cameras(VIEWS, SIZE, SIZE), near,
                            far)
    return jmaps, ths.touch_maps(t, gt["cams"], near, far)


@pytest.fixture(scope="module")
def fused_pair(inputs, touch_pair):
    """Both fusions on JAX's touch maps, the port with JAX's per-view
    permutations (``jax.random.split`` of PRNGKey(0), as the JAX tool)."""
    _, sensors = inputs
    (touch, sig), _ = touch_pair
    key = jax.random.PRNGKey(0)
    jout, perms = [], []
    for v in range(VIEWS):
        key, sub = jax.random.split(key)
        perms.append(torch.tensor(np.asarray(
            jax.random.permutation(sub, SIZE * SIZE))))
        fv = jfu.fuse_view(sub, *(jnp.asarray(a[v], jnp.float32) for a in (
            sensors["grounded"], touch, sensors["vision"], sig)),
            use_uncertainty=True, is_real_world=True)
        jout.append([np.asarray(fv.fused_depth),
                     np.asarray(fv.fused_uncertainty),
                     np.asarray(fv.ds_gs_depth)])
    jout = tuple(np.stack(a) for a in zip(*jout))
    tout = ths.fuse_views(sensors["grounded"], touch, sensors["vision"], sig,
                          CPU, perms=perms)
    return jout, tout


def _jax_sensors(gt, touch_patches, patch_radius):
    """The JAX tool's synthetic sensors (``tools/train_hard_scene.py:
    128-164``) on the shared GT renders: one numpy stream (seed 3), the
    contacts backprojected by the JAX package with the JAX tool's
    cameras."""
    rng = np.random.default_rng(3)
    cvec = rng.normal(size=(touch_patches, 3))
    cvec /= np.linalg.norm(cvec, axis=1, keepdims=True)
    centers = cvec * 0.5
    cams = jdemo.ring_cameras(VIEWS, SIZE, SIZE)
    intr = (float(cams[0].fx), float(cams[0].fy), float(cams[0].cx),
            float(cams[0].cy))
    out = {k: [] for k in ("vision", "grounded", "sphere_masks",
                           "in_patches", "contacts")}
    for v, cam in enumerate(cams):
        gt_d, pl_d = gt["depths"][v], gt["plane_depths"][v]
        sph = (gt_d > 0) & (pl_d - gt_d > 1e-3)
        vis = np.where(sph, pl_d, gt_d)
        vis = vis / 0.97 - 0.02 + rng.normal(0, 0.01, gt_d.shape)
        vis = np.where(gt_d > 0, np.maximum(vis, 0.0), 0.0)
        pts, _, _ = jpc.backproject_depth(
            jnp.asarray(gt_d), jnp.asarray(gt["images"][v]), intr,
            jnp.asarray(np.asarray(cam.c2w)))
        pts = np.asarray(pts).reshape(SIZE, SIZE, 3)
        d2 = ((pts[None] - centers[:, None, None, :]) ** 2).sum(-1)
        in_patch = (d2.min(axis=0) < patch_radius ** 2) & sph
        gnd = np.where(gt_d > 0, gt_d + rng.normal(0, 0.01, gt_d.shape), 0.0)
        for k, a in zip(out, (vis, gnd, sph, in_patch, pts[in_patch])):
            out[k].append(a)
    return {k: (np.concatenate(a) if k == "contacts" else np.stack(a))
            for k, a in out.items()}


def test_sensors_match_jax(inputs):
    """The port's ``synth_sensors`` against the JAX tool's sensor loop on
    the same GT renders: the vision and grounded maps, the sphere and
    patch masks equal (the same numpy stream drawn in the same order), the
    contacts within 1e-6 m (each package backprojects in fp32)."""
    gt, sensors = inputs
    ref = _jax_sensors(gt, PATCHES, PATCH_RADIUS)
    for k in ("vision", "grounded", "sphere_masks", "in_patches"):
        np.testing.assert_array_equal(sensors[k], ref[k], err_msg=k)
    assert sensors["in_patches"].any() and sensors["sphere_masks"].any()
    assert sensors["contacts"].shape == ref["contacts"].shape
    np.testing.assert_allclose(sensors["contacts"], ref["contacts"],
                               rtol=0, atol=1e-6)


def test_port_fit_keeps_jax_contacts(inputs, gpis_pair):
    """The port's own fit keeps the same contacts, with the same normals,
    as JAX's (``tests/test_torch_touch.py`` checks the subsampling)."""
    _, sensors = inputs
    j, _ = gpis_pair
    t = ths.fit_touch_gpis(sensors["contacts"], PATCH_RADIUS, MAX_POINTS,
                           CPU)
    assert t.num_points == 3 * min(len(sensors["contacts"]), MAX_POINTS)
    np.testing.assert_allclose(t.X.numpy(), np.asarray(j.X), atol=1e-7)
    np.testing.assert_array_equal(t.alpha.shape, np.asarray(j.alpha).shape)


def test_touch_maps_match_jax(inputs, touch_pair):
    """JAX's GPIS carried across: the same valid pixels; σ within the
    variance's rtol of ``tests/test_torch_touch.py::
    test_carried_render_matches_jax``.  Depth within 2e-4 where both are
    valid, not 1e-5: the scene's 28 contacts make alphas up to 69 that
    cancel in the 84-term matvec, which each package sums in its own fp32
    order (3.1e-5 apart in the mean), and the shallow crossings at the
    support's fringe carry that into depth (measured 1.35e-4 on 222
    pixels; the samples' 2-ulp linspace difference adds nothing)."""
    gt, sensors = inputs
    (jt, js), (tt, ts) = touch_pair
    valid = jt > 0
    assert valid[sensors["sphere_masks"]].mean() > 0.05
    np.testing.assert_array_equal(tt > 0, valid)
    np.testing.assert_allclose(tt[valid], jt[valid], atol=2e-4, rtol=0)
    np.testing.assert_allclose(ts[valid], js[valid], rtol=5e-2, atol=0)


def test_fused_maps_match_jax(fused_pair):
    jout, tout = fused_pair
    for name, a, b in zip(("fused depth", "fused uncertainty", "DS-GS depth"),
                          tout, jout):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)


def _jax_seeds(dsgs_d, touch, images, intr, c2ws, i_train):
    """The JAX tool's seeding (``tools/train_hard_scene.py:431-442``), with
    the port's cap of the scene seeds' percentage at 100."""
    pt_b = min(100.0, 100.0 * ths.SCENE_SEEDS
               / max((dsgs_d[i_train] > 0).sum(), 1))
    sb, cb = jpc.seed_point_cloud(dsgs_d, images, intr, c2ws, i_train,
                                  percent_take=pt_b, seed=0)
    tp, tc = jpc.seed_point_cloud(touch, images, intr, c2ws, i_train,
                                  percent_take=ths.TOUCH_SEED_PERCENT, seed=0)
    return dict(seeds_a=np.concatenate([sb, tp]),
                cols_a=np.concatenate([cb, tc]), seeds_b=sb, cols_b=cb)


@pytest.fixture(scope="module")
def seeds_pair(inputs, touch_pair, fused_pair):
    gt, _ = inputs
    (touch, _), _ = touch_pair
    jout, _ = fused_pair
    i_train, _ = ths.splits(VIEWS)
    c2ws = np.stack([c.c2w.numpy() for c in gt["cams"]])
    intr = ths.intrinsics(gt["cams"])
    args = (jout[2], touch, gt["images"], intr, c2ws, i_train)
    return _jax_seeds(*args), ths.arm_seeds(*args, CPU), c2ws, intr


def test_seeds_match_jax(seeds_pair):
    j, t, _, _ = seeds_pair
    assert t["n_touch"] > 0
    for k in ("seeds_a", "seeds_b"):
        assert t[k].shape == j[k].shape
        np.testing.assert_allclose(t[k], j[k], atol=1e-6, err_msg=k)
    for k in ("cols_a", "cols_b"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)   # same picks


def _jax_arm_config(tag, sh_degree):
    """The JAX tool's ``TrainConfig`` (``tools/train_hard_scene.py:458-475,
    507-515``) on the scan path."""
    depth = {
        "touchgs": jcfg.DepthLossConfig(
            0.2, jcfg.DepthLossType.DEPTH_UNCERTAINTY_WEIGHTED_LOSS, 1.0,
            uncertainty_form="inv_sq"),
        "vision_only": jcfg.DepthLossConfig(
            0.2, jcfg.DepthLossType.SIMPLE_LOSS, 0.0),
    }[tag]
    return jcfg.TrainConfig(
        max_steps=STEPS,
        model=jcfg.ModelConfig(max_gaussians=CAP, sh_degree=sh_degree,
                               rasterize=jcfg.RasterizeConfig(
                                   use_pallas=False)),
        depth=depth,
        densify=jcfg.DensifyConfig(warmup_steps=300, refine_every=100,
                                   stop_refine_at=STEPS - 300,
                                   reset_opacity_every=3000),
        optim=jcfg.OptimConfig(means_lr_max_steps=STEPS),
        sh_degree_interval=max(STEPS // 3, 1),
        grow_capacity=False, log_every=1)


def _plain(tree):
    """A config's ``asdict`` with each package's enums as their values."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return getattr(tree, "value", tree)


def _leaves(state) -> dict:
    opt = state.opt_state
    return {
        "params": {f.name: np.asarray(getattr(state.params, f.name))
                   for f in dataclasses.fields(state.params)},
        "count": int(opt.count),
        "mu": {k: np.asarray(v) for k, v in opt.mu.items()},
        "nu": {k: np.asarray(v) for k, v in opt.nu.items()},
        "densify": {f.name: np.asarray(getattr(state.densify, f.name))
                    for f in dataclasses.fields(state.densify)},
        "step": int(state.step),
    }


@pytest.mark.parametrize("sh_degree", [0, 2])
@pytest.mark.parametrize("tag", ["touchgs", "vision_only"])
def test_arm_steps_match_jax(inputs, fused_pair, seeds_pair, tag, sh_degree):
    """Three ``Trainer.run`` steps of the arm in both packages from the JAX
    trainer's state: per-step loss and PSNR within rtol 1e-3, as
    ``tests/test_torch_train.py``.  The arm's scene and config are the
    port tool's, checked equal to the JAX tool's."""
    gt, _ = inputs
    jout, _ = fused_pair
    j, t, c2ws, intr = seeds_pair
    fused_d, fused_u, dsgs_d = jout
    i_train, i_eval = ths.splits(VIEWS)
    n_b = len(t["seeds_b"])          # arm A's seeds: arm B's, then touch's
    if tag == "touchgs":
        maps = (fused_d, fused_u)
        keep = np.r_[np.arange(0, n_b, SEED_STRIDE),
                     np.arange(n_b, len(t["seeds_a"]))]
        pts, cols = t["seeds_a"][keep], t["cols_a"][keep]
    else:
        maps = (dsgs_d, np.zeros_like(fused_u))
        pts = t["seeds_b"][::SEED_STRIDE]
        cols = t["cols_b"][::SEED_STRIDE]
    cam_kw = dict(fx=np.full(VIEWS, intr[0], np.float32),
                  fy=np.full(VIEWS, intr[1], np.float32),
                  cx=np.full(VIEWS, intr[2], np.float32),
                  cy=np.full(VIEWS, intr[3], np.float32), c2w=c2ws,
                  width=SIZE, height=SIZE)
    tcam = ths.Cameras(**cam_kw)
    tscene = ths.arm_scene(tcam, gt["images"], *maps, pts, cols, i_train,
                           i_eval, tag)
    jscene = JScene(cameras=JCameras(**cam_kw), images=gt["images"],
                    depths=maps[0], uncertainties=maps[1], i_train=i_train,
                    i_eval=i_eval, seed_points=pts, seed_colors=cols / 255.0,
                    scale_factor=1.0, transform=np.eye(4)[:3],
                    name=f"hard_{tag}")
    tc = dataclasses.replace(
        ths.arm_config(STEPS, CAP, sh_degree, ths.arm_losses("inv_sq")[tag],
                       use_pallas=False), log_every=1)
    jc = _jax_arm_config(tag, sh_degree)
    assert _plain(dataclasses.asdict(tc)) == _plain(dataclasses.asdict(jc))

    jt = jtr.Trainer(jscene, jc)
    tt = ttr.Trainer(tscene, tc, device="cpu")
    tt.state = ttr.state_from_numpy(_leaves(jt.state), "cpu")
    assert tuple(tt.state.params.sh_rest.shape) == (
        CAP, (sh_degree + 1) ** 2 - 1, 3)
    jlog, tlog = [], []
    jt.run(STEPS, log_fn=jlog.append)
    tt.run(STEPS, log_fn=tlog.append)
    assert len(tlog) == len(jlog) == STEPS
    for key in ("loss", "psnr", "depth_loss"):
        np.testing.assert_allclose([m[key] for m in tlog],
                                   [m[key] for m in jlog], rtol=1e-3,
                                   err_msg=key)


def test_main_end_to_end_on_cpu(tmp_path, monkeypatch):
    """``main`` at 48x48 with 4 views, 6 patches and 2 steps on the scan
    path: both arms' rows finite, the stage times present, the markdown at
    ``--out`` and nothing else written, the caller's TF32 flags kept."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "hs.md"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        s = ths.main(["--device", "cpu", "--views", str(VIEWS), "--size",
                      str(SIZE), "--touch-patches", str(PATCHES), "--steps",
                      "2", "--gpis-max-points", str(MAX_POINTS),
                      "--capacity", str(CAP), "--out", str(out)])
        # TF32 was off inside, and the caller's flags come back
        assert (torch.backends.cuda.matmul.allow_tf32
                and torch.backends.cudnn.allow_tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert s["device"] == "cpu" and s["rasterizer"] == "scan path"
    assert 0 < s["touch_coverage"] <= 1 and s["contacts"] > 10
    for tag in ("touchgs", "vision_only"):
        row = s["arms"][tag]
        for k in ("eval_psnr", "depth_mae_cm", "object_depth_mae_cm",
                  "iters_per_sec"):
            assert np.isfinite(row[k]), (tag, k)
        assert 0 < row["alive"] <= CAP
    assert set(s["stages"]) == {
        "gt_render_s", "gpis_fit_s", "march_s_per_view", "fusion_s_per_view",
        "seeding_s", "touchgs_iters_per_sec", "vision_only_iters_per_sec"}
    assert s["arms"]["touchgs"]["seeds"] > s["arms"]["vision_only"]["seeds"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["hs.md"]


def test_main_wants_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ths.main(["--steps", "1"])


def test_bf16_matvec_rounds_only_inside(gpis_pair):
    """``exp_gpis_precision.matvec("bf16")``: inside the block the GPIS's
    ``k @ alpha`` takes both inputs rounded to bf16, as a TPU's default
    matmul precision does, in ``posterior_mean`` and ``posterior``; the
    variance stays fp32; outside, the fp32 functions are back."""
    _, t = gpis_pair
    q = torch.as_tensor(np.random.default_rng(2).uniform(
        -0.6, 0.6, (256, 3)).astype(np.float32))
    k = tgp._rbf(tgp._sq_dist(q, t.X), t.lengthscale, t.signal_var)
    ref = k.bfloat16().float() @ t.alpha.bfloat16().float()
    mean32 = tgp.posterior_mean(t, q)
    _, var32 = tgp.posterior(t, q)
    assert not torch.equal(mean32, ref)
    with egp.matvec("bf16"):
        assert torch.equal(tgp.posterior_mean(t, q), ref)
        m, v = tgp.posterior(t, q)
        assert torch.equal(m, ref) and torch.equal(v, var32)
    with egp.matvec("fp32"):
        assert torch.equal(tgp.posterior_mean(t, q), mean32)
    assert torch.equal(tgp.posterior_mean(t, q), mean32)


def test_precision_tool_maps_on_cpu():
    """``exp_gpis_precision.main --maps-only`` on 2 views at 48x48: both
    modes' touch maps cover part of the sphere with a finite error, and
    nothing is trained."""
    out = egp.main(["--maps-only", "--", "--device", "cpu", "--views", "2",
                    "--size", str(SIZE), "--touch-patches", str(PATCHES),
                    "--gpis-max-points", str(MAX_POINTS)])
    m = out["touch_maps"]
    for mode in ("fp32", "bf16"):
        assert 0 < m[mode]["coverage"] <= 1 and np.isfinite(
            m[mode]["mae_cm"]), (mode, m[mode])
    assert m["depth_diff_cm"]["max"] > 0 and "run" not in out


def test_precision_tool_wants_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        egp.main(["--maps-only"])
