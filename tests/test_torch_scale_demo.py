"""The port's scale demo (``touchgs_torch/tools/train_scale_demo.py``)
against the JAX demo (``tools/train_scale_demo.py``) on the CPU: the same
GT scene, the same cameras, one GT view through both packages' scan path,
and ``main`` end to end at 64x48.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.models.gaussians import GaussianParams as JParams
from touchgs_tpu.models.splatfacto import render as j_render
from touchgs_tpu.ops.sh import rgb_to_sh_dc as j_rgb_to_sh_dc
from touchgs_torch.models.gaussians import GaussianParams as TParams
from touchgs_torch.models.splatfacto import render as t_render
from touchgs_torch.tools import train_scale_demo as tdemo
from tools import train_scale_demo as jdemo

from tests.synthetic import look_at_camera as j_look_at

W, H = 64, 48


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


def test_build_gt_gaussians_bit_equal():
    t = tdemo.build_gt_gaussians()
    j = jdemo.build_gt_gaussians()
    assert len(t) == len(j) == 5 and t[0].shape == (100_000, 3)
    for a, b in zip(t, j):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("eye", [(2.2, 0.0, 0.8), (0.3, -1.1, 1.7),
                                 (0.0, 2.5, 0.0)])  # the last looks along up
def test_look_at_camera_matches(eye):
    t = tdemo.look_at_camera(eye=eye, target=(0, 0, -0.1), width=W,
                             height=H, focal=57.6, device="cpu")
    j = j_look_at(eye=eye, target=(0, 0, -0.1), width=W, height=H,
                  focal=57.6)
    np.testing.assert_array_equal(t.c2w.numpy(), np.asarray(j.c2w))
    for k in ("fx", "fy", "cx", "cy"):
        assert float(getattr(t, k)) == float(getattr(j, k))
    np.testing.assert_allclose(t.w2c.numpy(), np.asarray(j.w2c), atol=1e-6)


def test_gt_view_matches_jax_scan_path():
    """One GT view (500 of the scene's Gaussians, at the GT raster config)
    through both packages' scan path."""
    means, quats, scales, colors, opac = tdemo.build_gt_gaussians(300, 200)
    G = means.shape[0]
    logit = np.log(opac / (1 - opac))
    j_gt = JParams(
        means=jnp.asarray(means), quats=jnp.asarray(quats),
        log_scales=jnp.log(jnp.asarray(scales)),
        logit_opacities=jnp.asarray(logit),
        sh_dc=j_rgb_to_sh_dc(jnp.asarray(colors)),
        sh_rest=jnp.zeros((G, 3, 3)), alive=jnp.ones((G,), bool))
    t_gt = TParams(
        means=torch.tensor(means), quats=torch.tensor(quats),
        log_scales=torch.log(torch.tensor(scales)),
        logit_opacities=torch.tensor(logit),
        sh_dc=torch.tensor(np.asarray(j_gt.sh_dc)),
        sh_rest=torch.zeros((G, 3, 3)),
        alive=torch.ones((G,), dtype=torch.bool))
    j_cfg = jcfg.ModelConfig(max_gaussians=G, sh_degree=1,
                             rasterize=jdemo.lossless_gt_raster(False))
    t_cfg = tcfg.ModelConfig(max_gaussians=G, sh_degree=1,
                             rasterize=tdemo.lossless_gt_raster(False))
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    jcam = jdemo.ring_cameras(4, W, H)[1]
    tcam = tdemo.ring_cameras(4, W, H, device="cpu")[1]
    jout = j_render(j_gt, jcam, j_cfg, active_sh_degree=1)[0]
    with torch.no_grad():
        tout = t_render(t_gt, tcam, t_cfg, active_sh_degree=1)[0]
    assert tout.lossy_tiles is None and jout.lossy_tiles is None
    assert float(np.asarray(jout.acc).max()) > 0.5
    np.testing.assert_allclose(tout.rgb.numpy(), np.asarray(jout.rgb),
                               atol=2e-5)
    np.testing.assert_allclose(tout.acc.numpy(), np.asarray(jout.acc),
                               atol=2e-5)
    np.testing.assert_allclose(tout.depth.numpy(), np.asarray(jout.depth),
                               atol=2e-4)


def test_main_end_to_end_on_cpu(tmp_path, monkeypatch):
    """``main`` at 64x48 with 4 views and 30 steps on the scan path:
    finite metrics, and its markdown and renders under ``--render-dir``,
    never in the working directory."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "demo"
    s = tdemo.main(["--width", str(W), "--height", str(H), "--views", "4",
                    "--steps", "30", "--seed-points", "400", "--device",
                    "cpu", "--render-dir", str(out)])
    assert s["device"] == "cpu" and s["rasterizer"] == "scan path"
    assert s["resolution"] == f"{W}x{H}" and s["steps"] == 30
    for k in ("psnr", "ssim", "lpips", "gt_depth_mse"):
        assert np.isfinite(s["eval"][k]), k
    assert np.isfinite(s["eval_depth_mae_m"]) and s["eval"]["psnr"] > 5
    assert 0 < s["final_alive_gaussians"] <= 400
    assert s["lossy_census"]["train"] == [] and s["k_tile_escalations"] == []
    assert (out / "scale_demo.md").exists()
    assert sorted(p.name for p in out.iterdir()) == [
        "00003_depth.png", "00003_rgb.png", "scale_demo.md"]
    assert not list(tmp_path.glob("RESULTS*"))


def test_main_wants_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdemo.main(["--steps", "1"])
