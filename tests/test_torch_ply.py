"""The port's ``.ply`` IO (``touchgs_torch/data/ply.py``) against the JAX
package's, on the CPU: the same splat file byte for byte from the same
parameters, each package reading the other's file, a render from the
port's load of a JAX ``.ply`` against the JAX render of the same
parameters (rgb/acc 3e-5, depth 3e-4, ROADMAP.md's kernel tolerances), the
point-cloud helpers and ``sh_dc_to_rgb``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.data import ply as jply
from touchgs_tpu.models.gaussians import init_random as j_init_random
from touchgs_tpu.models.splatfacto import render as j_render
from touchgs_tpu.ops.sh import sh_dc_to_rgb as j_sh_dc_to_rgb
from touchgs_torch.data import ply as tply
from touchgs_torch.data.cameras import Cameras as TCameras
from touchgs_torch.models.gaussians import params_from_numpy
from touchgs_torch.models.splatfacto import render as t_render
from touchgs_torch.ops.sh import sh_dc_to_rgb as t_sh_dc_to_rgb

from tests.synthetic import look_at_camera

CAP, N, W, H = 1024, 700, 96, 64


@pytest.fixture(scope="module")
def jparams():
    """JAX parameters at SH degree 3 with dead slots and non-zero higher
    bands, so every field and the channel-major ``f_rest`` carry data."""
    p = j_init_random(N, CAP, sh_degree=3, seed=4)
    rng = np.random.default_rng(4)
    alive = np.asarray(p.alive).copy()
    alive[rng.choice(N, 50, replace=False)] = False
    return dataclasses.replace(
        p, alive=jnp.asarray(alive),
        sh_rest=jnp.asarray(rng.normal(0, 0.05, (CAP, 15, 3)), jnp.float32),
        quats=jnp.asarray(rng.normal(size=(CAP, 4)), jnp.float32))


def _numpy(p) -> dict:
    return {f.name: np.asarray(getattr(p, f.name))
            for f in dataclasses.fields(p)}


def test_same_file_as_jax(jparams, tmp_path):
    tp = params_from_numpy(_numpy(jparams), "cpu")
    nj = jply.save_gaussians_ply(tmp_path / "j.ply", jparams)
    nt = tply.save_gaussians_ply(tmp_path / "t.ply", tp)
    assert nj == nt == int(np.asarray(jparams.alive).sum())
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_each_reads_the_others(jparams, tmp_path):
    tp = params_from_numpy(_numpy(jparams), "cpu")
    jply.save_gaussians_ply(tmp_path / "j.ply", jparams)
    tply.save_gaussians_ply(tmp_path / "t.ply", tp)
    from_j = tply.load_gaussians_ply(tmp_path / "j.ply", device="cpu")
    from_t = jply.load_gaussians_ply(tmp_path / "t.ply")
    alive = np.asarray(jparams.alive)
    n = int(alive.sum())
    assert from_j.capacity == from_t.capacity == 1024 >= n
    for f in dataclasses.fields(from_t):
        a = getattr(from_j, f.name).numpy()
        b = np.asarray(getattr(from_t, f.name))
        np.testing.assert_array_equal(a, b, err_msg=f.name)
        if f.name != "alive":
            np.testing.assert_array_equal(
                a[:n], np.asarray(getattr(jparams, f.name))[alive],
                err_msg=f.name)
    with pytest.raises(ValueError, match="capacity"):
        tply.load_gaussians_ply(tmp_path / "j.ply", capacity=n - 1,
                                device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_render_of_jax_ply_matches_jax_render(jparams, tmp_path, use_pallas):
    """The port renders its load of the JAX package's ``.ply`` (alive slots
    only, compacted, so other indices break depth ties); the JAX package
    renders the parameters it saved.  Both on the scan path, or both
    through the tile kernels (JAX: Pallas interpreted; the port: the
    kernels' plain versions)."""
    jply.save_gaussians_ply(tmp_path / "j.ply", jparams)
    tp = tply.load_gaussians_ply(tmp_path / "j.ply", device="cpu")
    cam = look_at_camera(eye=(0.3, 0.5, 2.2), width=W, height=H, focal=90.0)
    jc = jcfg.ModelConfig(max_gaussians=CAP, sh_degree=3,
                          rasterize=jcfg.RasterizeConfig(use_pallas=use_pallas))
    tc = tcfg.ModelConfig(max_gaussians=CAP, sh_degree=3,
                          rasterize=tcfg.RasterizeConfig(use_pallas=use_pallas))
    jout, _ = j_render(jparams, cam, jc, active_sh_degree=3)
    tcam = TCameras(fx=np.array([cam.fx], np.float32),
                    fy=np.array([cam.fy], np.float32),
                    cx=np.array([cam.cx], np.float32),
                    cy=np.array([cam.cy], np.float32),
                    c2w=np.asarray(cam.c2w)[None], width=W, height=H
                    ).at(0, "cpu")
    with torch.no_grad():
        tout, _ = t_render(tp, tcam, tc, active_sh_degree=3)
    assert float(np.asarray(jout.acc).max()) > 0.5
    for name, tol in (("rgb", 3e-5), ("acc", 3e-5), ("depth", 3e-4)):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)), atol=tol,
                                   rtol=0, err_msg=name)


def test_pointcloud_ply_round_trip(tmp_path):
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    tply.write_pointcloud_ply(tmp_path / "t.ply", pts, cols)
    jply.write_pointcloud_ply(tmp_path / "j.ply", pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    p, c = tply.read_pointcloud_ply(tmp_path / "j.ply")
    jp, jc_ = jply.read_pointcloud_ply(tmp_path / "t.ply")
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(c, jc_)


def test_sh_dc_to_rgb_matches_jax():
    dc = np.random.default_rng(7).normal(size=(100, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_sh_dc_to_rgb(torch.as_tensor(dc)).numpy(),
                                  np.asarray(j_sh_dc_to_rgb(jnp.asarray(dc))))
