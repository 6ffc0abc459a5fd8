"""Deep tile lists on the port's CPU path (its kernels' plain versions)
against the benchmark's plain reference (``perfbench/reference/``): a
seeded random state whose four 16x16 tiles of a 32x24 view each hold 5,600
to 7,700 entries, past the JAX package's training ceiling of 4096, all
composited under a cap of 8192 (the Gaussians are faint, so no tile
saturates before its list ends), under the ``bunny_real`` preset's loss
(fused depth with its uncertainty, weighted ×0.005).  The render (rgb,
depth, acc) and one ``make_train_step``'s gradients, as Adam's first
moments hold them, are compared.  Imports neither JAX nor the JAX
package."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import job as jobmod
from perfbench.reference import splat
from perfbench.reference import train as ref
from perfbench.scene import analytic, state

CONFIG = (Path(__file__).resolve().parents[1] / "perfbench" / "configs"
          / "bunny_real_1m.json")

W, H, TILE, K_TILE = 32, 24, 16, 8192
N_LIVE, CAPACITY = 12000, 16384
VIEW = 0


@pytest.fixture(scope="module")
def deep():
    """The configuration (``bunny_real_1m`` cut to 32x24 and 16x16 tiles),
    its scene and a start state: the surface state with each live
    Gaussian six times as wide and of an opacity uniform in [0.005, 0.02]."""
    torch.set_num_threads(1)
    cfg = json.loads(CONFIG.read_text())
    cfg["scene"].update(width=W, height=H, views=50, seed_points=500)
    cfg["scene"]["camera"]["focal_frac"] = 1.0
    cfg["state"].update(live_gaussians=N_LIVE)
    cfg["train"]["model"]["max_gaussians"] = CAPACITY
    cfg["train"]["rasterize"].update(tile_h=TILE, tile_w=TILE, k_tile=K_TILE)
    cfg["train"]["view_cache_bytes"] = 1 << 26
    sc = analytic.make_scene(cfg, 3, "cpu")
    st = state.surface_state(
        cfg, {"start": {"step": 15000, "adam_nu": 1e-6}}, 3, "cpu")
    g = torch.Generator().manual_seed(11)
    p = st["params"]
    p["log_scales"][:N_LIVE] += float(np.log(6.0))
    op = 0.005 + 0.015 * torch.rand(N_LIVE, generator=g)
    p["logit_opacities"][:N_LIVE] = torch.log(op / (1 - op))
    return cfg, sc, st


def _copy(st: dict) -> dict:
    return {k: ({n: v.clone() for n, v in d.items()} if isinstance(d, dict)
                else d) for k, d in st.items()}


def test_lists_are_deep_and_composited_whole(deep):
    """Every tile's list is longer than 4096 and shorter than the cap, and
    each needs its whole list: none is truncated, none exits early."""
    cfg, sc, st = deep
    cam, _ = sc.view(VIEW, "cpu")
    rc = ref.raster_consts(cfg["train"], CAPACITY, K_TILE)
    attr, proj = splat.attributes(st["params"], cam, rc, 3)
    lists, counts = splat.bin_tiles(proj, W, H, rc)
    need = splat.needed_entries(attr, lists, counts, W, H, rc)
    assert len(counts) == 4
    assert bool(((counts > 4096) & (counts < K_TILE)).all()), counts
    assert torch.equal(need, counts), (need, counts)


def test_deep_render_matches_the_reference(deep):
    """rgb and acc within 2e-5 absolute, depth within 2e-5 of its largest:
    both sides composite each pixel's 5,600–7,700 entries in float32, the
    reference's transmittance as a cumulative product and the kernels'
    one entry after another, so the products round in other orders; at
    this depth the gap measured 4.4e-6 (rgb), 4.1e-6 (acc) and 6.3e-6 of
    3.5 (depth).  Rendered at 4096 instead, acc moves by up to 0.82 and all
    four tiles read lossy."""
    from touchgs_torch.models.splatfacto import render

    cfg, sc, st = deep
    tcfg = jobmod.train_config(cfg, 0)
    prog = jobmod.program_state(_copy(st))
    cam_p = jobmod.program_scene(cfg, sc).cameras.at(VIEW, "cpu")
    with torch.no_grad():
        out, _ = render(prog.params, cam_p, tcfg.model, active_sh_degree=3,
                        k_tile=K_TILE)
    assert int(out.lossy_tiles) == 0
    cam, _ = sc.view(VIEW, "cpu")
    rc = ref.raster_consts(cfg["train"], CAPACITY, K_TILE)
    attr, proj = splat.attributes(st["params"], cam, rc, 3)
    lists, counts = splat.bin_tiles(proj, W, H, rc)
    stack = splat.render_stack(attr, lists, counts, W, H, rc)
    rgb, depth, acc = splat.finish(stack, W, H, torch.zeros(3))
    assert float(acc.mean()) > 0.5
    np.testing.assert_allclose(rgb, out.rgb, atol=2e-5)
    np.testing.assert_allclose(acc, out.acc, atol=2e-5)
    np.testing.assert_allclose(depth, out.depth,
                               atol=2e-5 * float(depth.abs().max()))


def test_deep_step_gradients_match_the_reference(deep):
    """One ``make_train_step`` (the graphed step's plain body, K1 with rows,
    K2, K3 and the rows' scatter-add in their plain versions) against the
    reference's autograd, under the preset's uncertainty-weighted depth
    loss: the loss within 1e-5 relative, each group's gradient (Adam's
    first moment over 1 − β₁) within 1e-3 of its norm.  Float32 sums of
    thousands of terms per pixel and per Gaussian in other orders; the
    loss measured 7.5e-8 apart and the worst group 1.2e-5 of its norm
    (``logit_opacities``).  From lists cut at 4096 the loss reads 2.7% off
    and the groups 0.12 to 0.30 of their norms."""
    from touchgs_torch.train.optim import FusedAdam
    from touchgs_torch.train.trainer import make_train_step

    cfg, sc, st = deep
    tcfg = jobmod.train_config(cfg, 0)
    prog = jobmod.program_state(_copy(st))
    step = make_train_step(tcfg, FusedAdam(tcfg.optim), k_tile=K_TILE)
    cam_p = jobmod.program_scene(cfg, sc).cameras.at(VIEW, "cpu")
    cam, view = sc.view(VIEW, "cpu")
    assert view["unc"] is not None
    _, m = step.__wrapped__(prog, cam_p, view["image"], view["depth"],
                            view["unc"], 3, None)
    out, grads, _, _ = ref.loss_and_grads(st["params"], cam, view,
                                          cfg["train"], 3, K_TILE)
    assert out["depth_loss"] > 0
    assert abs(float(m["loss"]) - out["loss"]) <= 1e-5 * out["loss"]
    b1 = cfg["train"]["adam"]["b1"]
    for k in ref.GROUPS:
        g_prog = prog.opt_state.mu[k] / (1 - b1)
        err = float(torch.linalg.vector_norm(g_prog - grads[k]))
        assert err <= 1e-3 * float(torch.linalg.vector_norm(grads[k])), k
