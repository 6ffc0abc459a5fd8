"""The frozen reference agrees with the port's CPU path (its kernels' plain
versions) at a tiny size: the render, one step's gradients, a refine and
a growth."""
import dataclasses

import numpy as np
import torch

from conftest import tiny_config
from perfbench import job as jobmod
from perfbench.reference import densify as ref_densify
from perfbench.reference import splat
from perfbench.reference import train as ref
from perfbench.scene import analytic, state

TR = {"start": {"step": 15000, "adam_nu": 1e-6}}


def scene_and_state(seed=3):
    cfg = tiny_config("t")
    sc = analytic.make_scene(cfg, seed, "cpu")
    st = state.surface_state(cfg, TR, seed, "cpu")
    return cfg, sc, st


def test_render_matches_the_port():
    from touchgs_torch.models.splatfacto import render

    cfg, sc, st = scene_and_state()
    tcfg = jobmod.train_config(cfg, 0)
    prog = jobmod.program_state(st)
    cam_p = jobmod.program_scene(cfg, sc).cameras.at(2, "cpu")
    with torch.no_grad():
        out, _ = render(prog.params, cam_p, tcfg.model, active_sh_degree=3,
                        k_tile=1024)
    cam, _ = sc.view(2, "cpu")
    rc = ref.raster_consts(cfg["train"], 2048, 1024)
    attr, proj = splat.attributes(st["params"], cam, rc, 3)
    lists, counts = splat.bin_tiles(proj, 64, 48, rc)
    stack = splat.render_stack(attr, lists, counts, 64, 48, rc)
    rgb, depth, acc = splat.finish(stack, 64, 48, torch.zeros(3))
    assert float(acc.mean()) > 0.3
    np.testing.assert_allclose(rgb, out.rgb, atol=2e-6)
    np.testing.assert_allclose(acc, out.acc, atol=2e-6)
    np.testing.assert_allclose(depth, out.depth, rtol=1e-5, atol=1e-5)


def test_step_gradients_match_the_port():
    from touchgs_torch.train.trainer import make_train_step

    cfg, sc, st = scene_and_state()
    tcfg = jobmod.train_config(cfg, 0)
    from touchgs_torch.train.optim import FusedAdam

    prog = jobmod.program_state(
        {k: ({n: v.clone() for n, v in d.items()} if isinstance(d, dict)
             else d) for k, d in st.items()})
    step = make_train_step(tcfg, FusedAdam(tcfg.optim), k_tile=1024)
    cam_p = jobmod.program_scene(cfg, sc).cameras.at(5, "cpu")
    _, m = step.__wrapped__(prog, cam_p, torch.as_tensor(sc.images[5]),
                            torch.as_tensor(sc.depths[5]), None, 3, None)
    cam, view = sc.view(5, "cpu")
    out, grads, _, _ = ref.loss_and_grads(st["params"], cam, view,
                                          cfg["train"], 3, 1024)
    assert abs(float(m["loss"]) - out["loss"]) <= 1e-6 * out["loss"]
    for k in ref.GROUPS:
        g_prog = prog.opt_state.mu[k] / 0.1
        np.testing.assert_allclose(g_prog, grads[k], rtol=1e-3,
                                   atol=1e-4 * float(grads[k].abs().max()))


def test_refine_and_grow_match_the_port():
    from touchgs_torch.models.densify import DensifyState
    from touchgs_torch.train.trainer import grow_state, refine_state

    cfg, _, st = scene_and_state()
    tcfg = jobmod.train_config(cfg, 0)
    g = torch.Generator().manual_seed(5)
    C = st["params"]["means"].shape[0]
    st["stats"] = dict(grad_accum=torch.rand(C, generator=g) * 1e-3,
                       grad_count=torch.ones(C),
                       max_radii=torch.rand(C, generator=g) * 0.1)
    st["mu"] = {k: torch.rand_like(v) for k, v in st["mu"].items()}
    prog = jobmod.program_state(
        {k: ({n: v.clone() for n, v in d.items()} if isinstance(d, dict)
             else d) for k, d in st.items()})
    gen = torch.Generator().manual_seed(17)
    rng = gen.get_state()
    refine_state(prog, tcfg, True, True, True, generator=gen)
    d = cfg["train"]["densify"]
    noise = torch.randn((2, C, 3), generator=torch.Generator().set_state(rng))
    want = ref_densify.refine(st, (True, True, True), noise, d)
    for k, v in want["params"].items():
        got = getattr(prog.params, k)
        if k == "alive":
            assert torch.equal(got, v)
        else:
            np.testing.assert_allclose(got, v, rtol=1e-6, atol=1e-7)
    for k in ref.GROUPS:
        assert torch.equal(prog.opt_state.mu[k], want["mu"][k])
    grown = grow_state(prog, 2 * C)
    ref_grown = ref_densify.grow(jobmod.state_dict(prog), 2 * C)
    for k, v in ref_grown["params"].items():
        assert torch.equal(getattr(grown.params, k), v)
    assert isinstance(grown.densify, DensifyState)
    assert dataclasses.is_dataclass(grown)
