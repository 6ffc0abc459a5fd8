"""The scene and the start state are functions of the seed."""
import numpy as np
import torch

from conftest import tiny_config
from perfbench.scene import analytic, state


def test_scene_is_deterministic_by_seed():
    for base in ("bunny_blender_800", "mirror_1280x720"):
        cfg = tiny_config("t", base)
        a = analytic.make_scene(cfg, 2**31 + 3, "cpu")
        b = analytic.make_scene(cfg, 2**31 + 3, "cpu")
        c = analytic.make_scene(cfg, 4, "cpu")
        for k in ("c2w", "images", "depths", "seed_points"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert not np.array_equal(a.images, c.images)
        assert a.images.shape == (24, 48, 64, 3)
        assert (a.depths > 0).mean() > 0.3     # the object is in view
        assert (a.uncertainties is None) == (base == "bunny_blender_800")


def test_start_state_is_deterministic_by_seed():
    cfg = tiny_config("t")
    tr = {"start": {"step": 15000, "adam_nu": 1e-6}}
    a = state.surface_state(cfg, tr, 9, "cpu")
    b = state.surface_state(cfg, tr, 9, "cpu")
    c = state.surface_state(cfg, tr, 10, "cpu")
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k])
    assert not torch.equal(a["params"]["means"], c["params"]["means"])
    assert int(a["params"]["alive"].sum()) == 1500
    assert a["count"] == a["step"] == 15000
