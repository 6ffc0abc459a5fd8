"""The control, the reference computed with TF32 matrix products in the
program's place, reads above the cell's limits where the program reads
under them; at a reduced size, on the card."""
import importlib
import json

import pytest
import torch

from conftest import ROOT, polish, tiny_config


@pytest.mark.cuda
def test_control_fails_where_the_program_passes(card):
    from perfbench import check

    cfg = tiny_config("t")
    cfg["scene"].update(width=320, height=240)
    cfg["scene"]["camera"]["focal_frac"] = 1.39
    cfg["state"]["live_gaussians"] = 12000
    cfg["train"]["model"]["max_gaussians"] = 16384
    limits = json.loads((ROOT / "perfbench" / "limits"
                         / "blender800.polish.json").read_text())
    tr = polish(20)
    driver = importlib.import_module("perfbench.drivers.resumed_job")
    for seed in (1, 2, 3):
        job = driver.setup(cfg, tr, seed, card)
        job.free()
        ok, _ = check.judge(check.program_readings(job, card), limits)
        assert ok
        refr = check.reference_run(job, card)
        ctl = check.readings(check.reference_run(job, card, tf32_on=True),
                             refr, check.start_state(job))
        bad, _ = check.judge(ctl, limits)
        assert not bad
        torch.cuda.empty_cache()
