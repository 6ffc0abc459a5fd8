"""A run whose timed path is broken underneath reads ``correct`` false:
a step that leaves its state unchanged, a loss over half the image, a
render altered where it is produced; and in a new job, the step after the
capacity growth leaving its state unchanged."""
import contextlib

import pytest
import torch

from conftest import add_growth_cell


@contextlib.contextmanager
def state_unchanged():
    from touchgs_torch.train import optim

    plain = optim.FusedAdam.step
    optim.FusedAdam.step = lambda self, params, grads, state: None
    try:
        yield
    finally:
        optim.FusedAdam.step = plain


@contextlib.contextmanager
def half_batch():
    from touchgs_torch.train import trainer

    plain = trainer.compute_losses

    def half(out, image, depth, unc, *a, **k):
        h = image.shape[0] // 2
        out = out._replace(rgb=out.rgb[:h], depth=out.depth[:h])
        return plain(out, image[:h], None if depth is None else depth[:h],
                     None if unc is None else unc[:h], *a, **k)

    trainer.compute_losses = half
    try:
        yield
    finally:
        trainer.compute_losses = plain


@contextlib.contextmanager
def altered_render():
    from touchgs_torch.models import splatfacto

    plain = splatfacto.rasterize_cuda

    def altered(*a, **k):
        out = plain(*a, **k)
        return out._replace(rgb=out.rgb * 1.01)

    splatfacto.rasterize_cuda = altered
    try:
        yield
    finally:
        splatfacto.rasterize_cuda = plain


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   altered_render])
def test_broken_step_is_not_correct(checkout, fault):
    from perfbench import harness

    torch.set_num_threads(2)
    with fault():
        r = harness.run_cell(checkout, "tiny.quick", 21, 0.1, False, "cpu")
    assert not r["correct"], r["compared"]


@contextlib.contextmanager
def unchanged_after_growth():
    """Adam's update dropped from the first growth on."""
    from touchgs_torch.train import optim, trainer

    plain_step, plain_grow = optim.FusedAdam.step, trainer.grow_state
    grown = []

    def step(self, params, grads, state):
        if not grown:
            plain_step(self, params, grads, state)

    def grow(*a, **k):
        grown.append(True)
        return plain_grow(*a, **k)

    optim.FusedAdam.step, trainer.grow_state = step, grow
    try:
        yield
    finally:
        optim.FusedAdam.step, trainer.grow_state = plain_step, plain_grow


def test_unchanged_step_after_growth_is_not_correct(checkout):
    from perfbench import harness

    torch.set_num_threads(2)
    cell = add_growth_cell(checkout)
    with unchanged_after_growth():
        r = harness.run_cell(checkout, cell, 77, 0.2, False, "cpu")
    assert not r["correct"], r["compared"]
    assert r["compared"]["grown_change_gap"]["value"] > 0.5
