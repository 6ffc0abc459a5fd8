"""The pair and operation counts against a hand count."""
import torch

from perfbench import counts
from perfbench.reference import splat

RC = {"tile_h": 2, "tile_w": 2, "k_tile": 128, "k_chunk": 64,
      "alpha_clip": 0.999, "alpha_threshold": 1 / 255}


def test_needed_entries_by_hand():
    # one 2x2 tile; three opaque flat entries: after the second every pixel
    # is under 1e-4 (0.999 each: T = 1e-6), so two are needed; a second
    # tile whose single faint entry never saturates needs its whole list
    attr = torch.tensor([
        [1.0, 1.0, 0.0, 0.0, 0.0, 0.999, 1.0, 1, 1, 1],
        [1.0, 1.0, 0.0, 0.0, 0.0, 0.999, 2.0, 1, 1, 1],
        [1.0, 1.0, 0.0, 0.0, 0.0, 0.999, 3.0, 1, 1, 1],
        [3.0, 1.0, 0.0, 0.0, 0.0, 0.1, 1.0, 1, 1, 1]])
    lists = torch.full((2, 128), -1)
    lists[0, :3] = torch.tensor([0, 1, 2])
    lists[1, 0] = 3
    counts_ = torch.tensor([3, 1])
    need = splat.needed_entries(attr, lists, counts_, 4, 2, RC)
    assert need.tolist() == [2, 1]
    pix = splat.tile_pixels_in_image(4, 2, RC)
    assert pix.tolist() == [4, 4]
    assert splat.tile_pixels_in_image(3, 3, RC).tolist() == [4, 2, 2, 1]


def test_operation_and_byte_bounds():
    # 10 entries, 1000 pairs, 2 tiles of 4 pixels
    fwd = counts.composite_bound_s(10, 1000, 2, 4, counts.K2_OPS_PER_PAIR)
    assert fwd == max(34_000 / 67e12, (10 * 64 + 2 * 4 * 8 * 4) / 3.35e12)
    bwd = counts.composite_bound_s(10, 1000, 2, 4, counts.K3_OPS_PER_PAIR,
                                   passes=2)
    assert bwd == max(76_000 / 67e12, 2 * (10 * 64 + 2 * 4 * 8 * 4) / 3.35e12)
    assert counts.step_ops(1000, 2, 3) == (1000 * 110 + 2 * (
        counts.PROJECTION_OPS + counts.SH_OPS + counts.ADAM_OPS)
        + 3 * counts.LOSS_OPS)


def test_busy_seconds_is_the_union():
    assert counts.busy_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert counts.busy_seconds([]) == 0
