"""The yardstick's arithmetic: the card's published peaks, the operations
and bytes a training step needs, and the device's busy share.  Copied
here from the program (``touchgs_torch/utils/profiling.py``'s ``H100`` and
``composite_cost``, ``bench_torch.py``'s operations per pair,
``chip_smoke.py``'s busy share) so that a change to the program cannot
move it.

Operations are the fp32 operations the algorithm needs, counted once;
work that an implementation repeats (the compositing forward run again in
the backward, the SSIM window's zeros in a banded matrix product) is not
counted.
"""
from __future__ import annotations

# NVIDIA H100 SXM, published dense peaks at 700 W
PEAK_FP32 = 67e12      # FLOP/s outside the tensor cores
PEAK_BF16 = 989e12     # FLOP/s on the tensor cores
HBM_BPS = 3.35e12      # bytes/s

# fp32 operations per (entry, pixel) pair: the compositing forward (α,
# transmittance, four weighted sums) and its analytic backward
K2_OPS_PER_PAIR = 34
K3_OPS_PER_PAIR = 76
ATTR_BYTES = 16 * 4    # one entry's packed attribute row
STACK_ROWS = 8         # the forward's output rows a pixel

# per live Gaussian, forward and backward together: the EWA projection
# (quaternion to rotation, Σ' = W R S Sᵀ Rᵀ Wᵀ, the Jacobian product, the
# conic, radius and cull: ~200 operations forward, twice that backward),
# degree-3 SH colour (16 bases x 3 channels plus the basis: ~140 forward,
# twice that backward), and Adam over its 59 parameters (~12 each)
PROJECTION_OPS = 600
SH_OPS = 420
ADAM_OPS = 59 * 12
# per pixel: L1 (3 channels), SSIM (15 blurred channels, 11 + 11 taps,
# a multiply and an add each, and the map; forward and backward) and the
# depth term
LOSS_OPS = 3 * 6 + 3 * (15 * 22 * 2 + 40) + 12


def composite_bound_s(entries: float, pairs: float, n_tiles: int,
                      tile_pixels: int, ops_per_pair: int,
                      passes: int = 1) -> float:
    """Least seconds of a compositing kernel: the larger of its operations
    over the fp32 peak and its bytes (each entry's row read, and its
    gradient written in the backward; each tile's output rows) over the
    memory's peak.  ``passes`` is 1 for the forward, 2 for the backward,
    which reads the forward's rows and the rows' gradient and writes one
    gradient row an entry."""
    ops = pairs * ops_per_pair
    nbytes = (entries * ATTR_BYTES * passes
              + n_tiles * tile_pixels * STACK_ROWS * 4 * passes)
    return max(ops / PEAK_FP32, nbytes / HBM_BPS)


def step_ops(pairs: float, live: int, pixels: int) -> float:
    """Useful fp32 operations of one training step."""
    return (pairs * (K2_OPS_PER_PAIR + K3_OPS_PER_PAIR)
            + live * (PROJECTION_OPS + SH_OPS + ADAM_OPS)
            + pixels * LOSS_OPS)


def busy_seconds(intervals) -> float:
    """Seconds in which at least one device operation ran: the union of
    (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total
