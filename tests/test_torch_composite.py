"""The compositing kernels' thread shape on the CPU: K3's summation order and
the tile sizes that take each pixels-per-thread instance of K2 and K3.

K2 and K3 (``touchgs_torch/csrc/composite_{fwd,bwd}.cu``) give each thread
P pixels of a tile (``rasterize_plain.pixels_per_thread``).  K3 sums its
per-pixel quantities in a fixed order; its plain version must sum in the
same order to agree with it to the last bit on the card.  Here:

- ``_block_sum`` against a numpy rebuild of the kernel's reduction (each
  thread's pixels, its three reduce-scatter shuffle steps with the kernel's
  send and keep choices, the partials in order), bit for bit, and against a
  float64 sum within the float32 bound of its summation tree;
- the plain forward and backward against the JAX package's Pallas kernels in
  interpret mode at tile sizes that take P = 4, 4, 2 and 1: ``chunks_done``
  equal, T and rgb/acc within 3e-5, depth 3e-4, gradients atol 5e-6 /
  rtol 1e-4 (``tests/test_torch_rasterize.py`` holds the 32x32 cases).

The kernels themselves against these plain versions are in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.ops import rasterize_pallas as rp
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain

from tests.test_torch_cuda import K_CHUNK, K_TILE, N_TILES, N_TX
from tests.test_torch_cuda import saturating_tiles

_TIDS = np.arange(N_TILES, dtype=np.int32)
# (th, tw) with P = 4 (64 threads), 2 (32 threads) and 1 (32 threads)
SMALL_TILES = [(16, 16), (8, 8), (4, 8)]
U32 = 2.0 ** -24  # float32 unit roundoff


@pytest.mark.parametrize("npix", range(32, 1025, 32))
def test_pixels_per_thread_gives_whole_warps(npix):
    p = plain.pixels_per_thread(npix)
    assert p in (1, 2, 4) and npix % p == 0 and (npix // p) % 32 == 0
    # the largest of 4, 2, 1 that does
    assert all((npix // b) % 32 or npix % b for b in (4, 2) if b > p)


def _lane_steps(v):
    """The kernel's three reduce-scatter steps (``lane_steps``): v (32, 10)
    lane values → o (32, 2), the two slots of each lane."""
    lane = np.arange(32)
    z = np.zeros(32, np.float32)

    def step(x, bit, n_keep):
        """Lanes with ``bit`` set keep x[:, n_keep:], the others
        x[:, :n_keep]; each adds its partner's (lane ^ bit) send."""
        hi_set = (lane & bit) > 0
        out = np.empty((32, n_keep), np.float32)
        for j in range(n_keep):
            hi = x[:, j + n_keep] if j + n_keep < x.shape[1] else z
            send = np.where(hi_set, x[:, j], hi)
            keep = np.where(hi_set, hi, x[:, j])
            out[:, j] = keep + send[lane ^ bit]
        return out

    return step(step(step(v, 16, 5), 8, 3), 4, 2)


def _slot_quantity(lane, j):
    b4, b3, b2 = (lane >> 4) & 1, (lane >> 3) & 1, (lane >> 2) & 1
    in_s = 3 * b3 + 2 * b2 + j
    return 5 * b4 + in_s if 2 * b2 + j < 3 and in_s < 5 else -1


def _kernel_order_sum(x):
    """(10, npix) float32 → (10,), summed as K3 sums."""
    q, npix = x.shape
    p = plain.pixels_per_thread(npix)
    s = npix // p
    v = x[:, :s].copy()
    for j in range(1, p):
        v = v + x[:, j * s:(j + 1) * s]
    n_warps = s // 32
    part = np.full((q, n_warps, 4), np.nan, np.float32)
    for w in range(n_warps):
        o = _lane_steps(np.ascontiguousarray(v[:, w * 32:(w + 1) * 32].T))
        for lane in range(32):
            for j in range(2):
                k = _slot_quantity(lane, j)
                if k >= 0:
                    assert np.isnan(part[k, w, lane & 3])  # stored once
                    part[k, w, lane & 3] = o[lane, j]
    part = part.reshape(q, -1)
    assert not np.isnan(part).any()
    out = part[:, 0].copy()
    for i in range(1, part.shape[1]):
        out = out + part[:, i]
    return out


@pytest.mark.parametrize("npix", [1024, 256, 192, 96])
def test_block_sum_is_the_kernels_order(npix):
    """Bit for bit the kernel's order, on terms of both signs whose sum
    cancels; and within the float32 bound of that summation tree of the
    float64 sum: γ_h·Σ|x| with h = (P − 1) + 3 + (4·n_warps − 1) the
    additions a term passes through."""
    rng = np.random.default_rng(npix)
    x = (rng.normal(size=(10, npix)) * rng.uniform(0.1, 10.0, (10, 1))
         ).astype(np.float32)
    got = plain._block_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _kernel_order_sum(x))
    p = plain.pixels_per_thread(npix)
    h = (p - 1) + 3 + 4 * (npix // p // 32) - 1
    exact = x.astype(np.float64).sum(axis=1)
    bound = h * U32 / (1 - h * U32) * np.abs(x).astype(np.float64).sum(axis=1)
    assert np.all(np.abs(got - exact) <= bound)
    print(f"npix {npix}: max |block sum - float64| "
          f"{np.abs(got - exact).max():.3e}, bound {bound.min():.3e}")


def _tiles(th, tw):
    at, counts = saturating_tiles(th=th, tw=tw)
    return at, ((counts + K_CHUNK - 1) // K_CHUNK).astype(np.int32)


def _j_forward(at, nc, th, tw):
    return np.array(rp._forward_tiles(
        jnp.asarray(nc), jnp.asarray(_TIDS), jnp.asarray(at), th, tw, K_TILE,
        K_CHUNK, N_TX, jcfg.RasterizeConfig(), True))


@pytest.mark.parametrize("th,tw", SMALL_TILES)
def test_forward_small_tiles_matches(th, tw):
    """chunks_done equal to JAX's, T within 3e-5 (JAX forms T as a log-depth
    prefix product, the port as a running one, so the last bits differ)."""
    at, nc = _tiles(th, tw)
    j = _j_forward(at, nc, th, tw)
    t = rc.forward_tiles(torch.from_numpy(nc), torch.from_numpy(_TIDS),
                         torch.from_numpy(at), th, tw, K_TILE, K_CHUNK, N_TX,
                         tcfg.RasterizeConfig()).numpy()
    np.testing.assert_array_equal(t[:, plain.ROW_DONE], j[:, plain.ROW_DONE])
    for r in (0, 1, 2, 4, plain.ROW_T):
        np.testing.assert_allclose(t[:, r], j[:, r], atol=3e-5, err_msg=r)
    np.testing.assert_allclose(t[:, 3], j[:, 3], atol=3e-4)
    assert t[:, 4].max() > 0.5
    print(f"K2 {th}x{tw}: chunks_done {t[:, plain.ROW_DONE, 0]}, max |T - "
          f"JAX T| {np.abs(t[:, plain.ROW_T] - j[:, plain.ROW_T]).max():.3e}")


@pytest.mark.parametrize("th,tw", SMALL_TILES)
def test_backward_small_tiles_matches(th, tw):
    at, nc = _tiles(th, tw)
    fwd = _j_forward(at, nc, th, tw)
    rng = np.random.default_rng(3)
    g = (rng.normal(size=fwd.shape) / (N_TILES * th * tw)).astype(np.float32)
    done = fwd[:, plain.ROW_DONE, 0].astype(np.int32)
    j = np.asarray(rp._backward_tiles(
        jnp.asarray(done), jnp.asarray(_TIDS), jnp.asarray(at),
        jnp.asarray(fwd), jnp.asarray(g), th, tw, K_TILE, K_CHUNK, N_TX,
        jcfg.RasterizeConfig(), True))
    t = rc.backward_tiles(*(torch.from_numpy(a) for a in (done, _TIDS, at,
                                                           fwd, g)),
                          th, tw, K_TILE, K_CHUNK, N_TX,
                          tcfg.RasterizeConfig()).numpy()
    assert np.abs(j).max() > 1e-4
    np.testing.assert_allclose(t, j, atol=5e-6, rtol=1e-4)
    print(f"K3 {th}x{tw}: max |port - JAX| {np.abs(t - j).max():.3e} "
          f"(largest |JAX| {np.abs(j).max():.3e})")
    for tile in range(N_TILES):
        assert not t[tile, done[tile] * K_CHUNK:].any()
