"""``touchgs_torch.utils.resize`` against ``jax.image.resize``, bilinear and
bicubic, up and down, at square and odd sizes, on N(0, 1) data from numpy
seeds (ROADMAP.md C24).

Tolerances: the weight matrices within 2e-7 of JAX's; the port's output
within 3e-6 of a float64 product of JAX's own weights; and within 2e-5 of
``jax.image.resize`` itself, except where JAX's CPU contraction is the
looser one: 384² → 800² bicubic reads 1.0e-4 from that float64 product
(the port 5e-7), so those cases hold 2e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax._src.image import scale as jscale

from touchgs_torch.utils.resize import resize, weight_matrix

CASES = [  # (in shape, out shape, method, atol against jax.image.resize)
    ((800, 800, 3), (384, 384, 3), "bilinear", 2e-5),   # down, square
    ((384, 384), (800, 800), "bicubic", 2e-4),           # up, square
    ((24, 24, 8), (37, 37, 8), "bicubic", 2e-5),         # up, odd
    ((100, 72), (37, 53), "bicubic", 2e-5),              # down, odd
    ((72, 100, 3), (384, 384, 3), "bilinear", 2e-5),     # up, odd → square
    ((384, 384), (72, 100), "bicubic", 2e-5),            # down, square → odd
    ((1, 16, 6, 6), (1, 16, 48, 48), "bilinear", 2e-5),  # NCHW, up 8x
    ((1, 16, 48, 48), (1, 16, 12, 12), "bilinear", 2e-5),  # NCHW, down 4x
    ((37, 37, 64), (24, 29, 64), "bicubic", 2e-5),       # pos-embed grid
    ((16, 16), (16, 40), "bicubic", 2e-5),               # one axis only
]
KERNELS = {"bilinear": jscale._fill_triangle_kernel,
           "bicubic": jscale._fill_keys_cubic_kernel}


def _ids(case):
    src, dst, method, _ = case
    return f"{method}-{'x'.join(map(str, src))}-to-{'x'.join(map(str, dst))}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_resize_matches_jax(case):
    src, dst, method, atol = case
    x = np.random.default_rng(sum(src)).normal(size=src).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), dst, method))
    out = resize(torch.from_numpy(x), dst, method)
    assert out.dtype == torch.float32 and tuple(out.shape) == dst
    out = out.numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)

    # the same contraction in float64 with JAX's own weight matrices
    exact = x.astype(np.float64)
    for axis, (n_in, n_out) in enumerate(zip(src, dst)):
        if n_in != n_out:
            w = np.asarray(jscale.compute_weight_mat(
                n_in, n_out, n_out / n_in, 0.0, KERNELS[method], True),
                np.float64)
            exact = np.moveaxis(np.tensordot(exact, w, axes=([axis], [0])),
                                -1, axis)
    np.testing.assert_allclose(out, exact, rtol=0, atol=3e-6)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("n_in,n_out", [(384, 800), (800, 384), (37, 24),
                                        (24, 37), (72, 384), (7, 7 * 16)])
def test_weight_matrix_matches_jax(method, n_in, n_out):
    ref = np.asarray(jscale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, KERNELS[method], True))
    np.testing.assert_allclose(weight_matrix(n_in, n_out, method).numpy(),
                               ref, rtol=0, atol=2e-7)


def test_interpolate_without_antialias_is_not_jax():
    """The trap the port's resize avoids: ``F.interpolate`` without
    antialias misses ``jax.image.resize`` by more than 1 on a bilinear
    800² → 384² of N(0, 1) data (3.0 in the run that chose the design)."""
    x = np.random.default_rng(0).normal(size=(800, 800)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (384, 384),
                                      "bilinear"))
    plain = F.interpolate(torch.from_numpy(x)[None, None], size=(384, 384),
                          mode="bilinear", align_corners=False)[0, 0]
    assert np.abs(plain.numpy() - ref).max() > 1.0
    np.testing.assert_allclose(resize(torch.from_numpy(x), (384, 384),
                                      "bilinear").numpy(), ref, atol=2e-5)


def test_rejects_other_methods_and_ranks():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="method"):
        resize(x, (8, 8), "lanczos3")
    with pytest.raises(ValueError, match="axes"):
        resize(x, (8, 8, 1), "bilinear")
