"""K1 with rows, ``rc.slot_rows``, against the JAX package, and the kernel
wrappers' launch path.

``rc.slot_rows`` on the CPU (its plain version) against the JAX package's
``_slot_lists`` in interpret mode followed by its gather ``attrs[gidx]``,
bit for bit on both the lists and the rows; ``_SlotRows``'s backward
against PyTorch's own backward of ``attrs[gidx]`` (equal) and against
``jax.vjp`` of the gather (the gradient tolerance, 5e-6).  Two inputs: the
tiles of the 300-Gaussian scene of ``tests/test_torch_rasterize.py``, and
``synthetic_slots``, with empty tiles and tiles that hold more than k_tile
entries.

The launch path's checks: ``cuda_build.check_tensor`` on a wrong dtype,
shape or layout, and every wrapper on a mix of devices (meta tensors
beside CPU ones).  The kernels on the card are held against these plain
versions in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
from touchgs_tpu.ops import rasterize_pallas as rp
from touchgs_tpu.ops.tiles import bin_gaussians as j_bin
from touchgs_torch.ops import anatomy, cuda_build
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.config import RasterizeConfig

from tests.test_torch_cuda import synthetic_slots
from tests.test_torch_rasterize import H, N_TILES, W, scene  # noqa: F401

K_TILES = [128, 512]


def _slot_case(case, k_tile, scene):
    """(attrs, sorted_gauss, starts, capped counts, n_tiles, dead) as numpy,
    with the JAX package's binning and packing for the scene."""
    if case == "synthetic":
        attrs, sg, starts, capped, n = synthetic_slots(k_tile)
        return attrs, sg, starts, capped, len(starts), n
    proj = scene["proj"]
    bins = j_bin(proj, W, H, jcfg.RasterizeConfig())
    attrs = rp._pack_attrs(proj, scene["colors"], scene["opac"])
    capped = jnp.minimum(bins.tile_counts, k_tile)
    return (np.asarray(attrs), np.asarray(bins.sorted_gauss),
            np.asarray(bins.tile_starts), np.asarray(capped), N_TILES,
            proj.means2d.shape[0])


def _jax_slot_rows(attrs, sg, starts, capped, n_tiles, k_tile, dead):
    gidx = rp._slot_lists(jnp.asarray(sg), jnp.asarray(starts),
                          jnp.asarray(capped), n_tiles, k_tile, dead, True)
    return np.asarray(gidx), np.asarray(jnp.asarray(attrs)[gidx])


def _torch_args(attrs, sg, starts, capped, n_tiles, dead, k_tile,
                requires_grad=False):
    return (torch.tensor(attrs, requires_grad=requires_grad),
            torch.tensor(sg), torch.tensor(starts), torch.tensor(capped),
            n_tiles, k_tile, dead)


@pytest.mark.parametrize("k_tile", K_TILES)
@pytest.mark.parametrize("case", ["scene", "synthetic"])
def test_slot_rows_bit_exact_with_jax(scene, case, k_tile):
    attrs, sg, starts, capped, n_tiles, dead = _slot_case(case, k_tile, scene)
    j_gidx, j_rows = _jax_slot_rows(attrs, sg, starts, capped, n_tiles,
                                    k_tile, dead)
    before = dict(rc.launches)
    gidx, rows = rc.slot_rows(*_torch_args(attrs, sg, starts, capped,
                                           n_tiles, dead, k_tile))
    assert rc.launches == before                  # the CPU launches nothing
    assert gidx.dtype == torch.int32 and rows.dtype == torch.float32
    assert rows.shape == (n_tiles, k_tile, plain.A)
    np.testing.assert_array_equal(gidx.numpy(), j_gidx)
    assert np.array_equal(rows.numpy().view(np.uint32),
                          j_rows.view(np.uint32))
    assert (j_gidx >= dead).any()
    if case == "synthetic":     # empty tiles, and tiles the lists cap
        assert (capped == 0).any() and (np.diff(starts) > k_tile).any()


def _slot_rows_grads(case, k_tile, scene):
    """The table, the lists, a seeded cotangent of the rows, and the
    gradient of the table through ``_SlotRows``."""
    attrs, sg, starts, capped, n_tiles, dead = _slot_case(case, k_tile, scene)
    args = _torch_args(attrs, sg, starts, capped, n_tiles, dead, k_tile,
                       requires_grad=True)
    rows, gidx = rc._SlotRows.apply(*args)
    assert not gidx.requires_grad
    g = torch.tensor(np.random.default_rng(1).normal(size=rows.shape)
                     .astype(np.float32))
    (grad,) = torch.autograd.grad(rows, args[0], g)
    return args[0], gidx, g, grad


@pytest.fixture
def one_thread():
    """PyTorch's CPU scatter-add sums colliding rows in an order that
    depends on its threads; with one thread both backwards sum in index
    order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("k_tile", K_TILES)
@pytest.mark.parametrize("case", ["scene", "synthetic"])
def test_slot_rows_backward_equals_index_backward(scene, one_thread, case,
                                                  k_tile):
    attrs, gidx, g, grad = _slot_rows_grads(case, k_tile, scene)
    (want,) = torch.autograd.grad(attrs[gidx], attrs, g)
    assert torch.equal(grad, want)
    assert float(grad[-plain.DEAD_SPREAD:].abs().max()) > 0


@pytest.mark.parametrize("case", ["scene", "synthetic"])
def test_slot_rows_backward_matches_jax_vjp(scene, case):
    attrs, gidx, g, grad = _slot_rows_grads(case, 512, scene)
    ji = jnp.asarray(gidx.numpy())
    _, vjp = jax.vjp(lambda a: a[ji], jnp.asarray(attrs.detach().numpy()))
    (want,) = vjp(jnp.asarray(g.numpy()))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), atol=5e-6,
                               rtol=0)


def _meta(shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _cpu(shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype)


_CFG = RasterizeConfig()
_ROWS = (6, 512, 16)
_STACK = (6, 8, 1024)
_FAULTS = {
    "check_dtype": (lambda: cuda_build.check_tensor(
        _cpu(_ROWS, torch.float64), "attrs", torch.float32, _ROWS),
        "attrs: want contiguous torch.float32"),
    "check_shape": (lambda: cuda_build.check_tensor(
        _cpu((6, 256, 16), torch.float32), "attrs", torch.float32, _ROWS),
        r"attrs: want .* \(6, 512, 16\), got torch.float32 \(6, 256, 16\)"),
    "check_layout": (lambda: cuda_build.check_tensor(
        _cpu((6, 16, 512), torch.float32).transpose(1, 2), "attrs",
        torch.float32, _ROWS), "attrs: want .* got non-contiguous"),
    "on_cuda_mix": (lambda: cuda_build.on_cuda(_cpu(4), _meta(4)),
                    "devices"),
    "slot_rows_devices": (lambda: rc.slot_rows(
        _cpu((552, 16), torch.float32), _meta(64), _meta(8), _meta(8), 8,
        128, 40), "devices"),
    "slot_lists_devices": (lambda: rc.slot_lists(
        _meta(64), _cpu(8), _meta(8), 8, 128, 0), "devices"),
    "forward_tiles_devices": (lambda: rc.forward_tiles(
        _meta(6), _meta(6), _cpu(_ROWS, torch.float32), 32, 32, 512, 64, 3,
        _CFG), "devices"),
    "backward_tiles_devices": (lambda: rc.backward_tiles(
        _cpu(6), _meta(6), _meta(_ROWS, torch.float32),
        _meta(_STACK, torch.float32), _meta(_STACK, torch.float32), 32, 32,
        512, 64, 3, _CFG), "devices"),
    "variant_devices": (lambda: anatomy.variant(
        "full", _meta(6), _cpu(6), _meta(_ROWS, torch.float32), 32, 32, 512,
        128, 3, _CFG), "devices"),
    "bf16_probe_devices": (lambda: anatomy.bf16_probe(
        _meta(_ROWS, torch.bfloat16)), "devices"),
    "compile_smoke_devices": (lambda: cuda_build.compile_smoke(
        _meta((8, 128), torch.float32)), "devices"),
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_launch_path_rejects(fault):
    """The launch path raises on a tensor a kernel does not take, before any
    launch: the argument check on a wrong dtype, shape or layout, and every
    wrapper on tensors that are neither all on the CPU nor all on CUDA."""
    call, match = _FAULTS[fault]
    before = {**rc.launches, **anatomy.launches, **cuda_build.launches}
    with pytest.raises(ValueError, match=match):
        call()
    assert before == {**rc.launches, **anatomy.launches, **cuda_build.launches}


def test_on_cuda_dispatch():
    """``on_cuda`` is False when every tensor lies on the CPU (the wrappers
    then run their plain versions), whatever their dtypes and shapes."""
    assert cuda_build.on_cuda(_cpu(4), _cpu((2, 3), torch.float64)) is False
    x = _cpu(4, torch.float32)
    cuda_build.check_tensor(x, "x", torch.float32, (4,))
