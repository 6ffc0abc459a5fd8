"""K1 with rows, ``rc.slot_rows``, against the JAX package, and the kernel
wrappers' launch path.

``rc.slot_rows`` on the CPU (its plain version) against the JAX package's
``_slot_lists`` in interpret mode followed by its gather ``attrs[gidx]``,
bit for bit on both the lists and the rows; ``_SlotRows``'s backward
against PyTorch's own backward of ``attrs[gidx]`` (equal) and against
``jax.vjp`` of the gather (the gradient tolerance, 5e-6).  Two inputs: the
tiles of the 300-Gaussian scene of ``tests/test_torch_rasterize.py``, and
``synthetic_slots``, with empty tiles and tiles that hold more than k_tile
entries.  On the CPU ``rc.scatter_rows``, that backward, is PyTorch's
scatter-add of every slot bit for bit; the card's kernel adds the live
slots alone, and its design written out in plain PyTorch
(``scatter_live_rows_plain``) equals the same VJP bit for bit on the rows
below the dead ones.

The launch path's checks: ``cuda_build.check_tensor`` on a wrong dtype,
shape or layout, and every wrapper on a mix of devices (meta tensors
beside CPU ones); ``cuda_build.launch``'s count, its per-stream redirect
and its error, with the launcher and the stream stubbed.  The kernels on the card are held against these plain
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


# the most live slots one row of the lists takes: its tiles' cap
WIDTH = RasterizeConfig().max_tiles_per_gaussian


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
    before = dict(cuda_build.launches)
    gidx, rows = rc.slot_rows(*_torch_args(attrs, sg, starts, capped,
                                           n_tiles, dead, k_tile))
    assert cuda_build.launches == before          # the CPU launches nothing
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
    rows, gidx = rc._SlotRows.apply(*args, WIDTH)
    assert not gidx.requires_grad
    g = torch.tensor(np.random.default_rng(1).normal(size=rows.shape)
                     .astype(np.float32))
    (grad,) = torch.autograd.grad(rows, args[0], g)
    return args[0], gidx, g, grad, args[3]


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
    attrs, gidx, g, grad, _ = _slot_rows_grads(case, k_tile, scene)
    (want,) = torch.autograd.grad(attrs[gidx], attrs, g)
    assert torch.equal(grad, want)
    assert float(grad[-plain.DEAD_SPREAD:].abs().max()) > 0


@pytest.mark.parametrize("k_tile", K_TILES)
@pytest.mark.parametrize("case", ["scene", "synthetic"])
def test_scatter_rows_on_the_cpu_is_index_put(scene, one_thread, case,
                                               k_tile):
    """On the CPU ``rc.scatter_rows`` is PyTorch's scatter-add of every
    slot, the dead ones too, the call ``index_put_`` makes, bit for bit,
    and launches nothing."""
    attrs, gidx, g, _, counts = _slot_rows_grads(case, k_tile, scene)
    want = torch.zeros(attrs.shape)
    torch.ops.aten._index_put_impl_(want, (gidx,), g, accumulate=True,
                                    unsafe=True)
    dead = attrs.shape[0] - plain.DEAD_SPREAD
    before = dict(cuda_build.launches)
    got = rc.scatter_rows(g, gidx, counts, dead, WIDTH)
    assert cuda_build.launches == before
    assert torch.equal(got, want)
    assert float(got[dead:].abs().max()) > 0


@pytest.mark.parametrize("k_tile", K_TILES)
@pytest.mark.parametrize("case", ["scene", "synthetic"])
def test_live_rows_mirror_equals_index_backward(scene, one_thread, case,
                                                k_tile):
    """The scatter kernel's design in plain PyTorch
    (``scatter_live_rows_plain``: the live slots alone, each row's in
    ascending slot order, summed from +0.0) equals ``attrs[gidx]``'s VJP
    bit for bit on every row < dead, and is zero on the dead rows."""
    attrs, gidx, g, want, counts = _slot_rows_grads(case, k_tile, scene)
    dead = attrs.shape[0] - plain.DEAD_SPREAD
    got = plain.scatter_live_rows_plain(g, gidx, counts, dead, WIDTH)
    assert got.shape == want.shape
    assert torch.equal(got[:dead], want[:dead])
    assert not bool(got[dead:].any())
    assert float(want[dead:].abs().max()) > 0    # the dead slots did add
    live = int(counts.sum())
    assert 0 < live < gidx.numel()


def test_live_rows_mirror_rejects_a_row_past_width():
    """A row in more live slots than ``width``, or a live slot naming a row
    ≥ dead, raises in the plain design, where the kernel traps."""
    gidx = torch.tensor([[3, 5], [3, 7], [3, 6]], dtype=torch.int32)
    counts = torch.tensor([2, 1, 1], dtype=torch.int32)
    g = torch.ones((3, 2, plain.A))
    out = plain.scatter_live_rows_plain(g, gidx, counts, 6, 3)
    assert out[3, 0] == 3 and out[5, 0] == 1 and not bool(out[6:].any())
    with pytest.raises(ValueError, match="more than width=2"):
        plain.scatter_live_rows_plain(g, gidx, counts, 6, 2)
    with pytest.raises(ValueError, match=r"outside \[0, 5\)"):
        plain.scatter_live_rows_plain(g, gidx, counts, 5, 3)


@pytest.mark.parametrize("case", ["scene", "synthetic"])
def test_slot_rows_backward_matches_jax_vjp(scene, case):
    attrs, gidx, g, grad, _ = _slot_rows_grads(case, 512, scene)
    ji = jnp.asarray(gidx.numpy())
    _, vjp = jax.vjp(lambda a: a[ji], jnp.asarray(attrs.detach().numpy()))
    (want,) = vjp(jnp.asarray(g.numpy()))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), atol=5e-6,
                               rtol=0)


@pytest.mark.parametrize("layout", ["view", "shards3", "two_scenes"])
def test_dead_rows_gradient_reaches_no_parameter(monkeypatch, one_thread,
                                                 layout):
    """Whatever the table's dead rows' gradient holds (the card's scatter
    kernel leaves it zero, PyTorch's scatter-add sums the dead slots into
    it), a render's parameter gradients are the same: with those rows
    poisoned (NaN) they are unchanged bit for bit, since no reader takes
    them (the dead rows' concatenation drops them), for one view, its grid
    in 3 slices (K1's ``tile0`` 0, 2, 4) and two scenes' packed grid."""
    from tests.test_torch_cuda import N as n_gauss
    from tests.test_torch_cuda import layout_grads

    want = layout_grads(layout, "cpu")
    scatter, calls = rc.scatter_rows, []

    def dead_rows_poisoned(grad_rows, gidx, counts, dead, w):
        out = scatter(grad_rows, gidx, counts, dead, w)
        out[dead:] = float("nan")
        calls.append(dead)
        return out

    monkeypatch.setattr(rc, "scatter_rows", dead_rows_poisoned)
    got = layout_grads(layout, "cpu")
    assert calls == {"view": [n_gauss], "shards3": [n_gauss] * 3,
                     "two_scenes": [2 * n_gauss]}[layout]
    assert all(float(g.abs().max()) > 0 for g in want)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


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
    "scatter_rows_dtype": (lambda: rc.scatter_rows(
        _cpu(_ROWS, torch.float32), _cpu((6, 512), torch.int64), _cpu(6),
        40, 16), "gidx: want contiguous torch.int32"),
    "scatter_rows_shape": (lambda: rc.scatter_rows(
        _cpu((6, 256, 16), torch.float32), _cpu((6, 512)), _cpu(6), 40, 16),
        r"grad_rows: want .* \(6, 512, 16\), got torch.float32 "
        r"\(6, 256, 16\)"),
    "scatter_rows_counts": (lambda: rc.scatter_rows(
        _cpu(_ROWS, torch.float32), _cpu((6, 512)), _cpu(7), 40, 16),
        r"counts: want .* \(6,\)"),
    "scatter_rows_lists": (lambda: rc.scatter_rows(
        _cpu(_ROWS, torch.float32), _cpu(6 * 512), _cpu(6), 40, 16),
        r"gidx: want \(n_tiles, k_tile\)"),
    "scatter_rows_width": (lambda: rc.scatter_rows(
        _cpu(_ROWS, torch.float32), _cpu((6, 512)), _cpu(6), 40, 0),
        "want width >= 1"),
    "scatter_rows_devices": (lambda: rc.scatter_rows(
        _cpu(_ROWS, torch.float32), _meta((6, 512)), _meta(6), 40, 16),
        "devices"),
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_launch_path_rejects(fault):
    """The launch path raises on a tensor a kernel does not take, before any
    launch: the argument check on a wrong dtype, shape or layout, and every
    wrapper on tensors that are neither all on the CPU nor all on CUDA."""
    call, match = _FAULTS[fault]
    before = dict(cuda_build.launches)
    with pytest.raises(ValueError, match=match):
        call()
    assert before == dict(cuda_build.launches)


def test_on_cuda_dispatch():
    """``on_cuda`` is False when every tensor lies on the CPU (the wrappers
    then run their plain versions), whatever their dtypes and shapes."""
    assert cuda_build.on_cuda(_cpu(4), _cpu((2, 3), torch.float64)) is False
    x = _cpu(4, torch.float32)
    cuda_build.check_tensor(x, "x", torch.float32, (4,))


def test_launch_counts_under_its_key_and_stream(monkeypatch):
    """``cuda_build.launch`` appends the current stream, counts a launch as
    its key (its name by default) in ``launches``, or in the dict that
    ``launches_on`` gave the launch's stream; a CUDA error raises and
    counts nothing; ``add_launches`` adds a graph's counts.
    ``rasterize_cuda.launches`` is the same dict."""
    import types

    calls, errors, stream = [], [0], [7]

    def fake_launcher(name, src=cuda_build.CSRC):
        return lambda *args: calls.append((name, args)) or errors[0]

    monkeypatch.setattr(cuda_build, "launcher", fake_launcher)
    monkeypatch.setattr(cuda_build, "current_stream", lambda: stream[0])
    assert rc.launches is cuda_build.launches
    before = dict(cuda_build.launches)
    cuda_build.launch("slot_lists", 1, 2, key="slot_rows")
    cuda_build.launch("composite_fwd", 3)
    assert calls == [("slot_lists", (1, 2, 7)), ("composite_fwd", (3, 7))]
    side = dict.fromkeys(cuda_build.launches, 0)
    with cuda_build.launches_on(types.SimpleNamespace(cuda_stream=9), side):
        stream[0] = 9
        cuda_build.launch("composite_bwd")
        stream[0] = 7
        cuda_build.launch("composite_bwd")
    errors[0] = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        cuda_build.launch("ssim_fwd")
    assert side == {**dict.fromkeys(side, 0), "composite_bwd": 1}
    cuda_build.add_launches(side)
    want = {**before, "slot_rows": before["slot_rows"] + 1,
            "composite_fwd": before["composite_fwd"] + 1,
            "composite_bwd": before["composite_bwd"] + 2}
    assert cuda_build.launches == want
    assert not cuda_build._redirect
    for k, n in before.items():
        cuda_build.launches[k] = n
