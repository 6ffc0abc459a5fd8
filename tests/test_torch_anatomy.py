"""Parity of the port's profiling path on the CPU: the K5 forward ablations,
the K6 bf16 probe, K2 without its early exit, the roofline models and
``measure``, against the JAX package on the same numpy inputs.

``make_variant`` and ``bf16_probe.make`` are closures inside
``tools/exp_kernel_anatomy.py``, so ``_jax_variant`` and ``_jax_probe``
below rebuild them from its lines 78-135 and 188-213, run in interpret
mode.  Tolerances and their reasons:

- K5, every mode: 3e-5 of the tile's largest output.  The port multiplies
  the transmittance entry by entry, the JAX kernel by a Hillis-Steele
  prefix product, and the two sum in other orders: float32 rounding only.
- K6 f32: 1e-5 of the tile's largest output (summation order only).
- K6 bf16: 2^-6 of the tile's largest output.  Both round every operation
  to bf16 (8-bit significand, 2^-8 relative), but the JAX package's CPU
  program evaluates exp2 as exp(x·ln2) with ln2 rounded to bf16 and the
  product rounded again, up to a few bf16 ulps per α; the sums of
  positive α keep that relative size.
- K2 without the exit: rgb/acc/T 3e-5 and depth 3e-4, as the JAX package
  holds its own kernel; ``chunks_done`` equal.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.ops import rasterize_pallas as rp
from touchgs_tpu.utils import profiling as jprof
from touchgs_torch.ops import anatomy, cuda_build
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.tools import exp_kernel_anatomy as tool
from touchgs_torch.tools import profile_bench
from touchgs_torch.utils import profiling as tprof

from tests.test_torch_cuda import saturating_tiles
from tests.test_torch_rasterize import (  # noqa: F401  (fixtures)
    K_CHUNK, N_TILES, N_TX, _renders, scene, tile_cases)

TH = TW = 32
KC = 128                 # the anatomy's chunk
SAT_TILES = 4            # the first saturating tiles: 2..5 chunks of 64


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax_variant(mode, nc, tids, at, n_tx, k_tile, k_chunk, th=TH, tw=TW):
    """``make_variant(mode)`` of tools/exp_kernel_anatomy.py:78-135, for
    th x tw tiles."""
    rcfg = jcfg.RasterizeConfig(use_pallas=True)
    npix = th * tw
    n_tiles = at.shape[0]
    n_chunks = k_tile // k_chunk

    def kernel(nc_ref, tid_ref, attr_ref, out_ref):
        tid = tid_ref[pl.program_id(0)]
        ox = ((tid % n_tx) * tw).astype(jnp.float32)
        oy = ((tid // n_tx) * th).astype(jnp.float32)
        px, py = rp._pixel_rows(th, tw)

        def body(c, carry):
            outs, T = carry
            attr_c = attr_ref[0, pl.ds(c * k_chunk, k_chunk), :]
            if mode == "noexp":
                mx = attr_c[:, 0:1] - ox
                my = attr_c[:, 1:2] - oy
                ca, cb, cc = attr_c[:, 2:3], attr_c[:, 3:4], attr_c[:, 4:5]
                op = attr_c[:, 5:6]
                dx = px - mx; dy = py - my
                sigma = ca * dx * dx + cc * dy * dy + cb * dx * dy
                expns = 1.0 - 0.25 * sigma
                alpha = jnp.minimum(rcfg.alpha_clip, op * expns)
                keep = (sigma >= 0) & (alpha >= rcfg.alpha_threshold)
                alpha = jnp.where(keep, alpha, 0.0)
            else:
                alpha, _ = rp._alpha_exact(attr_c, px, py, ox, oy, rcfg)
            if mode == "alpha_only" or mode == "noexp":
                outs = outs + jnp.sum(alpha, axis=0, keepdims=True)
                return outs, T
            om = 1.0 - alpha
            cprod = rp._exclusive_prefix_prod(om)
            w = (T * cprod) * alpha
            if mode == "no_mxu":
                outs = outs + jnp.sum(w, axis=0, keepdims=True)
            else:
                V = rp._values(attr_c)
                outs8 = rp._mm_tn(V, w)
                outs = outs + outs8[4:5]
            T = T * (cprod[k_chunk - 1:] * om[k_chunk - 1:])
            return outs, T

        init = (jnp.zeros((1, npix), jnp.float32),
                jnp.ones((1, npix), jnp.float32))
        outs, T = jax.lax.fori_loop(
            0, jnp.minimum(nc_ref[pl.program_id(0)], n_chunks), body, init)
        out_ref[0, 0:1, :] = outs
        out_ref[0, 1:2, :] = T

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(n_tiles,),
        in_specs=[pl.BlockSpec((1, k_tile, 16),
                               lambda t, nc, tid: (t, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 2, npix), lambda t, nc, tid: (t, 0, 0),
                               memory_space=pltpu.VMEM),
    )
    f = pl.pallas_call(kernel, grid_spec=grid_spec, interpret=True,
                       out_shape=jax.ShapeDtypeStruct((n_tiles, 2, npix),
                                                      jnp.float32))
    return np.asarray(f(jnp.asarray(nc), jnp.asarray(tids), jnp.asarray(at)))


def _jax_probe(dtype, at):
    """``bf16_probe``'s ``make(dtype)`` of tools/exp_kernel_anatomy.py:188-213,
    for ``at.shape[0]`` tiles."""
    kc, npix, n_chunks = 128, 1024, 4
    n_tiles = at.shape[0]

    def kernel(attr_ref, out_ref):
        px = jax.lax.broadcasted_iota(jnp.int32, (1, npix), 1).astype(dtype)
        py = px * dtype(0.5)
        acc = jnp.zeros((1, npix), dtype)
        for c in range(n_chunks):
            a = attr_ref[0, pl.ds(c * kc, kc), :]
            mx, my = a[:, 0:1], a[:, 1:2]
            ca, cb, cc, op = a[:, 2:3], a[:, 3:4], a[:, 4:5], a[:, 5:6]
            dx = px - mx; dy = py - my
            sig = ca * dx * dx + cc * dy * dy + cb * dx * dy
            e = jnp.exp2(-sig)
            al = jnp.minimum(dtype(0.999), op * e)
            al = jnp.where((sig >= 0) & (al >= dtype(1/255.)), al, dtype(0))
            acc = acc + jnp.sum(al, axis=0, keepdims=True)
        out_ref[0] = acc.astype(jnp.float32).reshape(1, npix)

    f = pl.pallas_call(
        kernel, grid=(n_tiles,), interpret=True,
        in_specs=[pl.BlockSpec((1, kc * n_chunks, 16), lambda t: (t, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1, npix), lambda t: (t, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_tiles, 1, npix), jnp.float32))
    return np.asarray(f(jnp.asarray(at).astype(dtype)))


@pytest.fixture(scope="module")
def anatomy_tiles():
    """Tile sets at k_chunk 128, as (attrs, n_chunks, n_tx, k_tile, th, tw):
    the anatomy's own inputs, built by the port's tool on the CPU at 64x64
    (4 tiles of 32x32), and saturating tiles whose lists run 1 to 3 chunks
    of 128, made for 32x32, 8x8 and 4x8 tiles (the shapes that run 4, 2 and
    1 pixels a thread on the card)."""
    x = tool.anatomy_inputs(device="cpu", width=64, height=64, n=3000,
                            capacity=4096)
    tiles = {"anatomy": (x.at.numpy(), x.nc.numpy(), x.geom[4], x.geom[2],
                         TH, TW)}
    for case, (th, tw) in (("saturating", (TH, TW)),
                           ("saturating_8x8", (8, 8)),
                           ("saturating_4x8", (4, 8))):
        at, counts = saturating_tiles(th=th, tw=tw)
        at = at[:SAT_TILES]
        nc = ((counts[:SAT_TILES] + KC - 1) // KC).astype(np.int32)
        tiles[case] = (at, nc, N_TX, at.shape[1], th, tw)
    return tiles


def _rel_err(t, j):
    """Largest |port − JAX| of each tile over the tile's largest |JAX|."""
    scale = np.maximum(np.abs(j).max(axis=(1, 2)), 1e-30)
    return float((np.abs(t - j).max(axis=(1, 2)) / scale).max())


@pytest.mark.parametrize("mode", anatomy.MODES)
@pytest.mark.parametrize("case", ["anatomy", "saturating", "saturating_8x8",
                                  "saturating_4x8"])
def test_variant_matches_jax(anatomy_tiles, mode, case):
    at, nc, n_tx, k_tile, th, tw = anatomy_tiles[case]
    tids = np.arange(at.shape[0], dtype=np.int32)
    j = _jax_variant(mode, nc, tids, at, n_tx, k_tile, KC, th, tw)
    t = anatomy.variant(mode, _t(nc), _t(tids), _t(at), th, tw, k_tile, KC,
                        n_tx, tcfg.RasterizeConfig()).numpy()
    assert t.shape == (at.shape[0], 2, th * tw)
    assert np.abs(j[:, 0]).max() > 0.1
    err = _rel_err(t, j)
    print(f"K5 {mode} {case}: max |port - JAX| / tile max {err:.3e}")
    assert err <= 3e-5
    if mode in ("alpha_only", "noexp"):
        assert (t[:, 1] == 1).all()


def _comment_counts(source: str, names) -> dict:
    """{name: N} from the header comment lines ``//   <name>: ... = N`` of
    ``touchgs_torch/csrc/<source>``, with each line's text."""
    text = (Path(anatomy.__file__).parent.parent / "csrc" / source).read_text()
    found = {}
    for m in re.finditer(r"^//\s+(\w+):(.*)=\s*(\d+)\s*$", text, re.M):
        if m.group(1) in names:
            found[m.group(1)] = (int(m.group(3)), m.group(2))
    assert set(found) == set(names), (source, found)
    return found


def test_op_counts_match_kernel_comments():
    """The operation counts that the bounds use are the ones counted in the
    kernels' header comments; the probe's chain adds up item by item."""
    k5 = _comment_counts("anatomy_variants.cu", anatomy.MODES)
    assert {m: n for m, (n, _) in k5.items()} == anatomy.OPS_PER_PAIR
    k6 = _comment_counts("bf16_probe.cu", ("chain", "sum"))
    assert (k6["chain"][0], k6["sum"][0]) == (anatomy.PROBE_CHAIN_OPS,
                                            anatomy.PROBE_SUM_OPS)
    items = [int(i.split()[-1]) for i in k6["chain"][1].split(";")]
    assert sum(items) == anatomy.PROBE_CHAIN_OPS, items
    # the ablations differ by the pieces they drop
    assert (anatomy.OPS_PER_PAIR["full"] - anatomy.OPS_PER_PAIR["no_mxu"]
            == 8)  # four FMAs
    assert anatomy.OPS_PER_PAIR["alpha_only"] == anatomy.OPS_PER_PAIR["noexp"]


def test_anatomy_inputs_match_jax_chunk_counts():
    """The tool's chunk counts come from tile counts that the port bins
    bit-exact; here against the JAX package's binning of the same state."""
    from touchgs_tpu.data.cameras import Camera
    from touchgs_tpu.models.gaussians import init_random
    from touchgs_tpu.ops.projection import project_gaussians
    from touchgs_tpu.ops.tiles import bin_gaussians

    W = H = 64
    x = tool.anatomy_inputs(device="cpu", width=W, height=H, n=3000,
                            capacity=4096)
    rcfg = jcfg.RasterizeConfig(use_pallas=True)
    p = init_random(n=3000, capacity=4096, sh_degree=3)
    cam = Camera(fx=jnp.float32(0.9 * W), fy=jnp.float32(0.9 * W),
                 cx=jnp.float32(W / 2), cy=jnp.float32(H / 2),
                 c2w=jnp.asarray([[1.0, 0, 0, 0], [0, 1, 0, 0],
                                  [0, 0, 1, 2.5], [0, 0, 0, 1]], jnp.float32),
                 width=W, height=H)
    proj = project_gaussians(p.means, p.quats, p.scales(), cam.w2c, cam.fx,
                             cam.fy, cam.cx, cam.cy, W, H, rcfg,
                             extra_valid=p.alive, opacities=p.opacities())
    bins = bin_gaussians(proj, W, H, rcfg)
    nc = (jnp.minimum(bins.tile_counts, rcfg.k_tile) + 127) // 128
    np.testing.assert_array_equal(x.nc.numpy(), np.asarray(nc))
    assert x.full_entries == int(np.asarray(nc).sum()) * 128 > 0


@pytest.mark.parametrize("spread", [False, True], ids=["uniform", "spread"])
@pytest.mark.parametrize("leg", ["f32", "bf16"])
def test_bf16_probe_matches_jax(leg, spread):
    """The uniform rows light only the first pixels of a tile; the spread
    rows light nearly every 8-pixel group."""
    probe = tool.probe_inputs(n_tiles=2, device="cpu", spread=spread)
    at32 = probe["f32"].numpy()
    t = anatomy.bf16_probe(probe[leg]).numpy()
    j = _jax_probe(jnp.float32 if leg == "f32" else jnp.bfloat16, at32)
    assert t.shape == (2, 1, 1024) and t.dtype == np.float32
    if spread:
        assert (j.reshape(2, -1, 8) > 0).any(-1).mean() > 0.97
    else:
        assert j.max() > 100
    err = _rel_err(t, j)
    print(f"K6 {leg}: max |port - JAX| / tile max {err:.3e}")
    assert err <= (1e-5 if leg == "f32" else 2.0 ** -6)


def test_bf16_probe_rounds_in_bf16():
    """The bf16 leg's chunk sums are rounded to bf16: its output differs
    from the f32 leg's by far more than f32 rounding."""
    probe = tool.probe_inputs(n_tiles=1, device="cpu")
    f32 = anatomy.bf16_probe(probe["f32"])
    bf = anatomy.bf16_probe(probe["bf16"])
    assert float((bf - f32).abs().max()) > 1e-3 * float(f32.max())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        anatomy.bf16_probe(probe["f32"].double())


@pytest.mark.parametrize("case", ["scene", "saturating"])
def test_forward_tiles_without_exit_matches_jax(tile_cases, case):
    at, nc = tile_cases[case]
    tids = np.arange(N_TILES, dtype=np.int32)
    k_tile = at.shape[1]
    j = np.asarray(rp._forward_tiles(
        jnp.asarray(nc), jnp.asarray(tids), jnp.asarray(at), TH, TW, k_tile,
        K_CHUNK, N_TX, jcfg.RasterizeConfig(), True, early_exit=False))
    t = rc.forward_tiles(_t(nc), _t(tids), _t(at), TH, TW, k_tile, K_CHUNK,
                         N_TX, tcfg.RasterizeConfig(),
                         early_exit=False).numpy()
    done = t[:, plain.ROW_DONE, 0]
    np.testing.assert_array_equal(t[:, plain.ROW_DONE], j[:, plain.ROW_DONE])
    np.testing.assert_array_equal(done, np.minimum(nc, k_tile // K_CHUNK))
    for r in (0, 1, 2, 4, plain.ROW_T):
        np.testing.assert_allclose(t[:, r], j[:, r], atol=3e-5, err_msg=r)
    np.testing.assert_allclose(t[:, 3], j[:, 3], atol=3e-4)
    if case == "saturating":  # the exit would have stopped these tiles
        with_exit = rc.forward_tiles(_t(nc), _t(tids), _t(at), TH, TW, k_tile,
                                     K_CHUNK, N_TX, tcfg.RasterizeConfig())
        assert (with_exit[:, plain.ROW_DONE, 0].numpy() < done).any()


def test_rasterize_cuda_without_exit_matches_pallas(scene):
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jout, jg, tout, tg = _renders(scene, bg, early_exit=False)
    np.testing.assert_allclose(tout.rgb.detach().numpy(), np.asarray(jout.rgb),
                               atol=3e-5)
    np.testing.assert_allclose(tout.acc.detach().numpy(), np.asarray(jout.acc),
                               atol=3e-5)
    np.testing.assert_allclose(tout.depth.detach().numpy(),
                               np.asarray(jout.depth), atol=3e-4)
    for a, b, name in zip(tg, jg, ("means2d", "colors", "opacities")):
        assert np.abs(np.asarray(b)).max() > 0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-6,
                                   err_msg=f"grad {name}")


def _jax_chip(chip: tprof.ChipSpec) -> jprof.ChipSpec:
    return jprof.ChipSpec(
        name=chip.name, peak_flops_f32=chip.peak_flops_f32,
        peak_flops_bf16=chip.peak_flops_bf16,
        peak_flops_vpu=chip.peak_flops_vpu,
        vpu_sustained=chip.vpu_sustained, hbm_bw=chip.hbm_bw)


def test_roofline_models_match_jax():
    chip = tprof.ChipSpec(name="card", peak_flops_f32=67e12,
                          peak_flops_bf16=989e12, peak_flops_vpu=67e12,
                          vpu_sustained=21.5e12, hbm_bw=3.35e12)
    jchip = _jax_chip(chip)
    pairs = [
        (tprof.composite_cost(203_136, 1024, 625),
         jprof.composite_cost(203_136, 1024, 625)),
        (tprof.composite_cost(203_136, 1024, 625, name="composite_bwd",
                              flops_per_pair=76),
         jprof.composite_cost(203_136, 1024, 625, name="composite_bwd",
                              flops_per_pair=76)),
        (tprof.binning_cost(100_000, 16), jprof.binning_cost(100_000, 16)),
        (tprof.StageCost("sort", 1e9, 2e8), jprof.StageCost("sort", 1e9, 2e8)),
    ]
    for t, j in pairs:
        assert (t.name, t.flops, t.bytes_accessed, t.unit) == (
            j.name, j.flops, j.bytes_accessed, j.unit)
        assert t.arithmetic_intensity() == j.arithmetic_intensity()
        assert t.roofline_time(chip) == j.roofline_time(jchip)
        assert t.practical_time(chip) == j.practical_time(jchip)
    measured = {"composite_fwd": 3.59e-4, "binning": 1.2e-3}
    assert (tprof.report([t for t, _ in pairs], measured, chip)
            == jprof.report([j for _, j in pairs], measured, jchip))


def test_h100_spec_has_no_tpu_figure():
    h = tprof.H100
    assert (h.peak_flops_f32, h.peak_flops_bf16, h.peak_flops_vpu,
            h.hbm_bw) == (67e12, 989e12, 67e12, 3.35e12)
    tpu = {getattr(c, f) for c in (jprof.V5E, jprof.V5P)
           for f in ("peak_flops_f32", "peak_flops_bf16", "peak_flops_vpu",
                     "vpu_sustained", "hbm_bw")}
    assert not tpu & {h.peak_flops_f32, h.peak_flops_bf16, h.peak_flops_vpu,
                      h.vpu_sustained, h.hbm_bw}
    assert 0 < h.vpu_sustained <= h.peak_flops_vpu


def test_measure_refuses_the_cpu():
    with pytest.raises(ValueError, match="card"):
        tprof.measure(lambda a: a * 2, torch.ones(4))
    with pytest.raises(ValueError, match="card"):
        tprof.measure(lambda d: d, {"x": [torch.ones(2)]})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tprof.measure(lambda: None)


def test_compile_smoke_plain():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    out = cuda_build.compile_smoke(x)
    assert torch.equal(out, 2 * x)
    assert cuda_build.launches["compile_smoke"] == 0   # nothing launched


def test_tools_refuse_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools would time it")
    assert tool.main(["--bf16"]) == 1
    assert profile_bench.main() == 1
    assert "needs a CUDA device" in capsys.readouterr().err


def test_profile_bench_stages_run_on_the_cpu():
    """Each stage of the stage profiler, once, at 64x64: finite results."""
    n = 400
    stages = profile_bench.build_stages(device="cpu", width=64, height=64,
                                        n=n, capacity=512)
    assert [s[0] for s in stages] == [
        "step:", "graphed:", "gather:", "fwd:", "fwd+bwd:", "ssim+grad:",
        "adam:", "scatter:", "sh+grad:", "loss+grad:", "project:", "bin:"]
    for name, fn, args in stages:
        out = fn(*args)
        # the dead slots hold zero quaternions, whose gradients and updates
        # are not finite: check the step's metrics and the live slots
        if name in ("step:", "graphed:"):
            out = out[1]
        elif name == "loss+grad:":
            out = [g[:n] for g in out]
        leaves = list(tprof._tensors(out))
        assert leaves and all(bool(torch.isfinite(v).all()) for v in leaves
                              if v.is_floating_point()), name
