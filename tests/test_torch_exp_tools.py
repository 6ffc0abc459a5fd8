"""The experiment tools under ``touchgs_torch/tools/exp_*.py`` on the CPU,
at a small size.

The tools time their candidates on the card only; here their computing
functions run on the CPU and are held against the JAX package's own
functions on the same numpy inputs:

- the SH variants (per-coefficient, channel-major, 2-D) against
  ``touchgs_tpu.ops.sh.eval_sh`` and its gradient;
- Adam on flat 1-D views against ``touchgs_tpu.train.optim``'s update;
- the gradient-reduction candidates B, B′ and D against the duplicate
  scatter-add A, within float32 summation-order tolerance; the scatter-add
  with out-of-range rows masked against JAX's ``.at[].add``, which drops
  them, exactly (integer-valued data, so no order of the sums rounds);
- the sort variants: keys in order and each key's values as a set;
- the chained timer's arithmetic, and every tool's ``main`` exiting 1
  without a card; the kernel rows and the tile sweep's scene at 64x64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
from touchgs_tpu.ops.sh import eval_sh as j_eval_sh
from touchgs_tpu.train.optim import make_optimizer
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.tools import (exp_common, exp_kernels, exp_kernels2,
                                 exp_scatter, exp_scatter2, exp_tail,
                                 exp_tail2, exp_tail3, exp_tile_size)
from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam

TOOLS = (exp_tile_size, exp_kernels, exp_kernels2, exp_scatter,
         exp_scatter2, exp_tail, exp_tail2, exp_tail3)
C_SH = 257


def _sh_inputs(seed=0):
    rng = np.random.default_rng(seed)
    dc = rng.normal(size=(C_SH, 3)).astype(np.float32)
    rest = (0.3 * rng.normal(size=(C_SH, 15, 3))).astype(np.float32)
    d = rng.normal(size=(C_SH, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return dc, rest, d


@pytest.mark.parametrize("variant", ["old", "cm", "2d"])
def test_sh_variants_match_jax(variant):
    """Forward within 2e-6 and the gradients of the sum with respect to
    the coefficients within 1e-6 of JAX's ``eval_sh`` (float32 sums of
    16 terms in another order)."""
    dc, rest, d = _sh_inputs()
    fn = {"old": exp_tail.eval_sh_old, "cm": exp_tail.eval_sh_cm,
          "2d": exp_tail.eval_sh_2d}[variant]

    def j_fn(dc, rest):
        return j_eval_sh(jnp.concatenate([dc[:, None, :], rest], axis=1),
                         jnp.asarray(d), 3, 3)

    want = np.asarray(j_fn(dc, rest))
    j_g = jax.grad(lambda a, b: jnp.sum(j_fn(a, b)), argnums=(0, 1))(dc, rest)
    t = [torch.from_numpy(a) for a in (dc, rest, d)]
    got = fn(*t).numpy()
    g = exp_tail.sh_grad(fn, *t)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    for a, b in zip(g, j_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    x = dict(dc=t[0], rest=t[1], dirs=t[2])
    assert exp_tail.sh_parity(fn, x) <= 1e-6


def test_adam_flat_matches_jax_update():
    """Three steps of ``adam_flat`` (the means' rate from the schedule at
    the pre-increment count, as JAX's) against JAX's fused Adam, and
    ``FusedAdam.step`` beside it, within 1e-7 + 1e-6 relative."""
    rng = np.random.default_rng(1)
    shapes = {"means": (40, 3), "quats": (40, 4), "log_scales": (40, 3),
              "logit_opacities": (40,), "sh_dc": (40, 3),
              "sh_rest": (40, 15, 3)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    opt = make_optimizer(jcfg.OptimConfig())
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = opt.init(jp)
    for g in grads:
        u, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = {k: jp[k] + u[k] for k in jp}

    fused = FusedAdam(exp_tail.OptimConfig())
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    st = fused.init(tp)
    op = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ost = fused.init(op)
    for g in grads:
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        lrs = dict(fused.fixed_lrs, means=fused.means_lr(st.count))
        exp_tail.adam_flat(tp, tg, st, lrs)
        fused.step(op, tg, ost)
    assert int(st.count) == 3
    for k in PARAM_GROUPS:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-7, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(op[k].numpy(), tp[k].numpy(), atol=1e-7,
                                   rtol=1e-6, err_msg=k)


def _pair_space_inputs(seed=2, n_tiles=9, k_wide=48, c=200, t_cap=16):
    """Rows and indices as ``reduction_inputs`` makes them, with each
    (tile, slot)'s pair id a free slot of its own Gaussian's t_cap, so
    that B's per-Gaussian sums are A's."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n_tiles, k_wide, exp_scatter.A)).astype(
        np.float32)
    flat = rng.integers(0, c, n_tiles * k_wide)
    used = np.zeros(c, np.int64)
    pid = np.empty_like(flat)
    for i, gi in enumerate(flat):
        assert used[gi] < t_cap
        pid[i] = gi * t_cap + used[gi]
        used[gi] += 1
    gidx = torch.as_tensor(flat.reshape(n_tiles, k_wide).astype(np.int32))
    return dict(rows=torch.from_numpy(rows), gidx=gidx,
                pid=torch.as_tensor(pid.reshape(n_tiles, k_wide)),
                order=torch.argsort(gidx.reshape(-1).long()), c=c, g=c,
                t_cap=t_cap)


@pytest.mark.parametrize("name", ["B scatter set unique",
                                  "B' scatter add unique",
                                  "D gather rows by perm"])
def test_reduction_candidates_match_duplicate_scatter(name):
    x = _pair_space_inputs()
    want = exp_scatter.scatter_add_dup(x, x["rows"])
    assert want.shape == (x["c"], exp_scatter.A)
    got = dict(exp_scatter.REDUCTIONS)[name](x, x["rows"])
    if name.startswith("D"):
        # D's rows in Gaussian order, summed over each Gaussian's run
        keys = x["gidx"].reshape(-1).long()[x["order"]]
        assert bool((keys[1:] >= keys[:-1]).all())
        got = torch.zeros_like(want).index_add_(0, keys, got)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-6)


def test_tool_reduction_inputs_at_a_small_size():
    x = exp_scatter.reduction_inputs("cpu", n_tiles=5, k_wide=20, c=64,
                                     g=32, t_cap=4)
    assert torch.unique(x["pid"]).numel() == 100
    assert int(x["pid"].max()) < 32 * 4 and int(x["gidx"].max()) < 64
    for name, fn in exp_scatter.REDUCTIONS:
        out = fn(x, x["rows"])
        assert torch.isfinite(out).all(), name


@pytest.mark.parametrize("oob", [0.0, 0.31])
@pytest.mark.parametrize("width,dtype", [(16, torch.float32), (1, torch.float32),
                                         (16, torch.bfloat16)])
def test_masked_scatter_add_equals_jax_drop(oob, width, dtype):
    """Integer-valued data, so every order of the sums is exact: the
    masked ``index_add_`` equals JAX's ``.at[].add``, which drops the rows
    whose index is out of range."""
    c = 97
    rng = np.random.default_rng(3)
    idx, data = exp_scatter2.case_inputs(rng, 2000, width, dtype, oob, c=c,
                                         device="cpu")
    data = torch.round(data * 4)
    got = exp_scatter2.scatter_add(idx, data, c)
    jd = jnp.zeros((c, width), jnp.bfloat16 if dtype == torch.bfloat16
                   else jnp.float32)
    want = jd.at[jnp.asarray(idx.numpy())].add(
        jnp.asarray(data.float().numpy()).astype(jd.dtype))
    assert got.shape == (c, width) and got.dtype == dtype
    if oob:
        assert int((idx >= c).sum()) > 500
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_sorts_as_sets_per_key():
    """Keys in order; each key's values the same multiset as numpy's;
    the stable sort exactly numpy's stable order; the uint32 keys sort as
    the int32 ones; ranks as numpy's double argsort."""
    rng = np.random.default_rng(4)
    k = rng.integers(0, 60, 3000).astype(np.int32)
    v = rng.integers(0, 1000, 3000).astype(np.int32)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    order = np.argsort(k, kind="stable")
    for stable in (False, True):
        sk, sv = exp_scatter.sort_pair(kt, vt, stable)
        np.testing.assert_array_equal(sk.numpy(), k[order])
        if stable:
            np.testing.assert_array_equal(sv.numpy(), v[order])
        for key in np.unique(k):
            assert sorted(sv.numpy()[sk.numpy() == key]) == sorted(v[k == key])
    su, _ = exp_scatter.sort_pair(kt.to(torch.uint32), vt)
    np.testing.assert_array_equal(su.to(torch.int64).numpy(), k[order])
    np.testing.assert_array_equal(exp_scatter.sort_keys(kt).numpy(), k[order])
    hk, hv = exp_tail2.sort_half(kt, vt)
    np.testing.assert_array_equal(hk.numpy(), np.sort(k[:1500]))
    kg = rng.normal(size=500).astype(np.float32)
    np.testing.assert_array_equal(
        exp_scatter.rank_double_sort(torch.from_numpy(kg)).numpy(),
        np.argsort(np.argsort(kg, kind="stable"), kind="stable"))
    s = exp_scatter.sort_inputs("cpu", m=4096, g=64)
    assert s["keys_u32"].dtype == torch.uint32
    assert torch.equal(s["keys_u32"].to(torch.int64), s["keys"].to(torch.int64))


def test_chained_timer_arithmetic():
    """(t(R) − t(1)) / (R − 1) and t(1), from a chain whose time is
    a + b·n: the per-repeat time b and the single chain a + b."""
    calls = []

    def t(n):
        calls.append(n)
        return 0.7 + 0.25 * n

    ms, t1 = exp_tail3.chain_ms(t)
    assert calls == [1, exp_tail3.R] and exp_tail3.R == 9
    assert ms == pytest.approx(0.25) and t1 == pytest.approx(0.95)
    assert exp_tail3.chain_ms(lambda n: 3.0 * n, reps=4) == (3.0, 3.0)
    # the chains themselves: a data dependency between repeats
    k = torch.arange(64, dtype=torch.int32)
    k3 = exp_tail3.sort_single_chain(k, 3)
    want = np.sort(np.sort(np.sort(np.arange(64) ^ 1) ^ 2) ^ 3)
    np.testing.assert_array_equal(k3.numpy(), want)


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.split(".")[-1])
def test_main_exits_1_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--iters", "1"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


def test_kernel_rows_and_tile_sweep_on_the_cpu():
    """The rows of ``exp_kernels`` and ``exp_kernels2`` and the tile
    sweep's forward, backward and hold run on a 64x64 bench scene of 400
    Gaussians through the plain versions."""
    x = exp_common.bench_tiles("cpu", width=64, height=64, n=400,
                               capacity=512)
    rows, fwd = exp_kernels.kernel_rows(x)
    assert list(rows) == ["slot lists", "gather real", "slot rows",
                          "fwd kernel", "bwd kernel", "scatter real"]
    for name, (fn, args) in rows.items():
        out = fn(*args)
        assert out is not None, name
    assert rows["scatter real"][0](*rows["scatter real"][1]).shape == \
        x["attrs"].shape
    assert float(fwd[:, plain.ROW_DONE, 0].max()) >= 1
    names = list(exp_kernels2.rows(x))
    assert names == ["fwd kc=128 ee=True", "fwd kc=128 ee=False",
                     "bwd kc=128", "fwd kc=256 ee=True",
                     "fwd kc=256 ee=False", "bwd kc=256"]
    a, b = exp_kernels.ssim_inputs("cpu", 24)
    assert exp_kernels.ssim_fwd_grad(a, b).shape == a.shape
    scene = exp_tile_size.Scene.bench("cpu", 64, 64, 400, 512)
    for geo in (exp_tile_size.GEOMETRIES[2], exp_tile_size.ODD_GEOMETRY):
        cfg = exp_tile_size.config(*geo)
        assert (cfg.tile_h, cfg.tile_w, cfg.k_tile,
                cfg.max_tiles_per_gaussian) == geo and cfg.use_pallas
        g = scene.fwd_bwd(scene.params.means, cfg)
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0
        h = exp_tile_size.hold(scene, cfg)
        assert h["ok"] and h["scanned"] > 0
