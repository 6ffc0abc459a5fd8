"""Build the port's CUDA kernels and drive its training step on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits nonzero with no result):

1. Card and build: the card's name and power limit, TF32 off, and the six
   kernel sources of ``touchgs_torch/csrc/`` built with nvcc for sm_90a;
   ptxas's registers per kernel, the SASS opcode counts of the compositing
   and the anatomy kernels (the `full` ablation must keep its R, G, B, D
   FMAs), K2's and K3's entry loops per (entry, pixel) pair (K3 at most 10
   SHFL per entry and thread), and K2's and K3's pixels per thread,
   threads, registers and resident blocks per SM (at least 2 for 32x32
   tiles).  Then K4, ``compile_smoke``, against its plain version, exactly.
2. Kernels against their plain PyTorch versions at the flagship shapes
   (800x800, 100k Gaussians in a capacity of 131072, SH degree 3; 625 tiles
   of 32x32, k_tile 512, k_chunk 64): K1 slot lists bit-exact; K2 forward,
   with its early exit and without, within rgb/acc 3e-5 and depth 3e-4 with
   equal chunks_done (without the exit: min(n_chunks, k_tile/k_chunk)) and
   an equal T row; K3 backward within rtol 1e-4 / atol 1e-5 on a seeded
   random cotangent (it prints whether it is bit-exact, as it should be).
   Median times over CUDA events.  Then a small scene rendered through the
   tile kernels against the dense oracle.
3. The training path: ``Trainer(scene, cfg).run`` on an in-memory 4-view
   800x800 scene seeded with 100k points (capacity 131072), 5 warm-up and
   20 timed steps, with the launch counters set to 0 just before and read
   just after; then one lossless ``Trainer.render_view``.
4. Where the step's device time goes: three more steps under
   torch.profiler, the kernels by device time and the busy share.
5. The profiling path: ``python -m touchgs_torch.tools.exp_kernel_anatomy
   --bf16``'s work (K4, the flagship's tiles at k_chunk 128, K2 with and
   without its exit, the four K5 ablations, the two K6 probe legs), with
   the launch counters set to 0 just before and read just after.
6. The anatomy's kernels against their plain versions on the same inputs:
   K2 at k_chunk 128 with and without its exit (as in phase 2); each K5 mode
   within 3e-5 of each tile's largest output; K6 f32 within 1e-5 and bf16
   within 2^-6 of it.  Median times, the attribution of K2's time, the fp32
   rate alpha_only sustains and f32 against bf16.
7. One ``kernels`` JSON line (ten entries), then the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits with status 1 before doing anything.

    python3 chip_smoke.py --ab OLD_CSRC

instead builds K2 and K3 from the directory OLD_CSRC as well (an earlier
commit's ``touchgs_torch/csrc``, unpacked with ``git archive`` into a
gitignored directory such as ``.archive/``) and times the two versions in
turns at the flagship shapes (``phase_ab``).
"""
from __future__ import annotations

import json
import re
import sys
import time

import numpy as np
import torch

WIDTH = HEIGHT = 800
N_GAUSSIANS = 100_000
CAPACITY = 131_072
WARMUP_STEPS = 5
TIMED_STEPS = 20
# H100 SXM published peaks at 700 W: fp32 outside the tensor cores, bf16
# (the tensor cores' dense rate, the only bf16 rate of the published
# table), and HBM
PEAK_FP32_OPS = 67e12
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12
# fp32 operations per scanned (entry, pixel) pair, counted from the kernels
FWD_OPS_PER_PAIR = 34
BWD_OPS_PER_PAIR = 76
PROFILE_STEPS = 3   # training steps under torch.profiler, after the timed ones
PROFILE_TOP = 15    # kernels listed by device time


def bound(nbytes: float, fp32_ops: float = 0.0,
          bf16_ops: float = 0.0) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their type's peak."""
    t_ops = fp32_ops / PEAK_FP32_OPS + bf16_ops / PEAK_BF16_OPS
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times (ms) over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def look_at_c2w(eye, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """OpenGL-convention c2w (camera looks down −Z) from ``eye``."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w.astype(np.float32)


SASS_OPS = ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "MUFU.EX2",
            "SHFL", "HFMA2", "HMUL2", "HADD2", "HMNMX2", "HSET2")
# K3's shuffles per replayed entry and thread (a 5-step butterfly for each
# of its ten sums would take 50)
K3_MAX_SHFL_PER_ENTRY = 10


def sass_name(fn: str) -> str:
    """A readable name for a mangled kernel function of the libraries."""
    from touchgs_torch.ops.anatomy import MODES

    m = re.search(r"anatomy_kernelILi(\d)E", fn)
    if m:
        return f"anatomy_{MODES[int(m.group(1))]}"
    # pixels per thread as _p<P>; kernels of one pixel a thread have no P
    m = re.search(r"composite_fwd_kernelILb(\d)E(?:Li(\d)E)?", fn)
    if m:
        return ("composite_fwd" + ("" if m.group(1) == "1" else "_no_exit")
                + (f"_p{m.group(2)}" if m.group(2) else ""))
    m = re.search(r"composite_bwd_kernel(?:ILi(\d)E)?", fn)
    if m:
        return "composite_bwd" + (f"_p{m.group(1)}" if m.group(1) else "")
    m = re.search(r"probe_(f32|bf16)_kernel", fn)
    return f"bf16_probe_{m.group(1)}" if m else fn


def pick(ops) -> dict:
    """The SASS_OPS counts of a Counter of opcodes (with their variants)."""
    return {op: sum(n for k, n in ops.items()
                    if k == op or k.startswith(op + "."))
            for op in SASS_OPS}


def entry_loop(name: str, loop) -> float:
    """Print a compositing kernel's entry loop (the innermost loop holding
    every MUFU.EX2, from ``cuda_build.sass_loop_counts``) per (entry, pixel)
    pair: each of a thread's P pixels (the ``_p<P>`` of ``name``, else 1)
    takes one exp2, so MUFU.EX2 / P counts the entries of a loop copy.
    Returns its SHFL per entry and thread."""
    body = pick(loop)
    pairs = body["MUFU.EX2"]
    m = re.search(r"_p(\d)$", name)
    entries = pairs / (int(m.group(1)) if m else 1)
    counted = sum(n for op, n in body.items() if op != "SHFL")
    shfl = body["SHFL"] / entries
    print(f"    entry loop ({entries:g} entries a copy): "
          + " ".join(f"{op} {n}" for op, n in body.items() if n)
          + f"; per pair {counted / pairs:.2f} counted (SHFL aside), "
          f"{sum(loop.values()) / pairs:.2f} SASS in all; SHFL {shfl:.2f} "
          f"per entry and thread")
    return shfl


def print_sass(cuda_build) -> None:
    """Static SASS opcode counts of the compositing and the anatomy kernels,
    and K2's and K3's entry loops (``entry_loop``).  Fails if `full` lost
    its R, G, B, D accumulations (it would then time no_mxu) or K3's loop
    shuffles more than K3_MAX_SHFL_PER_ENTRY a thread per entry."""
    ffma = {}
    for lib in ("composite_fwd", "composite_bwd", "anatomy_variants",
                "bf16_probe"):
        loops = (cuda_build.sass_loop_counts(lib)
                 if lib.startswith("composite") else {})
        for fn, ops in cuda_build.sass_counts(lib).items():
            name = sass_name(fn)
            picked = pick(ops)
            ffma[name] = picked["FFMA"]
            print(f"  sass {name}: " + " ".join(
                f"{op} {n}" for op, n in picked.items() if n))
            if fn in loops:
                shfl = entry_loop(name, loops[fn])
                check(lib != "composite_bwd" or shfl <= K3_MAX_SHFL_PER_ENTRY,
                      f"{name}: {shfl} SHFL per entry")
    check(ffma["anatomy_full"] >= ffma["anatomy_no_mxu"] + 4,
          f"anatomy full has {ffma['anatomy_full']} FFMA against no_mxu's "
          f"{ffma['anatomy_no_mxu']}: its R, G, B, D accumulations are gone")


def print_launch_shapes(cuda_build) -> None:
    """K2's and K3's pixels per thread, threads, registers and resident
    blocks per SM, for the flagship's 32x32 tiles and for 16x16 tiles."""
    for npix in (1024, 256):
        for name, variant in (("composite_fwd", 1), ("composite_fwd", 0),
                              ("composite_bwd", 0)):
            info = cuda_build.kernel_info(name, npix, 64, variant)
            label = name + ("_no_exit" if name == "composite_fwd"
                            and not variant else "")
            print(f"  shape {label} at {npix} px, k_chunk 64: " + ", ".join(
                f"{k} {v}" for k, v in info.items()))
            if npix == 1024:
                check(info["blocks_per_sm"] >= 2,
                      f"{label}: {info['blocks_per_sm']} resident blocks "
                      f"per SM, want at least 2")


def phase_build() -> dict:
    """Build every kernel, show what ptxas and the SASS say, and hold K4
    against its plain version; returns K4's entry of the kernels line."""
    from touchgs_torch.ops import cuda_build

    t0 = time.time()
    out_dir = cuda_build.build()
    print(f"build: {time.time() - t0:.1f} s into {out_dir.name}", flush=True)
    for name, log in cuda_build.build_logs.items():
        fn = name
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", line)
            if m:
                fn = sass_name(m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {fn}: {line.strip()}")
    print_sass(cuda_build)
    print_launch_shapes(cuda_build)

    x = torch.arange(8 * 128, dtype=torch.float32,
                     device="cuda").reshape(8, 128)
    out = cuda_build.compile_smoke(x)
    torch.cuda.synchronize()
    check(torch.equal(out, cuda_build.compile_smoke_plain(x)),
          "K4 compile_smoke differs from plain")
    t = median_ms(lambda: cuda_build.compile_smoke(x), 50)
    t_plain = median_ms(lambda: cuda_build.compile_smoke_plain(x), 50)
    t_lib = median_ms(lambda: torch.mul(x, 2.0), 50)
    b = bound(2 * x.numel() * 4, fp32_ops=x.numel())
    print(f"K4 compile_smoke: exact; {t:.4f} ms (plain {t_plain:.4f}, "
          f"torch.mul {t_lib:.4f})")
    return dict(name="compile_smoke", route="cuda",
                source="touchgs_torch/csrc/compile_smoke.cu",
                replaces="bench.py:113", max_abs_err=0.0, ms=t,
                plain_ms=t_plain, bound_ms=b[0], bound_by=b[1],
                library_ms=t_lib)


def flagship_inputs(dev):
    """Projection, SH colours and binning of the flagship state on the
    card, with the packed attributes and the kernels' per-tile inputs."""
    from touchgs_torch.config import RasterizeConfig
    from touchgs_torch.data.cameras import Camera
    from touchgs_torch.models.gaussians import init_random
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops.projection import project_gaussians, view_directions
    from touchgs_torch.ops.sh import eval_sh
    from touchgs_torch.ops.tiles import bin_gaussians

    rcfg = RasterizeConfig(use_pallas=True)
    params = init_random(n=N_GAUSSIANS, capacity=CAPACITY, sh_degree=3,
                         device=dev)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.5

    def f32(v):
        return torch.tensor(np.float32(v), device=dev)

    cam = Camera(fx=f32(0.9 * WIDTH), fy=f32(0.9 * WIDTH), cx=f32(WIDTH / 2),
                 cy=f32(HEIGHT / 2), c2w=torch.as_tensor(c2w, device=dev),
                 width=WIDTH, height=HEIGHT)
    with torch.no_grad():
        opac = params.opacities()
        proj = project_gaussians(
            params.means, params.quats, params.scales(), cam.w2c, cam.fx,
            cam.fy, cam.cx, cam.cy, WIDTH, HEIGHT, rcfg,
            extra_valid=params.alive, opacities=opac)
        dirs = view_directions(params.means, cam.c2w[:3, 3])
        colors = torch.clamp(eval_sh(params.sh_coeffs(), dirs, 3, 3) + 0.5,
                             min=0.0)
        bins = bin_gaussians(proj, WIDTH, HEIGHT, rcfg)
        attrs = rc._pack_attrs(proj, colors, opac)
    n_tiles = bins.n_tiles_x * bins.n_tiles_y
    k_tile, k_chunk = rcfg.k_tile, rcfg.k_chunk
    capped = torch.clamp(bins.tile_counts, max=k_tile).contiguous()
    n_chunks = ((capped + k_chunk - 1) // k_chunk).to(torch.int32)
    tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    return dict(rcfg=rcfg, bins=bins, attrs=attrs, n_tiles=n_tiles,
                k_tile=k_tile, k_chunk=k_chunk, capped=capped,
                n_chunks=n_chunks, tile_ids=tile_ids, N=CAPACITY,
                th=rcfg.tile_h, tw=rcfg.tile_w, n_tx=bins.n_tiles_x)


def phase_kernels(dev) -> list:
    """Each kernel against its plain version at the flagship shapes."""
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops import rasterize_plain as plain

    x = flagship_inputs(dev)
    bins, n_tiles, k_tile = x["bins"], x["n_tiles"], x["k_tile"]
    geom = (x["th"], x["tw"], k_tile, x["k_chunk"], x["n_tx"], x["rcfg"])
    npix = x["th"] * x["tw"]
    sg, starts, capped = bins.sorted_gauss, bins.tile_starts, x["capped"]
    total_pairs = int(bins.tile_counts.sum())
    live_slots = int(capped.sum())
    print(f"flagship: {int(x['bins'].tile_counts.numel())} tiles, "
          f"{total_pairs} pairs, {live_slots} live slots (k_tile {k_tile})")

    # K1
    def k1():
        return rc.slot_lists(sg, starts, capped, n_tiles, k_tile, x["N"])

    def k1_plain():
        return plain.slot_lists_plain(sg, starts, capped, n_tiles, k_tile,
                                      x["N"])

    gidx, gidx_p = k1(), k1_plain()
    torch.cuda.synchronize()
    check(torch.equal(gidx, gidx_p), "K1 slot lists differ from plain")
    k1_err = float((gidx - gidx_p).abs().max())

    # K2
    attrs_tiled = x["attrs"][gidx].contiguous()
    nc, tids = x["n_chunks"], x["tile_ids"]

    def k2():
        return rc.forward_tiles(nc, tids, attrs_tiled, *geom)

    def k2_plain():
        return plain.forward_tiles_plain(nc, tids, attrs_tiled, *geom)

    fwd, fwd_p = k2(), k2_plain()
    torch.cuda.synchronize()
    rows = torch.tensor([0, 1, 2, 4, 5], device=dev)  # R, G, B, A, T
    err_rgba = float((fwd[:, rows] - fwd_p[:, rows]).abs().max())
    err_d = float((fwd[:, 3] - fwd_p[:, 3]).abs().max())
    done = fwd[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
    check(torch.equal(fwd[:, plain.ROW_DONE], fwd_p[:, plain.ROW_DONE]),
          "K2 chunks_done differs from plain")
    t_diff = int((fwd[:, plain.ROW_T] != fwd_p[:, plain.ROW_T]).sum())
    print(f"K2 errors: rgb/acc/T {err_rgba:.3e} (tol 3e-5), depth "
          f"{err_d:.3e} (tol 3e-4); T differs from plain at {t_diff} pixels")
    check(err_rgba <= 3e-5 and err_d <= 3e-4, "K2 outside tolerance")
    check(t_diff == 0, "K2's T row differs from plain")
    check_forward_without_exit(nc, tids, attrs_tiled, geom)
    scanned = int(done.sum()) * x["k_chunk"]
    print(f"scanned pairs: {scanned} entries x {npix} px "
          f"({100 * scanned / max(live_slots, 1):.1f}% of live slots; "
          f"early exit)")
    live, rows, blocks = live_pairs(done, tids, attrs_tiled, geom)
    print(f"live pairs: {100 * live:.1f}% of the scanned (entry, pixel) "
          f"pairs have alpha > 0; {100 * rows:.1f}% of the (entry, 32-pixel "
          f"row) and {100 * blocks:.1f}% of the (entry, 8x8 block) pairs "
          f"have none")

    # K3 on a seeded random cotangent
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    gstack = torch.randn(fwd.shape, generator=gen, device=dev)

    def k3():
        return rc.backward_tiles(done, tids, attrs_tiled, fwd, gstack, *geom)

    def k3_plain():
        return plain.backward_tiles_plain(done, tids, attrs_tiled, fwd,
                                          gstack, *geom)

    d, d_p = k3(), k3_plain()
    torch.cuda.synchronize()
    diff = (d - d_p).abs()
    bad = diff > 1e-5 + 1e-4 * d_p.abs()
    k3_err = float(diff.max())
    print(f"K3 error: max abs {k3_err:.3e}, bit-exact {torch.equal(d, d_p)}, "
          f"{int((diff > 0).sum())} values differ, {int(bad.sum())} of "
          f"{bad.numel()} outside rtol 1e-4 / atol 1e-5")
    check(not bool(bad.any()), "K3 outside tolerance")

    t_k1, t_k1p = median_ms(k1, 50), median_ms(k1_plain, 10)
    t_k2, t_k2p = median_ms(k2, 20), median_ms(k2_plain, 2, warmup=0)
    t_k3, t_k3p = median_ms(k3, 20), median_ms(k3_plain, 2, warmup=0)

    stack_bytes = n_tiles * plain.ROWS * npix * 4
    b1 = bound(4 * (2 * n_tiles + live_slots + n_tiles * k_tile))
    b2 = bound(scanned * plain.A * 4 + 8 * n_tiles + stack_bytes,
               fp32_ops=scanned * npix * FWD_OPS_PER_PAIR)
    b3 = bound(scanned * plain.A * 4 + 8 * n_tiles + 2 * stack_bytes
               + n_tiles * k_tile * plain.A * 4,
               fp32_ops=scanned * npix * BWD_OPS_PER_PAIR)
    return [
        dict(name="slot_lists", route="cuda",
             source="touchgs_torch/csrc/slot_lists.cu",
             replaces="touchgs_tpu/ops/rasterize_pallas.py:468",
             max_abs_err=k1_err, ms=t_k1, plain_ms=t_k1p, bound_ms=b1[0],
             bound_by=b1[1], library_ms=None),
        dict(name="composite_fwd", route="cuda",
             source="touchgs_torch/csrc/composite_fwd.cu",
             replaces="touchgs_tpu/ops/rasterize_pallas.py:500",
             max_abs_err=max(err_rgba, err_d), ms=t_k2, plain_ms=t_k2p,
             bound_ms=b2[0], bound_by=b2[1], library_ms=None),
        dict(name="composite_bwd", route="cuda",
             source="touchgs_torch/csrc/composite_bwd.cu",
             replaces="touchgs_tpu/ops/rasterize_pallas.py:520",
             max_abs_err=k3_err, ms=t_k3, plain_ms=t_k3p, bound_ms=b3[0],
             bound_by=b3[1], library_ms=None),
    ]


def live_pairs(done, tids, attrs_tiled, geom) -> tuple:
    """Over the entries K2 scanned (``done`` chunks a tile): the share of
    (entry, pixel) pairs with α > 0, and the shares of (entry, 32-pixel
    row) and (entry, 8x8 block) pairs with no such pixel, which a
    footprint cull inside the tile could skip.  From the plain α, which
    is the kernels' to the bit; 32x32 tiles."""
    from touchgs_torch.ops import rasterize_plain as plain

    th, tw, _, k_chunk, n_tx, cfg = geom
    px, py, ox, oy = plain._pixel_geometry(tids, th, tw, n_tx)
    n = torch.zeros(3, dtype=torch.float64, device=done.device)
    for c in range(int(done.max())):
        a = attrs_tiled[:, c * k_chunk:(c + 1) * k_chunk]
        alpha = plain._alpha(a, px, py, ox[:, :, None], oy[:, :, None],
                             cfg)[0]
        on = (alpha > 0) & (c < done)[:, None, None]
        on = on.reshape(on.shape[0], k_chunk, th // 8, 8, tw // 8, 8)
        n += torch.stack([on.sum(), on.any(dim=(4, 5)).sum(),
                          on.any(dim=(3, 5)).sum()]).double()
    scanned = float(done.sum()) * k_chunk
    live, row_any, block_any = n.tolist()
    return (live / (scanned * th * tw), 1 - row_any / (scanned * th),
            1 - block_any / (scanned * th * tw / 64))


def check_forward_without_exit(nc, tids, attrs_tiled, geom) -> tuple:
    """K2 with ``early_exit=False`` against its plain version: rgb/acc/T
    3e-5, depth 3e-4, and every chunk of each list composited.  Returns
    (max error, ms, plain ms)."""
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops import rasterize_plain as plain

    k_tile, k_chunk = geom[2], geom[3]

    def k2():
        return rc.forward_tiles(nc, tids, attrs_tiled, *geom,
                                early_exit=False)

    def k2_plain():
        return plain.forward_tiles_plain(nc, tids, attrs_tiled, *geom,
                                         early_exit=False)

    fwd, fwd_p = k2(), k2_plain()
    torch.cuda.synchronize()
    rows = [0, 1, 2, 4, plain.ROW_T]
    err_rgba = float((fwd[:, rows] - fwd_p[:, rows]).abs().max())
    err_d = float((fwd[:, 3] - fwd_p[:, 3]).abs().max())
    want = torch.clamp(nc, max=k_tile // k_chunk).float()
    check(torch.equal(fwd[:, plain.ROW_DONE, 0], want)
          and torch.equal(fwd[:, plain.ROW_DONE], fwd_p[:, plain.ROW_DONE]),
          f"K2 without exit (k_chunk {k_chunk}): chunks_done is not "
          f"min(n_chunks, k_tile/k_chunk)")
    check(err_rgba <= 3e-5 and err_d <= 3e-4,
          f"K2 without exit (k_chunk {k_chunk}) outside tolerance")
    t, t_p = median_ms(k2, 20), median_ms(k2_plain, 2, warmup=0)
    print(f"K2 without exit (k_chunk {k_chunk}) errors: rgb/acc/T "
          f"{err_rgba:.3e} (tol 3e-5), depth {err_d:.3e} (tol 3e-4); "
          f"{int(want.sum()) * k_chunk} entries composited; {t:.4f} ms "
          f"(plain {t_p:.1f} ms)")
    return max(err_rgba, err_d), t, t_p


def phase_reference(dev) -> None:
    """A small scene through the tile kernels against the dense oracle."""
    from touchgs_torch.config import RasterizeConfig
    from touchgs_torch.data.cameras import Camera
    from touchgs_torch.ops.projection import project_gaussians
    from touchgs_torch.ops.rasterize_cuda import rasterize_cuda
    from touchgs_torch.ops.rasterize_ref import rasterize_dense

    rng = np.random.default_rng(5)
    n, w, h = 300, 96, 64
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    means = t(rng.uniform(-0.8, 0.8, (n, 3)))
    quats = rng.normal(size=(n, 4))
    quats = t(quats / np.linalg.norm(quats, axis=-1, keepdims=True))
    scales = t(np.exp(rng.uniform(-4.5, -3.0, (n, 3))))
    colors = t(rng.uniform(0.0, 1.0, (n, 3)))
    opac = t(rng.uniform(0.3, 0.95, n))
    cam = Camera(fx=t(150.0), fy=t(150.0), cx=t(w / 2), cy=t(h / 2),
                 c2w=t(look_at_c2w((0.0, 0.0, 2.5))), width=w, height=h)
    cfg = RasterizeConfig(use_pallas=True)
    with torch.no_grad():
        proj = project_gaussians(means, quats, scales, cam.w2c, cam.fx,
                                 cam.fy, cam.cx, cam.cy, w, h, cfg,
                                 opacities=opac)
        out = rasterize_cuda(proj, colors, opac, w, h, cfg)
        ref = rasterize_dense(proj, colors, opac, w, h, cfg)
    e_rgb = float((out.rgb - ref.rgb).abs().max())
    e_acc = float((out.acc - ref.acc).abs().max())
    e_d = float((out.depth - ref.depth).abs().max())
    print(f"tile kernels vs dense oracle ({w}x{h}, {n} gaussians): rgb "
          f"{e_rgb:.2e}, acc {e_acc:.2e}, depth {e_d:.2e}")
    check(e_rgb <= 1e-4 and e_acc <= 1e-4 and e_d <= 1e-3,
          "tile kernels disagree with the dense oracle")


def make_scene():
    from touchgs_torch.data.cameras import Cameras
    from touchgs_torch.data.scene import Scene

    rng = np.random.default_rng(0)
    n_views = 4
    c2w = np.stack([look_at_c2w((2.5 * np.sin(a), 0.4, 2.5 * np.cos(a)))
                    for a in np.linspace(0, np.pi / 2, n_views)])
    f = np.full(n_views, 0.9 * WIDTH, np.float32)
    cameras = Cameras(fx=f, fy=f.copy(),
                      cx=np.full(n_views, WIDTH / 2, np.float32),
                      cy=np.full(n_views, HEIGHT / 2, np.float32),
                      c2w=c2w, width=WIDTH, height=HEIGHT)
    return Scene(
        cameras=cameras,
        images=rng.uniform(0, 1, (n_views, HEIGHT, WIDTH, 3)).astype(np.float32),
        depths=rng.uniform(1.0, 3.0, (n_views, HEIGHT, WIDTH)).astype(np.float32),
        uncertainties=rng.uniform(0.0, 1.0, (n_views, HEIGHT, WIDTH)
                                  ).astype(np.float32),
        i_train=np.arange(n_views), i_eval=np.array([], int),
        seed_points=rng.uniform(-1, 1, (N_GAUSSIANS, 3)).astype(np.float32),
        seed_colors=rng.uniform(0, 1, (N_GAUSSIANS, 3)).astype(np.float32),
        scale_factor=1.0, transform=np.eye(4)[:3], name="chip_smoke",
    )


def phase_train(card: str):
    """The main path; returns the launch counts of its 25 steps and the
    trainer."""
    from touchgs_torch.config import ModelConfig, RasterizeConfig, TrainConfig
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.train.trainer import Trainer

    scene = make_scene()
    cfg = TrainConfig(
        model=ModelConfig(max_gaussians=CAPACITY, sh_degree=3,
                          rasterize=RasterizeConfig(use_pallas=True)),
        view_cache_bytes=1 << 30,
        log_every=1,  # every step ends in a host read of its metrics
    )
    t0 = time.time()
    trainer = Trainer(scene, cfg)
    check(trainer.state.params.capacity == CAPACITY,
          f"capacity {trainer.state.params.capacity}, want {CAPACITY}")
    print(f"trainer init: {time.time() - t0:.1f} s, capacity "
          f"{trainer.state.params.capacity}, alive "
          f"{int(trainer.state.params.num_alive)}")

    for k in rc.launches:
        rc.launches[k] = 0
    first = trainer.run(WARMUP_STEPS)
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    last = trainer.run(WARMUP_STEPS + TIMED_STEPS,
                       log_fn=lambda m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    counts = dict(rc.launches)

    step_ms = np.diff(stamps) * 1e3
    check(len(step_ms) == TIMED_STEPS, f"{len(step_ms)} timed steps")
    losses = [h["loss"] for h in trainer.history]
    med = float(np.median(step_ms))
    print(f"train: loss first {losses[0]:.6f} last {losses[-1]:.6f}; psnr "
          f"last {last['psnr']:.3f} dB; alive {int(last['num_alive'])}")
    print(f"train: median step {med:.3f} ms ({1e3 / med:.2f} it/s) over "
          f"{TIMED_STEPS} steps, quartiles "
          f"{np.percentile(step_ms, 25):.3f}/{np.percentile(step_ms, 75):.3f}"
          f" ms, on {card}")
    print(f"train: lossy_tiles window max {last['lossy_tiles_window_max']}; "
          f"views cached {len(trainer._batch_cache)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"train: launches {counts}")
    check(all(np.isfinite(losses)) and np.isfinite(first["loss"]),
          "non-finite loss")
    n_steps = WARMUP_STEPS + TIMED_STEPS
    check(all(v == n_steps for v in counts.values()),
          f"launch counts {counts}, want {n_steps} each")

    out = trainer.render_view(0)
    torch.cuda.synchronize()
    check(tuple(out.rgb.shape) == (HEIGHT, WIDTH, 3)
          and bool(torch.isfinite(out.rgb).all())
          and bool(torch.isfinite(out.depth).all()),
          "lossless render is not finite")
    print(f"render_view: lossless, rgb mean {float(out.rgb.mean()):.4f}, "
          f"lossy tiles {int(out.lossy_tiles)}")
    return counts, trainer


def phase_profile(trainer, steps: int = PROFILE_STEPS) -> None:
    """Device time by kernel over a few more training steps, from
    torch.profiler, and the device's busy share of their wall time (the
    profiler slows the host, so the share under it is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(trainer.state.step + steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    per_step = sum(e.count for e in kernels) / steps
    print(f"profile: {steps} steps, device busy {busy_ms / steps:.3f} ms per "
          f"step of {wall_ms / steps:.3f} ms wall under the profiler "
          f"({100 * busy_ms / wall_ms:.1f}% busy); {per_step:.0f} device "
          f"operations per step, of {len(kernels)} distinct names")
    for e in kernels[:PROFILE_TOP]:
        ms = e.device_time_total / 1e3 / steps
        print(f"  {ms:8.3f} ms/step {100 * ms * steps / busy_ms:5.1f}%  "
              f"{e.count / steps:5.1f}x  {e.key[:90]}")


def phase_anatomy_path() -> tuple:
    """The profiling path as ``python -m touchgs_torch.tools.
    exp_kernel_anatomy --bf16`` runs it, with every launch counter set to 0
    just before and read just after; returns the counts and its inputs."""
    from touchgs_torch.ops import anatomy, cuda_build
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.tools import exp_kernel_anatomy as tool

    counters = (rc.launches, anatomy.launches, cuda_build.launches)
    for c in counters:
        for k in c:
            c[k] = 0
    t0 = time.time()
    x, probe, _ = tool.run_tool(["--bf16"])
    torch.cuda.synchronize()
    counts = {k: v for c in counters for k, v in c.items()}
    print(f"anatomy path: {time.time() - t0:.1f} s; launches {counts}")
    path_kernels = ["compile_smoke", "slot_lists", "composite_fwd",
                    *anatomy.launches]
    check(all(counts[k] >= 1 for k in path_kernels),
          f"the anatomy path launched none of "
          f"{[k for k in path_kernels if counts[k] < 1]}")
    return counts, x, probe


def phase_anatomy(x, probe) -> list:
    """The anatomy's kernels against their plain versions on its inputs;
    returns the K5 and K6 entries of the kernels line."""
    from touchgs_torch.ops import anatomy
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops import rasterize_plain as plain
    from touchgs_torch.tools import exp_kernel_anatomy as tool

    th, tw, k_tile, k_chunk, n_tx, cfg = x.geom
    npix, n_tiles, entries = th * tw, x.at.shape[0], x.full_entries
    print(f"anatomy inputs: {n_tiles} tiles, k_tile {k_tile}, k_chunk "
          f"{k_chunk}, {entries} entries in the full lists")

    def k2():
        return rc.forward_tiles(x.nc, x.tids, x.at, *x.geom)

    fwd, fwd_p = k2(), plain.forward_tiles_plain(x.nc, x.tids, x.at, *x.geom)
    torch.cuda.synchronize()
    rows = [0, 1, 2, 4, plain.ROW_T]
    check(torch.equal(fwd[:, plain.ROW_DONE], fwd_p[:, plain.ROW_DONE])
          and float((fwd[:, rows] - fwd_p[:, rows]).abs().max()) <= 3e-5
          and float((fwd[:, 3] - fwd_p[:, 3]).abs().max()) <= 3e-4,
          "K2 with exit at k_chunk 128 differs from plain")
    ms = {"exit": median_ms(k2, 20)}
    _, ms["noexit"], _ = check_forward_without_exit(x.nc, x.tids, x.at,
                                                    x.geom)

    def errors(out, ref):
        """(max abs error, max of each tile's error over its largest
        output)"""
        diff = (out - ref).abs().amax(dim=(1, 2))
        scale = ref.abs().amax(dim=(1, 2)).clamp(min=1e-30)
        return float(diff.max()), float((diff / scale).max())

    out_bytes = n_tiles * 2 * npix * 4
    result = []
    for mode in anatomy.MODES:
        args = (mode, x.nc, x.tids, x.at, *x.geom)
        err, rel = errors(anatomy.variant(*args),
                          anatomy.variant_plain(*args))
        torch.cuda.synchronize()
        print(f"K5 {mode}: max error {err:.3e}, {rel:.3e} of the tile's "
              f"largest output (tol 3e-5)")
        check(rel <= 3e-5, f"K5 {mode} outside tolerance")
        ms[mode] = median_ms(lambda: anatomy.variant(*args), 20)
        t_p = median_ms(lambda: anatomy.variant_plain(*args), 3, warmup=1)
        b = bound(entries * plain.A * 4 + 8 * n_tiles + out_bytes,
                  fp32_ops=anatomy.OPS_PER_PAIR[mode] * entries * npix)
        result.append(dict(
            name=f"anatomy_{mode}", route="cuda",
            source="touchgs_torch/csrc/anatomy_variants.cu",
            replaces="tools/exp_kernel_anatomy.py:132", max_abs_err=err,
            ms=ms[mode], plain_ms=t_p, bound_ms=b[0], bound_by=b[1],
            library_ms=None, library_note="no single PyTorch call "
            "composites these ablations"))
    tool.print_attribution(ms, entries, npix)

    n_probe = probe["f32"].shape[0]
    pairs = n_probe * anatomy.PROBE_ROWS * anatomy.PROBE_NPIX
    for leg, at in probe.items():
        out, ref = anatomy.bf16_probe(at), anatomy.bf16_probe_plain(at)
        torch.cuda.synchronize()
        err, rel = errors(out, ref)
        tol = 1e-5 if leg == "f32" else 2.0 ** -6
        print(f"K6 {leg}: max error {err:.3e}, {rel:.3e} of the tile's "
              f"largest output (tol {tol:.3g})")
        check(rel <= tol, f"K6 {leg} outside tolerance")
        ms[leg] = median_ms(lambda: anatomy.bf16_probe(at), 20)
        t_p = median_ms(lambda: anatomy.bf16_probe_plain(at), 3, warmup=1)
        chain = anatomy.PROBE_CHAIN_OPS * pairs
        sums = anatomy.PROBE_SUM_OPS * pairs
        b = bound(at.numel() * at.element_size() + n_probe * 1024 * 4,
                  fp32_ops=sums + (chain if leg == "f32" else 0),
                  bf16_ops=chain if leg == "bf16" else 0)
        result.append(dict(
            name=f"bf16_probe_{leg}", route="cuda",
            source="touchgs_torch/csrc/bf16_probe.cu",
            replaces="tools/exp_kernel_anatomy.py:205", max_abs_err=err,
            ms=ms[leg], plain_ms=t_p, bound_ms=b[0], bound_by=b[1],
            library_ms=None, library_note="no single PyTorch call "
            "computes the α-sum probe"))
    print(f"bf16 probe: f32 {ms['f32']:.4f} ms, bf16 {ms['bf16']:.4f} ms, "
          f"bf16 runs {ms['f32'] / ms['bf16']:.2f}x the f32 rate")
    return result


def batched_ms(fn, calls: int, batches: int = 5) -> float:
    """Median over ``batches`` of the CUDA-event time of ``calls`` calls
    back to back, per call.  The queue stays full, so unlike ``median_ms``
    the time leaves out the host's work between two launches (the old
    kernels are launched without the wrappers' argument checks)."""
    fn()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def phase_ab(dev, old, rounds: int = 20) -> None:
    """K2 and K3 of this tree against the same two kernels built from the
    sources in the directory ``old`` (an earlier commit's
    ``touchgs_torch/csrc``, with the same launch signatures) at the flagship
    shapes: the pairs held against each other, then timed in turns old, new,
    new, old, each ``batched_ms`` over ``rounds`` launches."""
    from pathlib import Path

    from touchgs_torch.ops import cuda_build as cb
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops import rasterize_plain as plain

    old = Path(old).resolve()
    x = flagship_inputs(dev)
    geom = (x["th"], x["tw"], x["k_tile"], x["k_chunk"], x["n_tx"], x["rcfg"])
    th, tw, k_tile, k_chunk, n_tx, cfg = geom
    n_tiles, nc, tids = x["n_tiles"], x["n_chunks"], x["tile_ids"]
    gidx = rc.slot_lists(x["bins"].sorted_gauss, x["bins"].tile_starts,
                         x["capped"], n_tiles, k_tile, x["N"])
    at = x["attrs"][gidx].contiguous()
    stack_shape = (n_tiles, plain.ROWS, th * tw)
    tail = (n_tiles, th, tw, k_tile, k_chunk, n_tx, cfg.alpha_clip,
            cfg.alpha_threshold)

    def old_fwd():
        out = torch.empty(stack_shape, device=dev)
        cb.call("composite_fwd", cb.ptr(nc), cb.ptr(tids), cb.ptr(at),
                cb.ptr(out), *tail, 1, cb.stream(out), src=old)
        return out

    def new_fwd():
        return rc.forward_tiles(nc, tids, at, *geom)

    f_old, f_new = old_fwd(), new_fwd()
    torch.cuda.synchronize()
    for r in (plain.ROW_DONE, plain.ROW_T):
        check(torch.equal(f_old[:, r], f_new[:, r]),
              f"A/B: K2 row {r} differs between the versions")
    check(float((f_old[:, :3] - f_new[:, :3]).abs().max()) <= 3e-5
          and float((f_old[:, 4] - f_new[:, 4]).abs().max()) <= 3e-5
          and float((f_old[:, 3] - f_new[:, 3]).abs().max()) <= 3e-4,
          "A/B: K2 versions disagree")
    done = f_new[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    g = torch.randn(stack_shape, generator=gen, device=dev)

    def old_bwd():
        out = torch.empty_like(at)
        cb.call("composite_bwd", cb.ptr(done), cb.ptr(tids), cb.ptr(at),
                cb.ptr(f_new), cb.ptr(g), cb.ptr(out), *tail,
                cb.stream(out), src=old)
        return out

    def new_bwd():
        return rc.backward_tiles(done, tids, at, f_new, g, *geom)

    b_old, b_new = old_bwd(), new_bwd()
    torch.cuda.synchronize()
    for name in ("composite_fwd", "composite_bwd"):  # the old build's log
        for line in cb.build_logs[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  old ptxas {name}: {line.strip()}")
    # the versions sum the cancelling per-pixel terms in different orders,
    # so they differ by float32 rounding of those sums, not of the results
    err = float((b_old - b_new).abs().max())
    scale = float(b_old.abs().max())
    print(f"A/B against {old}: K2 chunks_done and T equal; K3 max abs "
          f"{err:.3e} of largest {scale:.3e}")
    check(err <= 1e-4 * scale, "A/B: K3 versions disagree")
    for name, fo, fn in (("composite_fwd", old_fwd, new_fwd),
                         ("composite_bwd", old_bwd, new_bwd)):
        for tag, src in (("old", old), ("new", cb.CSRC)):
            for f, loop in cb.sass_loop_counts(name, src).items():
                print(f"  {tag} {sass_name(f)}:")
                entry_loop(sass_name(f), loop)
        t = [batched_ms(f, rounds) for f in (fo, fn, fn, fo)]
        print(f"A/B {name}: old {t[0]:.4f}, new {t[1]:.4f}, new {t[2]:.4f}, "
              f"old {t[3]:.4f} ms; old/new {(t[0] + t[3]) / (t[1] + t[2]):.3f}x")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from touchgs_torch.utils.profiling import card  # fails outside a checkout

    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        print(card(), flush=True)
        phase_ab(torch.device("cuda"), sys.argv[2])
        return 0
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    card_name = card()
    print(card_name, flush=True)
    dev = torch.device("cuda")

    k4 = phase_build()
    kernels = phase_kernels(dev)
    phase_reference(dev)
    counts, trainer = phase_train(card_name)
    phase_profile(trainer)
    del trainer
    torch.cuda.empty_cache()
    for k in kernels:
        k["launches"] = counts[k["name"]]
    path_counts, x, probe = phase_anatomy_path()
    kernels += [k4] + phase_anatomy(x, probe)
    for k in kernels[3:]:
        k["launches"] = path_counts[k["name"]]
    print(f"chip_smoke: {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
