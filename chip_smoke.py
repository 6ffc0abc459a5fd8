"""Build the port's CUDA kernels and hold each against its plain version
on one GPU: the producer of PERF.md's kernel table.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits nonzero with no result):

1. Card and build: the card's name and power limit, TF32 off, and the
   kernel sources of ``touchgs_torch/csrc/`` built with nvcc for sm_90a;
   ptxas's registers per kernel, the SASS opcode counts of the compositing
   and the anatomy kernels (the `full` ablation must keep its R, G, B, D
   FMAs), every such kernel's entry loop per (entry, pixel) pair (K3 at
   most 10 SHFL per entry and thread; the bf16 probe's loop must hold its
   HMMA), and the pixels per thread, threads, registers and resident blocks
   per SM of K2, K3 and the K5 modes (at least 2 for 32x32 tiles).  Then
   K4, ``compile_smoke``, against its plain version, exactly; the host cost
   of each piece of a wrapper call (``host_costs``), and K4 timed in turns
   with ``torch.mul(x, 2.0)``.
2. Kernels against their plain PyTorch versions at the flagship shapes
   (800x800, 100k Gaussians in a capacity of 131072, SH degree 3; 625 tiles
   of 32x32, k_tile 512, k_chunk 64): K1 slot lists bit-exact, alone and
   with their rows (``slot_rows``, equal to ``attrs[gidx]``), timed per
   call, queue-full and on the device beside the ``slot_lists`` +
   ``attrs[gidx]`` it replaces; K2 forward, with its early exit and
   without, within rgb/acc 3e-5 and depth 3e-4 with equal chunks_done
   (without the exit: min(n_chunks, k_tile/k_chunk)) and an equal T row;
   K3 backward within rtol 1e-4 / atol 1e-5 on a seeded random cotangent
   (it prints whether it is bit-exact, as it should be).
3. The SSIM pair of the loss (``ssim_fwd``, ``ssim_bwd``) against their
   plain versions at 800x800x3 and 1280x720x3, read as the loss reads the
   render, through the channel-major view of an (H, W, 3) image: the value
   within rtol 1e-6 and dL/dx within 1e-5 of its largest, dL/dx laid out
   as the image; each timed per call beside its plain version and the
   band-matrix path it replaced (``ssim_cm_band``), on the device, and
   against the bound of what the function must do (SSIM_FWD_OPS and
   SSIM_BWD_VALUES; this design's own traffic printed beside it).
4. The shade pair of every render on the card (``shade_fwd``,
   ``shade_bwd``, ``csrc/shade.cu``) on the start states of three cells
   (``cell_shade_state``: the benchmark's polish states of
   ``perfbench/configs``' blender, mirror and real1m configurations, one
   view each) against the op chain (``shade_fwd_plain``: the table,
   means2d and depths within SHADE_ULPS of it, radii, cull radii and
   validity equal) and its autograd backward (each group within
   SHADE_GRAD_TOL of its largest, zero on the rows the cotangent skips);
   at 131072 and 1,048,576 each timed per call and on the device beside
   the op chain's forward and autograd backward and the plain backward,
   against the bytes it cannot do without (SHADE_FWD_BYTES,
   SHADE_BWD_BYTES a Gaussian).
5. The main path as the cells run it, untimed: ``Trainer.run`` for
   TRAIN_STEPS steps of the blender cell's polish phase (``perfbench``'s
   scene, ``TrainConfig``, start state and resume path; on the card every
   step a replay of the captured graph), the launch counters zeroed before
   it: each kernel of the step (TRAIN_PATH) launches once a step, every
   other kernel never.
6. The profiling path: ``python -m touchgs_torch.tools.exp_kernel_anatomy
   --bf16``'s work (K4, the flagship's tiles at k_chunk 128, K2 with and
   without its exit, the four K5 ablations, the two K6 probe legs), each of
   its kernels launched.
7. The anatomy's kernels against their plain versions on the same inputs:
   K2 at k_chunk 128 with and without its exit (as in phase 2); each K5 mode
   within 3e-5 of each tile's largest output; K6 f32 within 1e-5 and bf16
   within 2^-6 of it, on the probe's rows and on rows spread over the
   whole tile.  Times per call and queue-full (``batched_ms``); from the
   queue-full times the attribution of K2's time, the fp32 rate alpha_only
   sustains, f32 against bf16 and, at the SM clock nvidia-smi reads under
   load, printed lines of each K5 mode's and K6 leg's time against its
   bound, its issue roof (its entry loop's SASS a pair at one instruction
   a lane and clock) and its MUFU floor (``roofs``, models, kept out of
   the kernels line).
8. One ``kernels`` JSON line (an entry a kernel: measured times, errors,
   the computed ``bound_ms``, and ``launches`` with its ``path``: a kernel
   of the training step its launches over phase 5's run, any other (K1's
   lists alone, K4-K6) over phase 6's; the SSIM and shade pairs also ``device_ms`` and, under
   ``shapes``, their readings at each size of phases 3 and 4; the shade
   pair the op chain's ``chain_ms`` and ``chain_device_ms``), then the last
   line ``{"ok": true, "device": {...}}``.

Per call times are ``utils.profiling.measure``'s (CUDA events around
back-to-back calls, the wrapper's host work included); queue-full times
``batched_ms`` (the median of five batches); device times ``device_ms``
(torch.profiler's kernel records).  The other paths that use the kernels
(the CLI, the tools, the touch, vision, sensor and NeRF stacks, the
viewer, the parallel steps, the graphed steps against eager) are held at
test size by ``tests/test_torch_cuda.py``, and the training step is timed
by ``perfbench/``.

Without a CUDA device it exits with status 1 before doing anything.

    python3 chip_smoke.py --shade

builds the kernels, prints ptxas's report of the shade kernels and runs
phase 4 alone.

    python3 chip_smoke.py --ab OLD_CSRC

instead builds K2, K3, K5 and K6 from the directory OLD_CSRC as well (an
earlier commit's ``touchgs_torch/csrc``, unpacked with ``git archive`` into
a gitignored directory such as ``.archive/``), holds each pair of versions
against each other and times them in turns, K2 and K3 at the flagship
shapes (``phase_ab``), K5 on the anatomy's tiles and K6 on the probe's rows
(``phase_ab_anatomy``).
"""
from __future__ import annotations

import json
import re
import sys
import time

import numpy as np
import torch

from touchgs_torch.utils.profiling import card, measure

WIDTH = HEIGHT = 800
N_GAUSSIANS = 100_000
CAPACITY = 131_072
# H100 SXM published peaks at 700 W: fp32 outside the tensor cores, bf16
# (the tensor cores' dense rate, the only bf16 rate of the published
# table), and HBM
PEAK_FP32_OPS = 67e12
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12
# fp32 operations per scanned (entry, pixel) pair, counted from the kernels
FWD_OPS_PER_PAIR = 34
BWD_OPS_PER_PAIR = 76
# phase 3: the SSIM pair at the cells' image sizes (H, W), three channels,
# held to the card tests' limits: value rtol, gradient of its largest
SSIM_SHAPES = ((800, 800), (720, 1280))
SSIM_VALUE_RTOL, SSIM_GRAD_TOL = 1e-6, 1e-5
# what the SSIM cannot do without, a pixel of one channel: fp32 operations
# of its blurs (11 FMAs a value and pass, two passes), five maps and their
# three products forward, three maps and the combination backward; float32
# values moved, x and y read forward, x and y read and dL/dx written
# backward.  This design moves 11 values: the forward writes three maps
# and the backward reads them back.
SSIM_FWD_OPS, SSIM_BWD_OPS = 5 * 44 + 3, 3 * 44 + 4
SSIM_FWD_VALUES, SSIM_BWD_VALUES, SSIM_DESIGN_VALUES = 2, 3, 11
# phase 4: the shade pair on two cells' start states (the benchmark's
# polish state of each configuration, ``perfbench/configs``), at the
# capacities 131072 and 1,048,576, held to the card tests' limits: floats
# within SHADE_ULPS of the op chain's, radii, cull radii and validity
# equal; each group's gradient within SHADE_GRAD_TOL of its largest
SHADE_CELLS = {"blender800": "bunny_blender_800",
               "mirror720": "mirror_1280x720", "real1m": "bunny_real_1m"}
SHADE_TIMED = ("blender800", "real1m")
SHADE_ULPS, SHADE_GRAD_TOL = 2, 1e-5
# what the stage cannot do without, a Gaussian: bytes read and written.
# Forward: the six groups (240), alive and the means2d offset in; the
# packed row (64), means2d, depth, radii, cull radius and validity out.
# Backward: the six groups and the row's ten gradient columns in; the six
# groups' gradients and the offset's out.
SHADE_FWD_BYTES = 240 + 1 + 8 + 64 + 8 + 4 + 4 + 4 + 1
SHADE_BWD_BYTES = 240 + 40 + 236 + 8
HOST_CALLS = 10_000  # calls a round of the host-cost table
K4_CALLS = 200       # calls a timing of K4 and torch.mul
# phase 5: the kernels every training step launches once (the shade pair,
# K1 with rows, K2, K3 and the SSIM pair of its loss), over TRAIN_STEPS
# steps of the blender cell's polish phase from TRAIN_SEED
TRAIN_PATH = ("slot_rows", "composite_fwd", "composite_bwd", "ssim_fwd",
              "ssim_bwd", "shade_fwd", "shade_bwd")
TRAIN_STEPS, TRAIN_SEED = 20, 7


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


SASS_OPS = ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "MUFU.EX2",
            "SHFL", "HFMA2", "HMUL2", "HADD2", "HMNMX2", "HSET2", "HMMA")
# K3's shuffles per replayed entry and thread (a 5-step butterfly for each
# of its ten sums would take 50)
K3_MAX_SHFL_PER_ENTRY = 10


def sass_name(fn: str) -> str:
    """A readable name for a mangled kernel function of the libraries."""
    from touchgs_torch.ops.anatomy import MODES

    # pixels per thread as _p<P>; kernels of one pixel a thread have no P
    m = re.search(r"anatomy_kernelILi(\d)E(?:Li(\d)E)?", fn)
    if m:
        return (f"anatomy_{MODES[int(m.group(1))]}"
                + (f"_p{m.group(2)}" if m.group(2) else ""))
    m = re.search(r"composite_(fwd|bwd)_groups_kernelI(?:Lb(\d)E)?Li(\d)E",
                  fn)
    if m:
        return (f"composite_{m.group(1)}_groups"
                + ("_no_exit" if m.group(2) == "0" else "")
                + f"_p{m.group(3)}")
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
    from touchgs_torch.ops.cuda_build import is_op

    return {op: sum(n for k, n in ops.items() if is_op(k, op))
            for op in SASS_OPS}


def entry_loop(name: str, loop) -> dict:
    """Print a kernel's entry loop (``cuda_build.sass_loop_counts``) per
    (entry, pixel) pair; a kernel named ``_p<P>`` covers P pixels a thread,
    so its pairs / P are the entries of a pass.  Returns per pair its SASS
    in all (``sass``), MUFU.EX2 (``mufu``) and HMMA (``hmma``), and SHFL
    per entry and thread (``shfl``)."""
    body = pick(loop)
    # the pairs a thread covers in one pass: 4 per HMMA (a lane's m16n8k16
    # B fragment is four α), else one per MUFU.EX2 (one exp2 a pair; a
    # packed bf16 exp2 issues two for a word of two pairs), else one per
    # FMNMX (the α clip of K5's noexp)
    pairs = 4 * body["HMMA"] or body["MUFU.EX2"] or body["FMNMX"]
    m = re.search(r"_p(\d)$", name)
    entries = pairs / (int(m.group(1)) if m else 1)
    counted = sum(n for op, n in body.items() if op != "SHFL")
    out = dict(sass=sum(loop.values()) / pairs, mufu=body["MUFU.EX2"] / pairs,
               hmma=body["HMMA"] / pairs, shfl=body["SHFL"] / entries)
    print(f"    entry loop ({pairs:g} pairs a pass"
          + (f", {entries:g} entries" if m else "") + "): "
          + " ".join(f"{op} {n}" for op, n in body.items() if n)
          + f"; per pair {counted / pairs:.2f} counted (SHFL aside), "
          f"{out['sass']:.2f} SASS in all; SHFL {out['shfl']:.2f} per entry "
          f"and thread")
    return out


def print_sass(cuda_build) -> dict:
    """Static SASS opcode counts of the compositing and the anatomy
    kernels, and each one's entry loop (``entry_loop``).  Fails if `full`
    lost its R, G, B, D accumulations (it would then time no_mxu), K3's
    loop shuffles more than K3_MAX_SHFL_PER_ENTRY a thread per entry, a K5
    or K6 kernel has no entry loop, or the bf16 probe's has no HMMA.
    Returns the ``entry_loop`` figures by kernel name."""
    from touchgs_torch.ops.anatomy import MODES

    ffma, loops = {}, {}
    for lib in ("composite_fwd", "composite_bwd", "anatomy_variants",
                "bf16_probe"):
        found = cuda_build.sass_loop_counts(lib)
        for fn, ops in cuda_build.sass_counts(lib).items():
            name = sass_name(fn)
            picked = pick(ops)
            ffma[name] = picked["FFMA"]
            print(f"  sass {name}: " + " ".join(
                f"{op} {n}" for op, n in picked.items() if n))
            if fn in found:
                loops[name] = entry_loop(name, found[fn])
                check(lib != "composite_bwd"
                      or loops[name]["shfl"] <= K3_MAX_SHFL_PER_ENTRY,
                      f"{name}: {loops[name]['shfl']} SHFL per entry")
    for P in (4, 2, 1):
        full, no_mxu = ffma[f"anatomy_full_p{P}"], ffma[f"anatomy_no_mxu_p{P}"]
        check(full >= no_mxu + 4 * P,
              f"anatomy full (P = {P}) has {full} FFMA against no_mxu's "
              f"{no_mxu}: its R, G, B, D accumulations are gone")
    probes = [f"anatomy_{m}_p{P}" for m in MODES for P in (4, 2, 1)]
    probes += ["bf16_probe_f32", "bf16_probe_bf16"]
    check(all(n in loops for n in probes),
          f"no entry loop in {[n for n in probes if n not in loops]}")
    check(loops["bf16_probe_bf16"]["hmma"] > 0,
          "the bf16 probe's entry loop has no HMMA")
    return loops


def print_launch_shapes(cuda_build) -> None:
    """Pixels per thread, threads, registers and resident blocks per SM of
    the kernels in K2's thread shape (K2, K3 at k_chunk 64, the K5 modes at
    the anatomy's 128), for the flagship's 32x32 tiles and for 16x16 tiles;
    at least 2 resident blocks per SM for 32x32.  Then K2's and K3's group
    kernels at 144 and 4096 pixels and at the cap, at k_chunk 64 and 256,
    beside the card's opt-in shared memory a block: each must fit."""
    from touchgs_torch.ops.anatomy import MODES

    shapes = [("composite_fwd", 1, 64, "composite_fwd"),
              ("composite_fwd", 0, 64, "composite_fwd_no_exit"),
              ("composite_bwd", 0, 64, "composite_bwd")]
    shapes += [("anatomy_variants", i, 128, f"anatomy_{m}")
               for i, m in enumerate(MODES)]
    for npix in (1024, 256):
        for name, variant, k_chunk, label in shapes:
            info = cuda_build.kernel_info(name, npix, k_chunk, variant)
            print(f"  shape {label} at {npix} px, k_chunk {k_chunk}: "
                  + ", ".join(f"{k} {v}" for k, v in info.items()))
            if npix == 1024:
                check(info["blocks_per_sm"] >= 2,
                      f"{label}: {info['blocks_per_sm']} resident blocks "
                      f"per SM, want at least 2")
    # the group kernels (tiles over 1024 pixels or not whole warps), up to
    # the cap, ROADMAP C40
    from touchgs_torch.ops.rasterize_cuda import MAX_TILE_PIXELS

    props = torch.cuda.get_device_properties(0)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    print(f"  shared memory a block, opt-in limit: {optin} bytes")
    for npix in (144, 4096, MAX_TILE_PIXELS):
        for name, variant, _, label in shapes[:3]:
            for k_chunk in (64, 256):
                info = cuda_build.kernel_info(name, npix, k_chunk, variant)
                print(f"  shape {label} (groups) at {npix} px, k_chunk "
                      f"{k_chunk}: " + ", ".join(f"{k} {v}"
                                                 for k, v in info.items()))
                check(info["blocks_per_sm"] >= 1,
                      f"{label} at {npix} px does not fit on an SM")


def phase_build() -> tuple:
    """Build every kernel, show what ptxas and the SASS say, and hold K4
    against its plain version; returns K4's entry of the kernels line and
    the entry loops' figures (``print_sass``)."""
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
    loops = print_sass(cuda_build)
    print_launch_shapes(cuda_build)

    x = torch.arange(8 * 128, dtype=torch.float32,
                     device="cuda").reshape(8, 128)
    out = cuda_build.compile_smoke(x)
    torch.cuda.synchronize()
    check(torch.equal(out, cuda_build.compile_smoke_plain(x)),
          "K4 compile_smoke differs from plain")
    host_costs(cuda_build, x)

    def k4():
        return cuda_build.compile_smoke(x)

    def mul():
        return torch.mul(x, 2.0)

    # in turns, K4, mul, mul, K4, each a median over CUDA events
    t = [1e3 * measure(f, iters=K4_CALLS) for f in (k4, mul, mul, k4)]
    t_k4, t_lib = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    t_plain = 1e3 * measure(lambda: cuda_build.compile_smoke_plain(x),
                            iters=K4_CALLS)
    d_k4, d_lib = device_ms(k4, K4_CALLS), device_ms(mul, K4_CALLS)
    b = bound(2 * x.numel() * 4, fp32_ops=x.numel())
    print(f"K4 compile_smoke: exact; {t_k4:.4f} ms (plain {t_plain:.4f}, "
          f"torch.mul {t_lib:.4f}; in turns K4, mul, mul, K4: "
          + ", ".join(f"{v:.4f}" for v in t) + f"); on the device alone "
          f"{d_k4:.5f} ms, torch.mul {d_lib:.5f}")
    return dict(name="compile_smoke", route="cuda",
                source="touchgs_torch/csrc/compile_smoke.cu",
                replaces="bench.py:113", max_abs_err=0.0, ms=t_k4,
                plain_ms=t_plain, bound_ms=b[0], bound_by=b[1],
                library_ms=t_lib, device_ms=d_k4,
                library_device_ms=d_lib), loops


def host_costs(cuda_build, x, calls: int = HOST_CALLS,
               rounds: int = 3) -> None:
    """Host ns per call of each piece of a kernel wrapper's work on K4's
    input ``x``: ``perf_counter_ns`` around ``calls`` calls with no
    synchronisation in the loop, the median of ``rounds`` rounds.  The
    pieces of the launch path, then two whole calls: the K4 wrapper and
    ``torch.mul(x, 2.0)``.  The rows that launch K4 queue ``calls`` launches
    without waiting for them."""
    fn = cuda_build.launcher("compile_smoke")
    out = torch.empty_like(x)
    n, shape = x.numel(), tuple(x.shape)
    xp, op, s = x.data_ptr(), out.data_ptr(), cuda_build.current_stream()
    pieces = [
        ("empty loop", lambda: None),
        ("on_cuda", lambda: cuda_build.on_cuda(x)),
        ("check_tensor", lambda: cuda_build.check_tensor(
            x, "x", torch.float32, shape)),
        ("torch.empty_like", lambda: torch.empty_like(x)),
        ("data_ptr()", x.data_ptr),
        ("current_stream: raw handle", cuda_build.current_stream),
        ("launcher lookup", lambda: cuda_build.launcher("compile_smoke")),
        ("ctypes call with the launch", lambda: fn(xp, op, n, s)),
        ("ctypes call, n = 0, no launch", lambda: fn(xp, op, 0, s)),
        ("compile_smoke wrapper, whole", lambda: cuda_build.compile_smoke(
            x)),
        ("torch.mul(x, 2.0), whole", lambda: torch.mul(x, 2.0)),
    ]
    print(f"host ns per call, median of {rounds} rounds of {calls} calls:")
    for name, f in pieces:
        ns = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(calls):
                f()
            ns.append((time.perf_counter_ns() - t0) / calls)
        torch.cuda.synchronize()
        print(f"  {name:32s} {np.median(ns):9.1f}")


def flagship_inputs(dev):
    """Projection, SH colours and binning of the flagship state on the
    card, with the packed attributes and the kernels' per-tile inputs."""
    from touchgs_torch.config import RasterizeConfig
    from touchgs_torch.models.gaussians import init_random
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops.projection import project_gaussians, view_directions
    from touchgs_torch.ops.sh import eval_sh
    from touchgs_torch.ops.tiles import bin_gaussians
    from touchgs_torch.tools.pair_stats import bench_camera

    rcfg = RasterizeConfig(use_pallas=True)
    params = init_random(n=N_GAUSSIANS, capacity=CAPACITY, sh_degree=3,
                         device=dev)
    cam = bench_camera(WIDTH, HEIGHT, dev)
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
                n_chunks=n_chunks, tile_ids=tile_ids,
                N=proj.means2d.shape[0], th=rcfg.tile_h, tw=rcfg.tile_w,
                n_tx=bins.n_tiles_x)


def path_bounds(x: dict, distinct: int, scanned: int) -> tuple:
    """Bounds of K1 with rows, K2 and K3 on one view's tile inputs ``x``:
    ``distinct`` rows the lists name, ``scanned`` entries K2 scanned."""
    from touchgs_torch.ops import rasterize_plain as plain

    n_tiles, k_tile = x["n_tiles"], x["k_tile"]
    npix = x["th"] * x["tw"]
    live_slots = int(x["capped"].sum())
    slots = n_tiles * k_tile
    stack_bytes = n_tiles * plain.ROWS * npix * 4
    row_bytes = plain.A * 4
    # K1 with rows: each input read once (the distinct rows the lists
    # name), each output written once
    b1r = bound(4 * (2 * n_tiles + live_slots + slots)
                + row_bytes * (distinct + slots))
    b2 = bound(scanned * row_bytes + 8 * n_tiles + stack_bytes,
               fp32_ops=scanned * npix * FWD_OPS_PER_PAIR)
    b3 = bound(scanned * row_bytes + 8 * n_tiles + 2 * stack_bytes
               + slots * row_bytes,
               fp32_ops=scanned * npix * BWD_OPS_PER_PAIR)
    return b1r, b2, b3


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

    # K1, the lists alone and with their rows
    k1_args = (sg, starts, capped, n_tiles, k_tile, x["N"])
    attrs = x["attrs"]

    def k1():
        return rc.slot_lists(*k1_args)

    def k1_plain():
        return plain.slot_lists_plain(*k1_args)

    def k1r():
        return rc.slot_rows(attrs, *k1_args)

    def k1r_plain():
        return plain.slot_rows_plain(attrs, *k1_args)

    def k1_pair():  # what K1 with rows replaces: the lists, then a gather
        return attrs[rc.slot_lists(*k1_args)]

    gidx, gidx_p = k1(), k1_plain()
    (gidx_r, attrs_tiled), (_, rows_p) = k1r(), k1r_plain()
    torch.cuda.synchronize()
    check(torch.equal(gidx, gidx_p), "K1 slot lists differ from plain")
    check(torch.equal(gidx_r, gidx_p) and torch.equal(attrs_tiled, rows_p)
          and torch.equal(attrs_tiled, k1_pair()),
          "K1 with rows differs from plain")
    k1_err = float((gidx - gidx_p).abs().max())
    k1r_err = float((attrs_tiled - rows_p).abs().max())
    distinct = int(torch.unique(gidx).numel())
    print(f"K1 with rows: gidx and rows equal to plain and to "
          f"attrs[gidx]; {distinct} distinct rows")

    # K2
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

    t_k1, t_k1p = 1e3 * measure(k1, iters=50), 1e3 * measure(k1_plain)
    t_k1r, t_k1rp = 1e3 * measure(k1r, iters=50), 1e3 * measure(k1r_plain)
    t_pair = 1e3 * measure(k1_pair, iters=50)
    tb = [batched_ms(f, 20) for f in (k1r, k1_pair, k1_pair, k1r)]
    tb_k1r, tb_pair = (tb[0] + tb[3]) / 2, (tb[1] + tb[2]) / 2
    dev_k1r, dev_pair = device_ms(k1r), device_ms(k1_pair)
    t_k2 = 1e3 * measure(k2, iters=20)
    t_k2p = 1e3 * measure(k2_plain, iters=2, warmup=0)
    t_k3 = 1e3 * measure(k3, iters=20)
    t_k3p = 1e3 * measure(k3_plain, iters=2, warmup=0)

    b1 = bound(4 * (2 * n_tiles + live_slots + n_tiles * k_tile))
    b1r, b2, b3 = path_bounds(x, distinct, scanned)
    slots = n_tiles * k_tile
    per_slot = bound(4 * (2 * n_tiles + live_slots + slots)
                     + 2 * plain.A * 4 * slots)
    print(f"K1 with rows: {t_k1r:.4f} ms per call, {tb_k1r:.4f} ms queue-"
          f"full (plain {t_k1rp:.3f}); the pair slot_lists + attrs[gidx] "
          f"{t_pair:.4f} per call, {tb_pair:.4f} queue-full; in turns K1r, "
          f"pair, pair, K1r: " + ", ".join(f"{v:.4f}" for v in tb))
    print(f"K1 with rows device time (profiler): {dev_k1r:.4f} ms, the "
          f"pair's {dev_pair:.4f} ms")
    print(f"K1 with rows bound: {b1r[0]:.5f} ms ({distinct} distinct rows "
          f"read once), {100 * b1r[0] / dev_k1r:.1f}% of its device time; "
          f"{per_slot[0]:.5f} ms with a row read per slot")
    return [
        dict(name="slot_lists", route="cuda",
             source="touchgs_torch/csrc/slot_lists.cu",
             replaces="touchgs_tpu/ops/rasterize_pallas.py:468",
             max_abs_err=k1_err, ms=t_k1, plain_ms=t_k1p, bound_ms=b1[0],
             bound_by=b1[1], library_ms=None),
        dict(name="slot_rows", route="cuda",
             source="touchgs_torch/csrc/slot_lists.cu",
             replaces="touchgs_tpu/ops/rasterize_pallas.py:468",
             max_abs_err=k1r_err, ms=t_k1r, plain_ms=t_k1rp, bound_ms=b1r[0],
             bound_by=b1r[1], library_ms=t_pair, batched_ms=tb_k1r,
             library_batched_ms=tb_pair, device_ms=dev_k1r,
             library_device_ms=dev_pair,
             library_note="rc.slot_lists then attrs[gidx], the path K1 with "
             "rows replaces"),
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


def ssim_inputs(dev, h: int, w: int) -> tuple:
    """A render and its ground truth, (H, W, 3) from a seed, the second the
    first plus noise, and the cotangent the loss gives the SSIM (minus its
    weight); the images as the loss reads them, through their channel-major
    views."""
    rng = np.random.default_rng(h * w)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    x, y = (torch.as_tensor(v, device=dev).permute(2, 0, 1) for v in (a, b))
    return x, y, torch.tensor(-0.2, device=dev)


def phase_ssim_kernels(dev) -> list:
    """Phase 3: ``ssim_fwd`` and ``ssim_bwd`` against their plain versions
    at each of SSIM_SHAPES: the value and dL/dx, timed per call beside the
    plain versions and the band-matrix path they replace
    (``ssim_cm_band``, its forward and its autograd backward), on the
    device, and against their bounds."""
    from touchgs_torch.ops.ssim import (ssim_bwd, ssim_bwd_plain,
                                        ssim_cm_band, ssim_fwd,
                                        ssim_fwd_plain)

    c1, c2 = 0.01**2, 0.03**2
    shapes = {"ssim_fwd": {}, "ssim_bwd": {}}
    for h, w in SSIM_SHAPES:
        x, y, grad = ssim_inputs(dev, h, w)
        v, maps = ssim_fwd(x, y, c1, c2, True)
        v_p, maps_p = ssim_fwd_plain(x, y, c1, c2, True)
        dx = ssim_bwd(x, y, maps, grad)
        dx_p = ssim_bwd_plain(x, y, maps_p, grad)
        torch.cuda.synchronize()
        v_err = abs(float(v) - float(v_p))
        g_err = float((dx - dx_p).abs().max())
        g_max = float(dx_p.abs().max())
        name = f"{w}x{h}x3"
        print(f"SSIM {name}: value {float(v):.7f}, error {v_err:.3e} "
              f"({v_err / abs(float(v_p)):.3e} relative, limit "
              f"{SSIM_VALUE_RTOL:g}); dL/dx error {g_err:.3e} "
              f"({g_err / g_max:.3e} of its largest, limit "
              f"{SSIM_GRAD_TOL:g}); dL/dx strides {dx.stride()}")
        check(v_err <= SSIM_VALUE_RTOL * abs(float(v_p)),
              f"ssim_fwd {name}: value outside tolerance")
        check(g_err <= SSIM_GRAD_TOL * g_max,
              f"ssim_bwd {name}: dL/dx outside tolerance")
        check(dx.stride() == x.stride(), f"ssim_bwd {name}: dL/dx strides")

        xr = x.detach().requires_grad_()
        vb = ssim_cm_band(xr, y)

        def fwd():
            return ssim_fwd(x, y, c1, c2, True)

        def bwd():
            return ssim_bwd(x, y, maps, grad)

        runs = {
            "ssim_fwd": (fwd, lambda: ssim_fwd_plain(x, y, c1, c2, True),
                         lambda: ssim_cm_band(xr, y), v_err,
                         SSIM_FWD_VALUES, SSIM_FWD_OPS),
            "ssim_bwd": (bwd, lambda: ssim_bwd_plain(x, y, maps_p, grad),
                         lambda: torch.autograd.grad(vb, xr, grad,
                                                     retain_graph=True),
                         g_err, SSIM_BWD_VALUES, SSIM_BWD_OPS),
        }
        n = x.numel()
        for kernel, (fn, plain_fn, lib_fn, err, values, ops) in runs.items():
            b = bound(4 * values * n, fp32_ops=ops * n)
            print(f"  {kernel} {name} on the device:")
            shapes[kernel][name] = dict(
                max_abs_err=err, ms=1e3 * measure(fn, iters=50),
                plain_ms=1e3 * measure(plain_fn),
                library_ms=1e3 * measure(lib_fn), device_ms=device_ms(fn),
                bound_ms=b[0], bound_by=b[1])
        design = bound(4 * SSIM_DESIGN_VALUES * n)[0]
        pair = sum(shapes[k][name]["device_ms"] for k in shapes)
        least = sum(shapes[k][name]["bound_ms"] for k in shapes)
        print(f"SSIM {name}: the pair {pair:.4f} ms on the device, "
              f"{100 * least / pair:.1f}% of its bound {least:.5f} ms; this "
              f"design's {SSIM_DESIGN_VALUES} values a pixel and channel "
              f"{design:.5f} ms ({100 * design / pair:.1f}%)")
        for k in shapes:
            r = shapes[k][name]
            print(f"  {k} {name}: {r['ms']:.4f} ms a call (plain "
                  f"{r['plain_ms']:.3f}, band path {r['library_ms']:.3f}), "
                  f"device {r['device_ms']:.5f}, bound {r['bound_ms']:.5f} "
                  f"({r['bound_by']})")
        del xr, vb
    first = f"{SSIM_SHAPES[0][1]}x{SSIM_SHAPES[0][0]}x3"
    return [
        dict(name=k, route="cuda", source="touchgs_torch/csrc/ssim.cu",
             replaces="none: touchgs_tpu/ops/ssim.py::_blur_cm's band-matrix "
             "products", **{f: shapes[k][first][f] for f in shapes[k][first]},
             max_abs_err_all=max(r["max_abs_err"]
                                 for r in shapes[k].values()),
             shapes=shapes[k],
             library_note="ssim_cm_band, the band-matrix products with "
             "autograd: " + ("its forward" if k == "ssim_fwd" else
                             "its autograd backward"))
        for k in shapes]


def cell_shade_state(name: str, dev, seed: int = 7) -> tuple:
    """(params, camera, model config) of a cell's start state: the
    benchmark's polish state of the configuration ``SHADE_CELLS[name]``
    from ``seed`` and the first view of its camera path, as
    ``perfbench`` makes them."""
    from pathlib import Path

    from perfbench import job
    from perfbench.scene import analytic, state
    from touchgs_torch.data.cameras import Camera
    from touchgs_torch.models.gaussians import GaussianParams

    path = (Path(__file__).resolve().parent / "perfbench" / "configs"
            / f"{SHADE_CELLS[name]}.json")
    cfg = json.loads(path.read_text())
    st = state.surface_state(cfg, {"start": {"step": 15000,
                                             "adam_nu": 1e-6}}, seed, dev)
    s = cfg["scene"]
    u = np.random.default_rng(seed).uniform(size=(s["views"] + 1, 4))
    c2w = analytic.camera_poses(s["camera"], s["views"], u)[0]

    def t(v):
        return torch.tensor(np.float32(v), device=dev)

    fx, fy, cx, cy = analytic.intrinsics(cfg)
    cam = Camera(fx=t(fx), fy=t(fy), cx=t(cx), cy=t(cy),
                 c2w=torch.as_tensor(c2w.astype(np.float32), device=dev),
                 width=s["width"], height=s["height"])
    return (GaussianParams(**st["params"]), cam,
            job.train_config(cfg, seed).model)


def shade_errors(fwd, ref) -> dict:
    """How the forward kernel's outputs stand to the op chain's: the
    largest distance in units of the chain's last place of the table,
    means2d and depths, and the radii, cull radii and validity that
    differ."""
    def ulps(a, b):
        mag = b.abs()
        spacing = torch.nextafter(mag, torch.full_like(mag, float("inf"))
                                  ) - mag
        return float(((a - b).abs() / spacing).max())

    names = ("table", "means2d", "depths", "radii", "cull_radii", "valid")
    out = {f"{n}_ulps": ulps(fwd[i], ref[i]) for i, n in enumerate(names[:3])}
    out.update({f"{n}_differ": int((fwd[i] != ref[i]).sum())
                for i, n in enumerate(names) if i >= 3})
    return out


def shade_cotangent(table, valid, seed: int = 3):
    """A seeded cotangent of the packed table on the valid rows, as K3 and
    the scatter-add hand it to the stage: zero elsewhere."""
    g = torch.Generator(device=table.device)
    g.manual_seed(seed)
    grad = torch.randn(table.shape, generator=g, device=table.device)
    C = valid.shape[0]
    grad[C:] = 0
    grad[:C] *= valid[:, None]
    return grad


def phase_shade_kernels(dev) -> list:
    """Phase 4: ``shade_fwd`` and ``shade_bwd`` on the cells' start
    states against the op chain (``shade_fwd_plain``) and its autograd
    backward, and timed at 131072 and 1,048,576: per call, on the device,
    beside the chain's forward and autograd backward and the written-out
    plain backward, against their bounds (SHADE_FWD_BYTES and
    SHADE_BWD_BYTES a Gaussian)."""
    from touchgs_torch.ops import shade as sh

    shapes = {"shade_fwd": {}, "shade_bwd": {}}
    for name in SHADE_CELLS:
        params, cam, mcfg = cell_shade_state(name, dev)
        groups = tuple(getattr(params, g) for g in sh.GROUPS)
        C = params.capacity
        w2c = cam.w2c
        off = torch.zeros((C, 2), device=dev)
        args = (params.alive, off, cam, w2c, mcfg, 3, 512)
        fwd = sh.shade_fwd(groups, *args)
        leaves = [g.detach().clone().requires_grad_(True) for g in groups]
        off_leaf = off.clone().requires_grad_(True)
        ref = sh.shade_fwd_plain(tuple(leaves), params.alive, off_leaf,
                                 *args[2:])
        err = shade_errors(fwd, [r.detach() for r in ref])
        grad = shade_cotangent(fwd[0], fwd[5])
        got = sh.shade_bwd(grad, groups, cam, w2c, mcfg, 3)
        want = torch.autograd.grad(ref[0], leaves + [off_leaf], grad,
                                   retain_graph=True)
        gerr = {}
        for g_name, a, b in zip(list(sh.GROUPS) + ["offset"], got, want):
            gerr[g_name] = float((a - b).abs().max()) / max(
                float(b.abs().max()), 1e-30)
            gerr[f"{g_name}_zero_rows_kept"] = bool(
                (a.reshape(C, -1)[~fwd[5]] == 0).all())
        alive = int(params.alive.sum())
        print(f"SHADE {name} ({alive} live of {C}, {int(fwd[5].sum())} "
              f"valid in view): forward against the op chain {err}; "
              f"backward against autograd, of each group's largest: {gerr}")
        check(err["table_ulps"] <= SHADE_ULPS
              and err["means2d_ulps"] <= SHADE_ULPS
              and err["depths_ulps"] <= SHADE_ULPS,
              f"shade_fwd {name}: floats past {SHADE_ULPS} ulp")
        check(err["radii_differ"] == err["cull_radii_differ"]
              == err["valid_differ"] == 0,
              f"shade_fwd {name}: radii, cull radii or validity differ")
        check(all(v <= SHADE_GRAD_TOL for k, v in gerr.items()
                  if not k.endswith("_kept")) and all(
                      v for k, v in gerr.items() if k.endswith("_kept")),
              f"shade_bwd {name}: gradients outside tolerance")
        if name not in SHADE_TIMED:
            continue
        def chain_fwd():
            return sh.shade_fwd_plain(tuple(leaves), params.alive, off_leaf,
                                      *args[2:])

        runs = {
            "shade_fwd": (lambda: sh.shade_fwd(groups, *args), chain_fwd,
                          None, SHADE_FWD_BYTES),
            "shade_bwd": (
                lambda: sh.shade_bwd(grad, groups, cam, w2c, mcfg, 3),
                lambda: torch.autograd.grad(ref[0], leaves + [off_leaf],
                                            grad, retain_graph=True),
                lambda: sh.shade_bwd_plain(grad, groups, cam, w2c, mcfg,
                                           3),
                SHADE_BWD_BYTES),
        }
        cap = f"{C}"
        for kernel, (fn, chain_fn, plain_fn, nbytes) in runs.items():
            b = bound(nbytes * C)
            print(f"  {kernel} at {cap} on the device:")
            dev_ms = device_ms(fn)
            print(f"  the op chain's {kernel[-3:]} at {cap} on the device:")
            chain_dev = device_ms(chain_fn)
            shapes[kernel][cap] = dict(
                ms=1e3 * measure(fn, iters=50), device_ms=dev_ms,
                chain_ms=1e3 * measure(chain_fn), chain_device_ms=chain_dev,
                plain_ms=(1e3 * measure(plain_fn, iters=5) if plain_fn
                          else None),
                bound_ms=b[0], bound_by=b[1],
                max_abs_err=(err if kernel == "shade_fwd" else gerr))
            r = shapes[kernel][cap]
            print(f"SHADE {kernel} at {cap}: {r['ms']:.4f} ms a call, device "
                  f"{dev_ms:.5f} ms ({100 * b[0] / dev_ms:.1f}% of its bound "
                  f"{b[0]:.5f} ms, {b[1]}); the op chain {r['chain_ms']:.4f} "
                  f"ms a call, device {chain_dev:.5f} ms; plain "
                  f"{r['plain_ms']}")
        del ref, want, leaves
        torch.cuda.empty_cache()
    first = str(131072)
    return [
        dict(name=k, route="cuda", source="touchgs_torch/csrc/shade.cu",
             replaces="none: the JAX package leaves projection, SH and "
             "packing to XLA", **{f: v for f, v in shapes[k][first].items()
                                  if f != "max_abs_err"},
             max_abs_err=shapes[k][first]["max_abs_err"], shapes=shapes[k],
             library_ms=None,
             library_note="the op chain (splatfacto.shade, _attr_rows): "
             + ("its forward" if k == "shade_fwd" else
                "its autograd backward") + " as chain_ms")
        for k in shapes]


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


def check_forward_without_exit(nc, tids, attrs_tiled, geom) -> None:
    """K2 with ``early_exit=False`` against its plain version: rgb/acc/T
    3e-5, depth 3e-4, and every chunk of each list composited; timed."""
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
    t = 1e3 * measure(k2, iters=20)
    t_p = 1e3 * measure(k2_plain, iters=2, warmup=0)
    print(f"K2 without exit (k_chunk {k_chunk}) errors: rgb/acc/T "
          f"{err_rgba:.3e} (tol 3e-5), depth {err_d:.3e} (tol 3e-4); "
          f"{int(want.sum()) * k_chunk} entries composited; {t:.4f} ms "
          f"(plain {t_p:.1f} ms)")


def phase_train(dev) -> dict:
    """Phase 5: the main path as the cells run it, untimed: the blender
    cell's ``Trainer`` resumed at its polish state by ``perfbench``'s
    driver, then ``Trainer.run`` for TRAIN_STEPS steps, the counters zeroed
    before it.  Returns the run's launch counts."""
    from pathlib import Path

    from perfbench import job
    from perfbench.drivers.resumed_job import ResumedJob
    from perfbench.scene import analytic
    from touchgs_torch.ops import cuda_build
    from touchgs_torch.train.graphs import GraphedStep
    from touchgs_torch.train.trainer import Trainer

    root = Path(__file__).resolve().parent / "perfbench"
    cfg = json.loads((root / "configs" / f"{SHADE_CELLS['blender800']}.json")
                     .read_text())
    traffic = json.loads((root / "traffic" / "polish.json").read_text())
    run = ResumedJob(cfg, traffic, TRAIN_SEED, dev)
    run.trainer = Trainer(
        job.program_scene(cfg, analytic.make_scene(cfg, TRAIN_SEED, dev)),
        job.train_config(cfg, TRAIN_SEED), dev)
    run.start(lambda msg: None)
    t = run.trainer
    step0 = t.state.step
    for k in cuda_build.launches:
        cuda_build.launches[k] = 0
    t.run(step0 + TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = dict(cuda_build.launches)
    print(f"train: steps {step0}-{t.state.step - 1}, "
          f"{int(t.state.params.num_alive)} alive of "
          f"{t.state.params.capacity}, captures "
          f"{t.events['capture']}; launches {counts}")
    check(isinstance(t.train_step, GraphedStep)
          and t.events["capture"] >= 1,
          "the training step did not run as a captured graph")
    want = {**dict.fromkeys(counts, 0),
            **dict.fromkeys(TRAIN_PATH, TRAIN_STEPS)}
    check(counts == want, f"train: launch counts {counts}, want {want}")
    return counts


def phase_anatomy_path() -> tuple:
    """Phase 6: the profiling path as ``python -m touchgs_torch.tools.
    exp_kernel_anatomy --bf16`` runs it: each of its kernels must launch.
    Returns its inputs and its launch counts."""
    from touchgs_torch.ops import anatomy, cuda_build
    from touchgs_torch.tools import exp_kernel_anatomy as tool

    before = dict(cuda_build.launches)
    t0 = time.time()
    x, probe, _ = tool.run_tool(["--bf16"])
    torch.cuda.synchronize()
    counts = {k: n - before[k] for k, n in cuda_build.launches.items()}
    print(f"anatomy path: {time.time() - t0:.1f} s; launches {counts}")
    path_kernels = ["compile_smoke", "slot_lists", "composite_fwd",
                    *(f"anatomy_{m}" for m in anatomy.MODES),
                    *(f"bf16_probe_{leg}" for leg in anatomy.PROBE_DTYPES)]
    check(all(counts[k] >= 1 for k in path_kernels),
          f"the anatomy path launched none of "
          f"{[k for k in path_kernels if counts[k] < 1]}")
    return x, probe, counts


def tile_errors(out, ref) -> tuple:
    """(max abs error, max of each tile's error over its largest output)"""
    diff = (out - ref).abs().amax(dim=(1, 2))
    scale = ref.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    return float(diff.max()), float((diff / scale).max())


def sm_clock_mhz(fn, timeout_s: float = 60.0) -> float:
    """The SM clock (MHz) that nvidia-smi reads while ``fn`` runs back to
    back on the card."""
    import subprocess

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], stdout=subprocess.PIPE, text=True)
    t0 = time.time()
    while proc.poll() is None:
        if time.time() - t0 > timeout_s:
            proc.kill()
            raise RuntimeError("chip_smoke: nvidia-smi did not answer")
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    return float(proc.stdout.read().split()[0])


def roofs(ms: float, bound_ms: float, loop: dict, pairs: int,
          clock_mhz: float) -> dict:
    """A probe's time against its bound and against the issue roof: its
    entry loop's SASS a pair at one instruction a lane and clock (4 warp
    instructions a clock on each SM), and the MUFU floor at 16 MUFU results
    a clock and SM.  Times in ms, shares of the measured time."""
    lane_clocks = (torch.cuda.get_device_properties(0).multi_processor_count
                   * clock_mhz * 1e6)
    issue = loop["sass"] * pairs / (128 * lane_clocks) * 1e3
    mufu = loop["mufu"] * pairs / (16 * lane_clocks) * 1e3
    return dict(bound_share=bound_ms / ms, sass_per_pair=loop["sass"],
                issue_ms=issue, issue_share=issue / ms, mufu_ms=mufu,
                mufu_share=mufu / ms)


def phase_anatomy(x, probe, loops: dict) -> list:
    """The anatomy's kernels against their plain versions on its inputs;
    returns the K5 and K6 entries of the kernels line.  Each is timed per
    call (``measure``, the wrapper's host work included) and queue-full
    (``batched_ms``, the device's time); the attribution of K2's time, bf16
    against f32 and the roofs (``roofs``, from the entry loops ``loops`` of
    ``print_sass``) read the queue-full times."""
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
    check_forward_without_exit(x.nc, x.tids, x.at, x.geom)
    q = {"exit": batched_ms(k2, 20), "noexit": batched_ms(
        lambda: rc.forward_tiles(x.nc, x.tids, x.at, *x.geom,
                                 early_exit=False), 20)}

    out_bytes = n_tiles * 2 * npix * 4
    result = []
    for mode in anatomy.MODES:
        args = (mode, x.nc, x.tids, x.at, *x.geom)
        err, rel = tile_errors(anatomy.variant(*args),
                               anatomy.variant_plain(*args))
        torch.cuda.synchronize()
        print(f"K5 {mode}: max error {err:.3e}, {rel:.3e} of the tile's "
              f"largest output (tol 3e-5)")
        check(rel <= 3e-5, f"K5 {mode} outside tolerance")
        t = 1e3 * measure(lambda: anatomy.variant(*args), iters=20)
        q[mode] = batched_ms(lambda: anatomy.variant(*args), 20)
        t_p = 1e3 * measure(lambda: anatomy.variant_plain(*args), iters=3,
                            warmup=1)
        b = bound(entries * plain.A * 4 + 8 * n_tiles + out_bytes,
                  fp32_ops=anatomy.OPS_PER_PAIR[mode] * entries * npix)
        result.append(dict(
            name=f"anatomy_{mode}", route="cuda",
            source="touchgs_torch/csrc/anatomy_variants.cu",
            replaces="tools/exp_kernel_anatomy.py:132", max_abs_err=err,
            ms=t, batched_ms=q[mode], plain_ms=t_p, bound_ms=b[0],
            bound_by=b[1], library_ms=None, library_note="no single PyTorch "
            "call composites these ablations"))
    tool.print_attribution(q, entries, npix)

    n_probe = probe["f32"].shape[0]
    pairs = n_probe * anatomy.PROBE_ROWS * anatomy.PROBE_NPIX
    # rows whose α reaches every part of a tile (the probe's own light only
    # its first pixels)
    spread = tool.probe_inputs(133, probe["f32"].device, spread=True)
    for leg, at in probe.items():
        out, ref = anatomy.bf16_probe(at), anatomy.bf16_probe_plain(at)
        s_rel = tile_errors(anatomy.bf16_probe(spread[leg]),
                            anatomy.bf16_probe_plain(spread[leg]))[1]
        torch.cuda.synchronize()
        err, rel = tile_errors(out, ref)
        tol = 1e-5 if leg == "f32" else 2.0 ** -6
        print(f"K6 {leg}: max error {err:.3e}, {rel:.3e} of the tile's "
              f"largest output (tol {tol:.3g}); on 133 tiles of spread rows "
              f"{s_rel:.3e}")
        check(rel <= tol and s_rel <= tol, f"K6 {leg} outside tolerance")
        t = 1e3 * measure(lambda: anatomy.bf16_probe(at), iters=20)
        q[leg] = batched_ms(lambda: anatomy.bf16_probe(at), 20)
        t_p = 1e3 * measure(lambda: anatomy.bf16_probe_plain(at), iters=3,
                            warmup=1)
        chain = anatomy.PROBE_CHAIN_OPS * pairs
        sums = anatomy.PROBE_SUM_OPS * pairs
        b = bound(at.numel() * at.element_size() + n_probe * 1024 * 4,
                  fp32_ops=sums + (chain if leg == "f32" else 0),
                  bf16_ops=chain if leg == "bf16" else 0)
        result.append(dict(
            name=f"bf16_probe_{leg}", route="cuda",
            source="touchgs_torch/csrc/bf16_probe.cu",
            replaces="tools/exp_kernel_anatomy.py:205", max_abs_err=err,
            ms=t, batched_ms=q[leg], plain_ms=t_p, bound_ms=b[0],
            bound_by=b[1], library_ms=None, library_note="no single PyTorch "
            "call computes the α-sum probe"))
    print(f"bf16 probe, queue-full: f32 {q['f32']:.4f} ms, bf16 "
          f"{q['bf16']:.4f} ms, bf16 runs {q['f32'] / q['bf16']:.2f}x the "
          f"f32 rate")

    args = ("alpha_only", x.nc, x.tids, x.at, *x.geom)
    clock = sm_clock_mhz(lambda: anatomy.variant(*args))
    P = plain.pixels_per_thread(npix)
    print(f"queue-full times against the roofs, at the SM clock nvidia-smi "
          f"read under K5 alpha_only, {clock:.0f} MHz:")
    for k in result:
        if k["name"].startswith("anatomy_"):
            loop, n = loops[f"{k['name']}_p{P}"], entries * npix
        else:
            loop, n = loops[k["name"]], pairs
        r = roofs(k["batched_ms"], k["bound_ms"], loop, n, clock)
        k["sm_clock_mhz"] = clock
        print(f"  {k['name']}: {k['batched_ms']:.4f} ms; bound "
              f"{k['bound_ms']:.4f} ms ({100 * r['bound_share']:.1f}%); issue "
              f"roof {r['issue_ms']:.4f} ms at {r['sass_per_pair']:.2f} "
              f"SASS a pair ({100 * r['issue_share']:.1f}%); MUFU floor "
              f"{r['mufu_ms']:.4f} ms ({100 * r['mufu_share']:.1f}%)")
    return result


def batched_ms(fn, calls: int, batches: int = 5) -> float:
    """Median over ``batches`` of the CUDA-event time of ``calls`` calls
    back to back, per call: the median of several batches where
    ``measure`` takes the mean of one.  The queue stays full, so the time
    leaves out the host's work between two launches where the device is
    the slower (the old kernels are launched without the wrappers'
    argument checks)."""
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


def device_ms(fn, calls: int = 20) -> float:
    """Device time per call of the kernels ``fn`` launches, from
    torch.profiler over ``calls`` calls: for each kernel its mean time per
    recorded launch times its launches per call (the profiler may drop a
    launch's record), summed.  Unlike ``batched_ms`` it leaves out the idle
    gaps of a queue the host cannot keep full; the kernels are printed with
    their times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = 0.0
    for e in kernels:
        per_call = max(1, round(e.count / calls))
        ms = e.device_time_total / e.count / 1e3 * per_call
        total += ms
        print(f"    {ms:.5f} ms a call, {per_call}x ({e.count} launches "
              f"recorded)  {e.key[:80]}")
    return total


def ab_sass(cb, names, old) -> None:
    """For the A/B: ptxas's registers of the libraries ``names`` as built
    from ``old`` (the last build's log: none where an earlier process
    built them, as it has when ``old`` holds the same sources), and the
    entry loops of the old and the new build (P = 4 where a kernel has
    several instances)."""
    for name in names:
        if cb.build_dir(old) == cb.build_dir():
            print(f"  old {name}: the same sources as the new")
        elif name not in cb.build_logs:
            print(f"  old ptxas {name}: built before this process, no log")
        for line in cb.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  old ptxas {name}: {line.strip()}")
        for tag, src in (("old", old), ("new", cb.CSRC)):
            for f, loop in cb.sass_loop_counts(name, src).items():
                if not re.search(r"_p[12]$", sass_name(f)):
                    print(f"  {tag} {sass_name(f)}:")
                    entry_loop(sass_name(f), loop)


def ab_time(name: str, fo, fn, rounds: int) -> None:
    """``fo`` (old) and ``fn`` (new) timed in turns old, new, new, old, each
    ``batched_ms`` over ``rounds`` launches."""
    t = [batched_ms(f, rounds) for f in (fo, fn, fn, fo)]
    print(f"A/B {name}: old {t[0]:.4f}, new {t[1]:.4f}, new {t[2]:.4f}, "
          f"old {t[3]:.4f} ms; old/new {(t[0] + t[3]) / (t[1] + t[2]):.3f}x")


def phase_ab(dev, old, rounds: int = 20) -> None:
    """K2 and K3 of this tree against the same two kernels built from the
    sources in the directory ``old`` (an earlier commit's
    ``touchgs_torch/csrc``, with the same launch signatures) at the flagship
    shapes: the pairs held against each other, then timed in turns
    (``ab_time``)."""
    from pathlib import Path

    from touchgs_torch.ops import cuda_build as cb
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops import rasterize_plain as plain

    old = Path(old).resolve()
    x = flagship_inputs(dev)
    geom = (x["th"], x["tw"], x["k_tile"], x["k_chunk"], x["n_tx"], x["rcfg"])
    th, tw, k_tile, k_chunk, n_tx, cfg = geom
    n_tiles, nc, tids = x["n_tiles"], x["n_chunks"], x["tile_ids"]
    _, at = rc.slot_rows(x["attrs"], x["bins"].sorted_gauss,
                         x["bins"].tile_starts, x["capped"], n_tiles, k_tile,
                         x["N"])
    stack_shape = (n_tiles, plain.ROWS, th * tw)
    tail = (n_tiles, th, tw, k_tile, k_chunk, n_tx, cfg.alpha_clip,
            cfg.alpha_threshold)

    def old_fwd():
        out = torch.empty(stack_shape, device=dev)
        cb.launch("composite_fwd", nc.data_ptr(), tids.data_ptr(),
                  at.data_ptr(), out.data_ptr(), *tail, 1, src=old)
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
        cb.launch("composite_bwd", done.data_ptr(), tids.data_ptr(),
                  at.data_ptr(), f_new.data_ptr(), g.data_ptr(),
                  out.data_ptr(), *tail, src=old)
        return out

    def new_bwd():
        return rc.backward_tiles(done, tids, at, f_new, g, *geom)

    b_old, b_new = old_bwd(), new_bwd()
    torch.cuda.synchronize()
    # the versions sum the cancelling per-pixel terms in different orders,
    # so they differ by float32 rounding of those sums, not of the results
    err = float((b_old - b_new).abs().max())
    scale = float(b_old.abs().max())
    print(f"A/B against {old}: K2 chunks_done and T equal; K3 max abs "
          f"{err:.3e} of largest {scale:.3e}")
    check(err <= 1e-4 * scale, "A/B: K3 versions disagree")
    ab_sass(cb, ("composite_fwd", "composite_bwd"), old)
    ab_time("composite_fwd", old_fwd, new_fwd, rounds)
    ab_time("composite_bwd", old_bwd, new_bwd, rounds)


def phase_ab_anatomy(dev, old, rounds: int = 20) -> None:
    """K5 and K6 of this tree against the same two kernels built from the
    sources in ``old``, on the anatomy's tiles and the probe's rows: each K5
    mode within 3e-5 of the tile's largest output with an equal T row, each
    K6 leg within its tolerance (f32 1e-5, bf16 2^-6), then timed in turns
    (``ab_time``)."""
    from pathlib import Path

    from touchgs_torch.ops import anatomy
    from touchgs_torch.ops import cuda_build as cb
    from touchgs_torch.tools import exp_kernel_anatomy as tool

    old = Path(old).resolve()
    x, probe = tool.anatomy_inputs(), tool.probe_inputs()
    th, tw, k_tile, k_chunk, n_tx, cfg = x.geom
    n_tiles, npix = x.at.shape[0], th * tw
    timed = []
    for i, mode in enumerate(anatomy.MODES):
        def old_k5(i=i, mode=mode):
            out = torch.empty((n_tiles, 2, npix), device=dev)
            scratch = (torch.empty((n_tiles, 4, npix), device=dev)
                       if mode == "full" else None)
            cb.launch("anatomy_variants", x.nc.data_ptr(),
                      x.tids.data_ptr(), x.at.data_ptr(), out.data_ptr(),
                      None if scratch is None else scratch.data_ptr(), i,
                      n_tiles, th, tw, k_tile, k_chunk, n_tx, cfg.alpha_clip,
                      cfg.alpha_threshold, key=f"anatomy_{mode}", src=old)
            return out

        def new_k5(mode=mode):
            return anatomy.variant(mode, x.nc, x.tids, x.at, *x.geom)

        o, n = old_k5(), new_k5()
        torch.cuda.synchronize()
        rel = tile_errors(n, o)[1]
        t_equal = torch.equal(o[:, 1], n[:, 1])
        print(f"A/B K5 {mode}: {rel:.3e} of the tile's largest output (tol "
              f"3e-5); T equal: {t_equal}")
        check(rel <= 3e-5 and t_equal, f"A/B: K5 {mode} versions disagree")
        timed.append((f"anatomy_{mode}", old_k5, new_k5))
    for leg, at in probe.items():
        def old_k6(at=at, leg=leg):
            out = torch.empty((at.shape[0], 1, anatomy.PROBE_NPIX),
                              device=dev)
            cb.launch("bf16_probe", at.data_ptr(), out.data_ptr(),
                      int(leg == "bf16"), at.shape[0],
                      key=f"bf16_probe_{leg}", src=old)
            return out

        def new_k6(at=at):
            return anatomy.bf16_probe(at)

        o, n = old_k6(), new_k6()
        torch.cuda.synchronize()
        rel = tile_errors(n, o)[1]
        tol = 1e-5 if leg == "f32" else 2.0 ** -6
        print(f"A/B K6 {leg}: {rel:.3e} of the tile's largest output (tol "
              f"{tol:.3g})")
        check(rel <= tol, f"A/B: K6 {leg} versions disagree")
        timed.append((f"bf16_probe_{leg}", old_k6, new_k6))
    ab_sass(cb, ("anatomy_variants", "bf16_probe"), old)
    for name, fo, fn in timed:
        ab_time(name, fo, fn, rounds)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from touchgs_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card(), flush=True)
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--shade"]:
        cuda_build.build()
        print(cuda_build.build_logs.get("shade", "(shade already built)"))
        print(json.dumps({"kernels": phase_shade_kernels(dev)}))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        phase_ab(dev, sys.argv[2])
        phase_ab_anatomy(dev, sys.argv[2])
        return 0
    t_start = time.time()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    k4, loops = phase_build()
    kernels = (phase_kernels(dev) + phase_ssim_kernels(dev)
               + phase_shade_kernels(dev))
    train = phase_train(dev)
    torch.cuda.empty_cache()
    x, probe, path = phase_anatomy_path()
    kernels += [k4] + phase_anatomy(x, probe, loops)
    # a kernel of the training step counts its launches there, any other
    # (K1's lists alone, K4-K6) on the anatomy path
    for k in kernels:
        k["path"] = "train" if train[k["name"]] else "anatomy"
        k["launches"] = (train if train[k["name"]] else path)[k["name"]]
    print(f"chip_smoke: {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
