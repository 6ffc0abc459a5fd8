"""Build the port's CUDA kernels and drive its training step on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits nonzero with no result):

1. Card and build: the card's name and power limit, TF32 off, and the six
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
   K3 backward within rtol 1e-4 / atol 1e-5 on a seeded
   random cotangent (it prints whether it is bit-exact, as it should be).
   Median times over CUDA events.  Then a small scene rendered through the
   tile kernels against the dense oracle.
2b. The SSIM pair of the loss (``ssim_fwd``, ``ssim_bwd``) against their
   plain versions at 800x800x3 and 1280x720x3, read as the loss reads the
   render, through the channel-major view of an (H, W, 3) image: the value
   within rtol 1e-6 and dL/dx within 1e-5 of its largest, dL/dx laid out
   as the image; each timed per call beside its plain version and the
   band-matrix path it replaced (``ssim_cm_band``), on the device, and
   against the bound of what the function must do (SSIM_FWD_OPS and
   SSIM_BWD_VALUES; this design's own traffic printed beside it).
2c. The shade pair of every render on the card (``shade_fwd``,
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
3. The training path: ``Trainer(scene, cfg).run`` on an in-memory 4-view
   800x800 scene seeded with 100k points (capacity 131072), 5 warm-up and
   20 timed steps of the graphed step, with the launch counters set to 0
   just before and read just after (25 launches of the shade pair, K1
   with rows, K2, K3 and the SSIM pair, none of K1's lists alone: each
   replay adds its capture's counts);
   then one lossless ``Trainer.render_view``.
4. Where the step's device time goes: three more steps under
   torch.profiler, the kernels by device time and the busy share.
4a. The default render path, the scan path (``use_pallas=False``, torch
   ops, no kernel of its own): at 96x64 against the dense oracle, one
   flagship forward against the tile kernels with and without their exit
   (within rgb/acc 1e-4 and depth 1e-3 without it), then
   ``Trainer.run`` with the default ``RasterizeConfig()``, 2 warm-up and 5
   timed steps, with the launch counters set to 0 just before and read
   just after (no launch of K1-K3, the SSIM pair once a step); its median
   step and peak memory, and
   two more steps under torch.profiler.
4b. The scale demo, ``touchgs_torch.tools.train_scale_demo.main`` at
   800x800 with its 100k GT Gaussians on a short schedule (``DEMO_ARGS``):
   at least two refines, one opacity reset and one capacity growth, K1
   with rows, K2, K3 and the SSIM pair each launched (counters set to 0
   just before),
   lossless GT renders and finite eval metrics.
4c. The touch pipeline: its card path against its CPU path on the same
   inputs (``fuse_view`` at 400x400 with an injected permutation, atol
   1e-5; the GPIS fitted on each; ``render_depth_var`` at 96x96, depth
   within 1e-4 m, validity flips at most 0.1%); K1 with rows, K2 and K3
   against their plain versions on the hard scene's own view (400x400:
   13x13 tiles, the last row and column partial) at the training path's
   k_tile 512 and the GT renders' 8192, with phase 2's checks and K3 bit-
   exact, timed; then the hard scene,
   ``touchgs_torch.tools.train_hard_scene.main`` on a short schedule
   (``TOUCH_ARGS``: 8 views at 400x400, 30 patches, 600 steps, SH degree
   0) with the launch counters set to 0 just before and read just after:
   K1 with rows, K2, K3 and the SSIM pair each launched, lossless GT
   renders, finite metrics, touch on part of the sphere, and the touch arm's object depth
   MAE below the vision arm's; its stage times.
4d. The CLI, the user's entry point (``phase_cli``): a scene directory
   written at full width (12 views of 800x800, uint16-mm depth and
   uncertainty PNGs, 30k seeds) and loaded back exactly; ``cli train``
   300 steps with the ``bunny_blender`` preset through K1-K3 and the SSIM
   pair (each launched at least 300 times, counters set to 0 just before;
   as often in the SO3xR3 run below), a resume to step 400,
   ``eval``, ``render``, ``export-splat``, the ``.ply`` re-rendered within
   rgb/acc 3e-5 and depth 3e-4 of the trainer's render, and 100 steps with
   ``--camera-optimizer SO3xR3``; its times.
4e. The monocular-depth nets and the capture tooling (``phase_vision``):
   DPT-Large, ZoeD_N, ZoeD_NK and Depth-Anything-Small at their published
   widths on random weights from a seed (``tools/random_checkpoint.py``),
   written as npz files under a temporary directory and read back by the
   real loader; one image through each on the CPU and on the card, max
   |card − CPU| within VISION_TOL of the depth's range, and a run with
   TF32 on shown to miss it; ms an image and peak memory.  Then ``cli
   pipeline`` on a 12-view 800x800 capture directory (touch points for
   gpis-render, the GT depths as the aligning depths) with ``--zoe-weights``
   the ZoeD_N npz: every stage runs and is timed, ``zoe_depth/`` holds a
   positive depth map a view, the eval metrics are finite, and K1 with
   rows, K2, K3 and the SSIM pair are each launched at least once a step
   (counters set to 0 just before;
   ``launches_pipeline`` in the kernels line).  Then ``render_pc_depth``
   and ``point_cloud_to_depth_via_mesh`` (grid 96) on the scale demo's GT
   points, card against CPU, and the mesh's depth against the lossless GT
   render on the sphere.
4f. The DenseTact sensor stack (``phase_sensor``): DenseDepth and
   DenseNet_Force (numpy-seeded DenseNet-161 inits written as npz and
   loaded through ``DenseTactSensor(depth_weights=, force_weights=)``) and
   STForce (``random_checkpoint("stforce")``) at 640x640 on the CPU and on
   the card, within SENSOR_TOL of the output's range, the TF32 run shown
   to miss it; ms an image, peak memory, the operations and their bound;
   every 3x3 shape of the two DenseNets timed unfolded and through cuDNN,
   the port's way within 1.5x of the faster, and each DenseNet with and
   without ``densetact_nets.CUDNN_3X3`` in turns.  Then ``SensorLoop`` at
   30 Hz over 60 synthetic 640x640 frames with a seeded calib remap and
   the faithful nets, with and without its PNG and csv writes (per-stage
   median and 90th percentile, frames over the 33.3 ms period), and 10
   frames through the compact nets; then 20 steps of each sensor train
   step at batch 4 x 640² (losses finite and falling) and one step of the
   depth and the force net on the card against the CPU.  The launch
   counters are set to 0 just before and read after (``launches_sensor``
   in the kernels line: no kernel of the port's is on this path).
4g. The depth-supervised NeRF (``phase_nerf``): phase 4d's scene written
   and loaded again (its GT through K1 and K2), ``NerfTrainer`` at
   ``NerfConfig()``: 300 DS-NeRF steps (the loss falls) and 50 URF steps
   with σ decay, it/s, ``render_view`` of a held-out view with its PSNR and
   time, and one step on the card against the CPU with injected uniforms
   (``launches_nerf`` in the kernels line, from the scene's GT renders).
4h. The live viewer, multi-scene and sharded training
   (``phase_parallel``), each path driven with the launch counters set to
   0 just before and read just after. (a) ``Trainer.run`` on the flagship,
   20 steps without and 20 with a ``ViewerServer`` on port 0 whose page is
   played by a thread (``/state`` and a 640x480 frame every 250 ms, the
   modes in turn): K1 with rows and K2 count the steps and the frames, K3
   the steps only; after training the rgb, depth and acc frames, decoded,
   equal the trainer's own render at the same ``orbit_c2w`` camera
   quantised as the server does, byte for byte; K1 with rows and K2 on the
   frame's inputs against their plain versions; ms a frame, the round
   trip, the step median with and without the viewer (``launches_viewer``:
   the frames after training). (b) and (c) share one NCCL world of one.
   (b) 4 flagship scenes drawn from seeds: the batch's step 1 against four
   single-scene steps (loss rtol 1e-4, parameters atol 1e-5, an entry
   moved by Adam on float32 noise held as a share, ROADMAP C32), and on a
   data=1, model=1 mesh (``parallel/multiscene.py``'s mesh path, its
   gathers through NCCL) against the batch's (losses and PSNRs rtol 1e-5,
   parameters as before); K1-K3 on the batch's 2500-tile grid (the
   rank's slice of the packed grid on this model=1 mesh) against their
   plain versions (these step-1 checks run the steps eagerly, their
   ``__wrapped__``); then 25 steps of ``run_multiscene`` with two refines
   and an opacity reset, eager, unsharded (``launches_multiscene``: one of
   each kernel a step) and on the mesh (``launches_multiscene_mesh``, the
   same), the mesh run's alive counts and losses against the batch run's;
   then the same 25 steps graphed (``train/graphs.py``), unsharded
   (``launches_multiscene_graph``) and on the mesh with its NCCL gathers
   captured (``launches_mesh_graph``), each against its eager run (losses
   and PSNRs rtol 1e-3, alive counts and every state tensor equal), one
   capture a run and none at the refines and the reset; the graphed runs
   timed in turns (batch, mesh, four graphed single-scene ``Trainer`` runs
   of the same schedule, the four again, mesh, batch), printed as a ratio
   of scene-steps, with the first step (capture), the graph pool and the
   peak memory. (c) One flagship step with the tile grid in 4 slices in
   one process and one in the NCCL world of one, run eagerly, each against
   the unsharded step within the same tolerances (``launches_sharded``);
   K1's lists of each slice (``tile0``) equal the global lists' slice, and
   K1-K3 on the last slice against plain; each of the two graphed against
   its eager step over SHARD_HOLD steps (losses rtol 1e-3, every state
   tensor equal, one capture; ``launches_sharded_graph``), with the
   capture's time and the pool; the five steps (unsharded graphed, the two
   eager, the two graphed) timed in turns; ``scaling_bench`` at a world of
   one.
4i. The native layer (``phase_native``; host C++, no kernel of the
   port's): the library and both capture tools built with ``make`` from
   ``touchgs_torch/native/``; phase 4d's scene written again, then, with
   the launch counters set to 0 just before and read just after, its 36
   PNGs through ``NativeLoader`` (two threads, prefetched in a shuffled
   order) and ``decode_png``, each equal to ``data/png.py``'s decode with
   the same division exactly, ms an image; ``tgs_sync_capture --sim 1``
   taking 8 frames, replayed through ``SensorLoop`` with the compact nets
   on the card (all 8 processed, the last frame's depth and wrench within
   SENSOR_TOL of the CPU's range, ``poses.csv`` with its header and 8
   rows); ``tgs_capture`` without a camera exiting 1 with its message; a
   guarded touch on ``ArmSim`` holding 5 N (``launches_native`` in the
   kernels line: 0).  Where ``g++``, ``make``, zlib or libjpeg is missing
   it prints ``native: unavailable on this machine: ...``, checks the
   fallback of ``decode_png`` to ``data/png.py``, and goes on.
4j. The port's benchmark (``phase_bench``): ``python3 bench_torch.py``
   as a user runs it, in a process of its own on the card (5 warm-up and
   40 timed steps of the bare train step at the flagship through K1-K3,
   then its roofline report): exit 0, one JSON line with a rate above 0,
   no note and the card named, its launch line showing K4 once and K1 with
   rows, K2, K3 and the SSIM pair at least 45 times each over its steps
   (``launches_bench`` in the kernels line), its census with no lossy
   tile; its stderr echoed and its headline beside the train phase's
   median step.  Then ``touchgs_torch.tools.pair_stats`` on the card at
   k_tile 1024, its total pairs equal to the flagship's binning, and the
   pairs it keeps at the default k_tile 512.
4k. The compiled step (``train/graphs.py``; ``make_train_step`` returns
   it on the card, with or without SO3xR3 and ``tile_shards``, so phases
   3, 4, 4d (its SO3xR3 run too) and 4j already run it): (a) right
   after phase 4, from two copies of the train phase's state,
   GRAPH_STEPS steps with the plain step (``__wrapped__``) and as many
   as a CUDA graph on the same views at SH degree 3, each step's loss and
   PSNR within rtol 1e-3, one capture, K1 with rows, K2, K3 and the SSIM
   pair exactly GRAPH_STEPS launches each on each side (counters set to 0 just before
   each; the warm-up's counted apart), the parameter gap, the capture's
   time and the graph pool's size; (c) the two timed in turns (eager,
   graphed, graphed, eager) and profiled: median steps, the busy share
   and the device operations a step.  (b) after phase 4d, ``Trainer.run``
   on 4d's scene, graphed and eager, GRAPH_TRAIN_STEPS steps on a
   schedule with refines, an opacity reset, two SH-degree steps and a
   k_tile escalation from 128: eval PSNR within 0.1 dB, alive within 1%,
   the captures bounded (``launches_graph`` and
   ``launches_graph_trainer`` in the kernels line); then its SO3xR3 leg
   (``phase_graph_pose``): a pose ``Trainer`` on the same scene, graphed
   and eager, GRAPH_POSE_STEPS steps over every training view at SH 0 and
   1: one capture per SH degree across every view, none eager, losses and
   pose deltas rtol 1e-3 (``launches_pose_graph``), the pool; then the
   graphed pose step timed in turns against the non-pose graphed step.
4l. The experiment tools (``phase_tools``): the eight ports of the root
   ``tools/exp_*.py`` under ``touchgs_torch/tools/``, each ``main`` at
   TOOLS_ITERS calls a row, with the launch counters set to 0 just before
   and read just after; each must exit 0 (``FAILED`` rows are printed as
   findings).  ``exp_tile_size`` holds K2 and K3 against their plain
   versions on the bench's tiles at its five geometries (32x32, 32x64,
   64x64 at k_tile 2048 and 1024, 16x32), then the phase holds them at
   12x12 (144 pixels, not a multiple of 32): K3 equal, K2's T row and
   chunks_done equal, rgb/acc 3e-5, depth 3e-4.
5. The profiling path: ``python -m touchgs_torch.tools.exp_kernel_anatomy
   --bf16``'s work (K4, the flagship's tiles at k_chunk 128, K2 with and
   without its exit, the four K5 ablations, the two K6 probe legs), with
   the launch counters set to 0 just before and read just after.
6. The anatomy's kernels against their plain versions on the same inputs:
   K2 at k_chunk 128 with and without its exit (as in phase 2); each K5 mode
   within 3e-5 of each tile's largest output; K6 f32 within 1e-5 and bf16
   within 2^-6 of it, on the probe's rows and on rows spread over the
   whole tile.  Times per call (median over CUDA events) and
   queue-full (``batched_ms``); from the queue-full times the attribution
   of K2's time, the fp32 rate alpha_only sustains, f32 against bf16 and,
   at the SM clock nvidia-smi reads under load, printed lines of each K5
   mode's and K6 leg's time against its bound, its issue roof (its entry
   loop's SASS a pair at one instruction a lane and clock) and its MUFU
   floor (``roofs``, models, kept out of the kernels line).
7. One ``kernels`` JSON line (fifteen entries of measured times, errors and
   launches and the computed ``bound_ms``; ``launches`` from the
   training path for its kernels, from the anatomy path for the others;
   the training path's kernels also carry ``launches_hard_scene``,
   ``launches_cli``, ``launches_pipeline``, ``launches_sensor``,
   ``launches_nerf``, ``launches_viewer``, ``launches_multiscene``,
   ``launches_multiscene_mesh``, ``launches_sharded``,
   ``launches_native``, ``launches_graph`` and
   ``launches_graph_trainer``; K1-K3 also ``parallel_max_abs_err``
   (phase 4h's errors
   against plain) and, under ``hard_scene``, their errors, times and
   bounds at both of its k_tiles; K1-K4 and the SSIM pair also
   ``launches_bench``; the SSIM pair also ``device_ms`` and, under
   ``shapes``, its readings at each of phase 2b's sizes; the shade pair
   ``device_ms``, the op chain's ``chain_ms`` and ``chain_device_ms``
   and, under ``shapes``, its readings at both of phase 2c's capacities;
   K2 and
   K3 also ``launches_tools`` and ``tile_sweep``, their largest error
   against plain at each of phase 4l's geometries),
   then the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits with status 1 before doing anything.

    python3 chip_smoke.py --vision

runs phase 4e alone, and

    python3 chip_smoke.py --sensor

phases 4f and 4g alone, and

    python3 chip_smoke.py --parallel

phase 4h alone, and

    python3 chip_smoke.py --native

phase 4i alone, and

    python3 chip_smoke.py --bench

phase 4j alone, and

    python3 chip_smoke.py --graph

phase 4k alone (its (b) on a scene written as phase 4d writes it), and

    python3 chip_smoke.py --tools

phase 4l alone.

    python3 chip_smoke.py --shade

builds the kernels, prints ptxas's report of the shade kernels and runs
phase 2c alone.

    python3 chip_smoke.py --ab OLD_CSRC

instead builds K2, K3, K5 and K6 from the directory OLD_CSRC as well (an
earlier commit's ``touchgs_torch/csrc``, unpacked with ``git archive`` into
a gitignored directory such as ``.archive/``), holds each pair of versions
against each other and times them in turns, K2 and K3 at the flagship
shapes (``phase_ab``), K5 on the anatomy's tiles and K6 on the probe's rows
(``phase_ab_anatomy``).
"""
from __future__ import annotations

import contextlib
import dataclasses
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
# phase 2b: the SSIM pair at the cells' image sizes (H, W), three channels,
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
# phase 2c: the shade pair on two cells' start states (the benchmark's
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
# the kernels every training step launches once: the shade pair, K1 with
# rows, K2, K3 and the SSIM pair of its loss; the SO3xR3 step, whose camera
# takes a gradient, shades through the op chain (POSE_PATH)
TRAIN_PATH = ("slot_rows", "composite_fwd", "composite_bwd", "ssim_fwd",
              "ssim_bwd", "shade_fwd", "shade_bwd")
POSE_PATH = TRAIN_PATH[:5]
PROFILE_STEPS = 3   # training steps under torch.profiler, after the timed ones
HOST_CALLS = 10_000  # calls a round of the host-cost table
K4_CALLS = 200       # CUDA-event medians of K4 and torch.mul
PROFILE_TOP = 15    # kernels listed by device time
SCAN_WARMUP, SCAN_TIMED = 2, 5   # scan-path training steps
SCAN_PROFILED = 2                # and under torch.profiler
# the scale demo's short schedule: 2048 seeds start the capacity at 4096;
# refines at steps 300 to 600 (refine stops at 720 - 100), densifying at
# 300, 400 and 600 and pruning at each; an opacity reset at 450.  Each
# refine first grows the capacity if more than 60% of it is alive; on an
# H100 one densify left 2413 of 4096 alive (59%), so three get a chance
DEMO_ARGS = ["--steps", "720", "--polish", "100", "--seed-points", "2048",
             "--reset-opacity-every", "450", "--views", "8",
             "--render-dir", ""]
# the hard scene's A/B on a short schedule: its 400x400 images end in
# partial tiles, and its SH degree 0 model has a (C, 0, 3) sh_rest
TOUCH_ARGS = ["--views", "8", "--size", "400", "--touch-patches", "30",
              "--steps", "600", "--sh-degree", "0"]
TOUCH_FUSE_SIZE = 400        # fuse_view, card against CPU
TOUCH_MARCH_SIZE = 96        # render_depth_var, card against CPU
# phase 4d, the CLI on a scene directory written at full width
CLI_VIEWS, CLI_SIZE, CLI_SEEDS = 12, 800, 30_000
CLI_STEPS, CLI_RESUME, CLI_POSE_STEPS = 300, 400, 100
CLI_FLAGS = ["--preset", "bunny_blender", "--max-gaussians", str(CAPACITY)]
# phase 4e, the monocular-depth nets at their published widths on random
# weights (``tools/random_checkpoint.py``), each at its processor's size
VISION_NETS = {"dpt": 384, "zoe_n": (384, 512), "zoe_nk": (384, 512),
               "depth_anything": 518}
VISION_SEED = 11
# max |card − CPU| over the range of the CPU's depth (ZoeDepth's random
# heads give a narrow band, 0.64-0.73): fp32 with TF32 off on both read at
# most 1.4e-5, the TF32 runs 9.2e-4 to 5.9e-3 on an H100 (PERF.md §6), so
# the TF32 run of each net must miss it
VISION_TOL = 1e-4
# ``cli pipeline`` on a capture directory: 12 views of 800x800 as phase 4d
# writes them, touch points for gpis-render, the GT depths as the aligning
# (sparse) depths, ZoeD_N at full width in stage 3
PIPE_TOUCHES, PIPE_STEPS = 256, 100
MESH_GRID = 96
# phase 4f, the DenseTact sensor stack at the published widths (640² input,
# cam_ros.py:113,125) on random weights (``tools/random_checkpoint.py``)
SENSOR_SIZE, SENSOR_SEED = 640, 13
SENSOR_NETS = ("densetact_depth", "densetact_force", "stforce")
# max |card − CPU| over the output's range, as phase 4e's VISION_TOL
SENSOR_TOL = 1e-4
LOOP_FRAMES, LOOP_COMPACT_FRAMES, LOOP_HZ = 60, 10, 30.0
# the JAX package's own train-step tests' rates: 2e-4 for the depth net
# ("higher lr saturates the sigmoid head", tests/test_sensor_losses.py:194;
# at 1e-3 the silog run sat at 10.307 from step 6 on an H100), 1e-3 force
TRAIN_BATCH, TRAIN_STEPS = 4, 20
TRAIN_LR = {"densetact": 2e-4, "silog": 2e-4, "force": 1e-3}
# phase 4g, the NeRF at NerfConfig() on phase 4d's scene
NERF_DS_STEPS, NERF_URF_STEPS = 300, 50
# phase 4i, the native layer: phase 4d's scene through the threaded loader
# in a shuffled order; a simulated capture replayed through the sensor loop
NATIVE_THREADS, NATIVE_SEED = 2, 17
CAPTURE_FRAMES, CAPTURE_HZ = 8, 20.0
# the guarded touch of tests/test_native.py: a yaw base and two pitch links
# (standard DH rows a, alpha, d, theta), pressed 3 cm into a plane at 5 N
ARM_DH = [[0.0, -np.pi / 2, 0.4, 0.0], [0.4, 0.0, 0.0, 0.0],
          [0.3, 0.0, 0.0, 0.0]]
ARM_MASS = [2.0, 1.5, 0.8]
ARM_COM = [[0.0, 0.0, 0.2], [0.2, 0.0, 0.0], [0.15, 0.0, 0.0]]
ARM_Q0 = [0.0, -0.4, 0.8]
ARM_K, ARM_D = [600.0] * 3 + [30.0] * 3, [50.0] * 3 + [3.0] * 3
ARM_STEPS, ARM_F_STOP = 12_000, 5.0
# phase 4j: the time limit of bench_torch.py, run in a process of its own
BENCH_TIMEOUT_S = 300
# phase 4k, the graphed step: (a) eager and graphed steps from one flagship
# state at the full SH degree, then (c) GRAPH_TIMED steps a turn; (b) a
# Trainer on phase 4d's scene, graphed and eager, on a schedule that
# refines at 50, 100, ..., 250 (densifying at 100 and 150), resets the
# opacities at 200, raises the active SH degree at 100 and 200, and starts
# at k_tile 128 so that the truncation guard escalates
GRAPH_STEPS, GRAPH_TIMED, GRAPH_SH, GRAPH_SEED = 25, 20, 3, 7
GRAPH_TRAIN_STEPS, GRAPH_K_TILE, GRAPH_LOG_EVERY = 300, 128, 10
GRAPH_DENSIFY = dict(warmup_steps=50, refine_every=50,
                     reset_opacity_every=200)
GRAPH_SH_INTERVAL = 100
# phase 4k (b), the SO3xR3 leg: a pose Trainer on 4d's scene, graphed and
# eager, GRAPH_POSE_STEPS steps over every training view at SH degrees 0
# and 1; then GRAPH_TIMED steps a turn against the non-pose graphed step
GRAPH_POSE_STEPS, GRAPH_POSE_SH_INTERVAL = 40, 20


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
    t = [median_ms(f, K4_CALLS) for f in (k4, mul, mul, k4)]
    t_k4, t_lib = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    t_plain = median_ms(lambda: cuda_build.compile_smoke_plain(x), K4_CALLS)
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
    from touchgs_torch.ops.projection import project_gaussians, view_directions
    from touchgs_torch.ops.sh import eval_sh
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
    return tile_inputs(rcfg, proj, colors, opac, WIDTH, HEIGHT)


def tile_inputs(rcfg, proj, colors, opac, width: int, height: int) -> dict:
    """Binning of one projected view under ``rcfg``, with the packed
    attributes and the tile kernels' per-tile inputs."""
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops.tiles import bin_gaussians

    with torch.no_grad():
        bins = bin_gaussians(proj, width, height, rcfg)
        attrs = rc._pack_attrs(proj, colors, opac)
    n_tiles = bins.n_tiles_x * bins.n_tiles_y
    k_tile, k_chunk = rcfg.k_tile, rcfg.k_chunk
    capped = torch.clamp(bins.tile_counts, max=k_tile).contiguous()
    n_chunks = ((capped + k_chunk - 1) // k_chunk).to(torch.int32)
    tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=attrs.device)
    return dict(rcfg=rcfg, bins=bins, attrs=attrs, n_tiles=n_tiles,
                k_tile=k_tile, k_chunk=k_chunk, capped=capped,
                n_chunks=n_chunks, tile_ids=tile_ids,
                N=proj.means2d.shape[0], th=rcfg.tile_h, tw=rcfg.tile_w,
                n_tx=bins.n_tiles_x, proj=proj, colors=colors, opac=opac)


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

    t_k1, t_k1p = median_ms(k1, 50), median_ms(k1_plain, 10)
    t_k1r, t_k1rp = median_ms(k1r, 50), median_ms(k1r_plain, 10)
    t_pair = median_ms(k1_pair, 50)
    tb = [batched_ms(f, 20) for f in (k1r, k1_pair, k1_pair, k1r)]
    tb_k1r, tb_pair = (tb[0] + tb[3]) / 2, (tb[1] + tb[2]) / 2
    dev_k1r, dev_pair = device_ms(k1r), device_ms(k1_pair)
    t_k2, t_k2p = median_ms(k2, 20), median_ms(k2_plain, 2, warmup=0)
    t_k3, t_k3p = median_ms(k3, 20), median_ms(k3_plain, 2, warmup=0)

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
    """Phase 2b: ``ssim_fwd`` and ``ssim_bwd`` against their plain versions
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
                max_abs_err=err, ms=median_ms(fn, 50),
                plain_ms=median_ms(plain_fn, 10),
                library_ms=median_ms(lib_fn, 10), device_ms=device_ms(fn),
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
    """Phase 2c: ``shade_fwd`` and ``shade_bwd`` on the cells' start
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
                ms=median_ms(fn, 50), device_ms=dev_ms,
                chain_ms=median_ms(chain_fn, 10), chain_device_ms=chain_dev,
                plain_ms=(median_ms(plain_fn, 5) if plain_fn else None),
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


def small_scene(dev) -> tuple:
    """300 seeded Gaussians projected at 96x64: (proj, colors, opacities,
    width, height, config)."""
    from touchgs_torch.config import RasterizeConfig
    from touchgs_torch.data.cameras import Camera
    from touchgs_torch.ops.projection import project_gaussians

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
    return proj, colors, opac, w, h, cfg


def against_dense(name: str, out, ref, n: int, w: int, h: int) -> None:
    """``out`` within rgb/acc 1e-4 and depth 1e-3 of the dense oracle."""
    e_rgb = float((out.rgb - ref.rgb).abs().max())
    e_acc = float((out.acc - ref.acc).abs().max())
    e_d = float((out.depth - ref.depth).abs().max())
    print(f"{name} vs dense oracle ({w}x{h}, {n} gaussians): rgb "
          f"{e_rgb:.2e}, acc {e_acc:.2e}, depth {e_d:.2e}")
    check(e_rgb <= 1e-4 and e_acc <= 1e-4 and e_d <= 1e-3,
          f"{name} disagrees with the dense oracle")


def phase_reference(dev) -> None:
    """A small scene through the tile kernels against the dense oracle."""
    from touchgs_torch.ops.rasterize_cuda import rasterize_cuda
    from touchgs_torch.ops.rasterize_ref import rasterize_dense

    proj, colors, opac, w, h, cfg = small_scene(dev)
    with torch.no_grad():
        out = rasterize_cuda(proj, colors, opac, w, h, cfg)
        ref = rasterize_dense(proj, colors, opac, w, h, cfg)
    against_dense("tile kernels", out, ref, len(opac), w, h)


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
    """The main path; returns the launch counts of its 25 steps, the
    trainer and the median step (ms)."""
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
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(scene, cfg)
    check(trainer.state.params.capacity == CAPACITY,
          f"capacity {trainer.state.params.capacity}, want {CAPACITY}")
    print(f"trainer init: {time.time() - t0:.1f} s, capacity "
          f"{trainer.state.params.capacity}, alive "
          f"{int(trainer.state.params.num_alive)}")

    zero_launches()
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
    # K1 with rows takes the place of K1's lists and PyTorch's gather
    want = {k: 0 if k == "slot_lists" else n_steps for k in counts}
    check(counts == want, f"launch counts {counts}, want {want}")

    out = trainer.render_view(0)
    torch.cuda.synchronize()
    check(tuple(out.rgb.shape) == (HEIGHT, WIDTH, 3)
          and bool(torch.isfinite(out.rgb).all())
          and bool(torch.isfinite(out.depth).all()),
          "lossless render is not finite")
    print(f"render_view: lossless, rgb mean {float(out.rgb.mean()):.4f}, "
          f"lossy tiles {int(out.lossy_tiles)}")
    return counts, trainer, med


def zero_launches() -> None:
    from touchgs_torch.ops import rasterize_cuda as rc

    for k in rc.launches:
        rc.launches[k] = 0


def phase_scan(dev, card: str, kernel_step_ms: float) -> None:
    """The default render path, the scan path (``use_pallas=False``): at
    96x64 against the dense oracle; one flagship forward against the tile
    kernels (with their exit and without: the scan path has none); then
    ``Trainer.run`` with the default ``RasterizeConfig()`` on the flagship
    scene, SCAN_WARMUP + SCAN_TIMED steps with the launch counters set to 0
    just before and read just after: no tile kernel may launch."""
    from touchgs_torch.config import ModelConfig, TrainConfig
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops.rasterize_ref import rasterize_dense
    from touchgs_torch.ops.rasterize_tiled import rasterize_tiled
    from touchgs_torch.train.trainer import Trainer

    proj, colors, opac, w, h, cfg = small_scene(dev)
    with torch.no_grad():
        out = rasterize_tiled(proj, colors, opac, w, h, cfg)
        ref = rasterize_dense(proj, colors, opac, w, h, cfg)
    against_dense("scan path", out, ref, len(opac), w, h)

    x = flagship_inputs(dev)
    args = (x["proj"], x["colors"], x["opac"], WIDTH, HEIGHT, x["rcfg"])
    kw = dict(bins=x["bins"], k_tile=x["k_tile"])

    def scan():
        return rasterize_tiled(*args, **kw)

    with torch.no_grad():
        out = scan()
        for exit_ in (True, False):
            ref = rc.rasterize_cuda(*args, **kw, early_exit=exit_)
            torch.cuda.synchronize()
            errs = [float((getattr(out, k) - getattr(ref, k)).abs().max())
                    for k in ("rgb", "acc", "depth")]
            print(f"scan path vs tile kernels {'with' if exit_ else 'without'}"
                  f" their exit, flagship forward: rgb {errs[0]:.3e}, acc "
                  f"{errs[1]:.3e}, depth {errs[2]:.3e}")
            check(all(np.isfinite(errs)), "scan path: non-finite forward")
        # without the exit both composite the same lists
        check(errs[0] <= 1e-4 and errs[1] <= 1e-4 and errs[2] <= 1e-3,
              "scan path disagrees with the tile kernels without their exit")
        t_scan = median_ms(scan, 5, warmup=1)
        t_kern = median_ms(lambda: rc.rasterize_cuda(*args, **kw), 5)
    print(f"flagship forward, no grad: scan path {t_scan:.3f} ms, tile "
          f"kernels {t_kern:.3f} ms")
    del x, args, out, ref

    scene = make_scene()
    cfg = TrainConfig(model=ModelConfig(max_gaussians=CAPACITY, sh_degree=3),
                      view_cache_bytes=1 << 30, log_every=1)
    check(not cfg.model.rasterize.use_pallas, "the default is not the scan "
          "path")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(scene, cfg)
    zero_launches()
    trainer.run(SCAN_WARMUP)
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    trainer.run(SCAN_WARMUP + SCAN_TIMED,
                log_fn=lambda m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    counts = dict(rc.launches)
    step_ms = np.diff(stamps) * 1e3
    med = float(np.median(step_ms))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in trainer.history]
    print(f"scan path train: losses {', '.join(f'{v:.6f}' for v in losses)}; "
          f"launches {counts}")
    print(f"scan path train: median step {med:.3f} ms over {SCAN_TIMED} steps "
          f"(min {step_ms.min():.3f}, max {step_ms.max():.3f}), peak memory "
          f"{peak:.2f} GiB; the tile kernels' median step {kernel_step_ms:.3f}"
          f" ms in this run; on {card}")
    check(len(step_ms) == SCAN_TIMED, f"{len(step_ms)} timed scan steps")
    # no tile kernel; the loss's SSIM pair runs on every path, once a step
    want = {k: SCAN_WARMUP + SCAN_TIMED if k in ("ssim_fwd", "ssim_bwd")
            else 0 for k in counts}
    check(counts == want, f"the scan path's launches {counts}, want {want}")
    check(all(np.isfinite(losses)), "scan path: non-finite loss")
    check(all("lossy_tiles" not in m for m in trainer.history),
          "the scan path reported lossy_tiles")
    phase_profile(lambda: trainer.run(trainer.state.step + SCAN_PROFILED),
                  SCAN_PROFILED, "scan path profile")


def phase_demo(card: str) -> None:
    """``touchgs_torch.tools.train_scale_demo.main`` at 800x800 with its
    100k GT Gaussians on a short schedule (DEMO_ARGS) that refines at least
    twice, resets the opacities at least once and grows the capacity at
    least once, each counted by the trainer; the launch counters set to 0
    just before and read just after: K1 with rows, K2 and K3 each launch
    (GT renders, training, lossless eval)."""
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.tools import train_scale_demo

    zero_launches()
    t0 = time.time()
    s = train_scale_demo.main(DEMO_ARGS)
    torch.cuda.synchronize()
    counts = dict(rc.launches)
    ev = s["events"]
    print(f"demo: {time.time() - t0:.1f} s on {card}; events {ev}; k_tile "
          f"escalations {s['k_tile_escalations']}; lossy census "
          f"{s['lossy_census']}; eval {s['eval']}, depth MAE "
          f"{s['eval_depth_mae_m']} m; alive {s['final_alive_gaussians']}; "
          f"launches {counts}")
    check(ev["refine"] >= 2 and ev["reset_opacity"] >= 1 and ev["grow"] >= 1,
          f"demo schedule: {ev}, want refine >= 2, reset >= 1, grow >= 1")
    check(all(counts[k] >= 1 for k in TRAIN_PATH),
          f"demo launches {counts}")
    check(all(np.isfinite(v) for v in s["eval"].values())
          and np.isfinite(s["eval_depth_mae_m"]),
          f"demo eval not finite: {s['eval']}")
    check(all(np.isfinite(v) for row in s["lossy_census"]["train"]
              for v in row), "demo lossy census not finite")
    check(s["lossy_census"]["gt_views"] == [0] * len(
        s["lossy_census"]["gt_views"]) and s["lossy_census"]["gt_views"],
          "demo GT renders lossy or not reported")


def touch_gpis(dev):
    """The hard scene's GPIS shape: 512 contacts on the 0.5 m sphere (1536
    training points), lengthscale 0.18, ε 0.05, fitted on ``dev``."""
    from touchgs_torch.touch.gpis import fit_gpis

    v = np.random.default_rng(3).normal(size=(512, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return fit_gpis((0.5 * v).astype(np.float32), v.astype(np.float32),
                    lengthscale=0.18, off_surface_eps=0.05, device=dev)


def phase_touch_card_vs_cpu(dev) -> None:
    """The touch modules' card path against their CPU path on the same
    inputs: ``fuse_view`` on one 400x400 view with an injected permutation
    (atol 1e-5); the GPIS fitted on each (posterior mean within 2e-4 and
    variance within 1e-3 over 4096 queries, the fp32 Cholesky's spread,
    ROADMAP C14); ``render_depth_var`` of the CPU's fit on a 96x96 view on
    both (depth within 1e-4 m where both are valid, validity flips at most
    0.1%).  Catches TF32 and cuSOLVER drift."""
    from touchgs_torch.touch.fusion import fuse_view
    from touchgs_torch.touch.gpis import (gpis_from_numpy, posterior,
                                          render_depth_var)
    from touchgs_torch.tools.train_scale_demo import look_at_camera

    cpu = torch.device("cpu")
    n = TOUCH_FUSE_SIZE
    rng = np.random.default_rng(0)
    vision = rng.uniform(0.5, 3.0, (n, n))
    touch = np.zeros((n, n))
    touch[100:260, 150:300] = rng.uniform(0.8, 1.2, (160, 150))
    sig = np.where(touch > 0, rng.uniform(1e-4, 0.5, (n, n)), 0.0)
    grounded = 1.5 * vision + 0.3 + rng.normal(0, 0.01, (n, n))
    perm = torch.randperm(n * n, generator=torch.Generator().manual_seed(1))
    maps = [a.astype(np.float32) for a in (grounded, touch, vision, sig)]
    ref, out = (fuse_view(None, *(torch.as_tensor(a, device=d)
                                  for a in maps), perm=perm)
                for d in (cpu, dev))
    errs = {k: float((getattr(out, k).cpu() - getattr(ref, k)).abs().max())
            for k in ref._fields}
    print(f"touch: fuse_view {n}x{n}, card against CPU: {errs}")
    check(all(e <= 1e-5 for e in errs.values()),
          f"fuse_view on the card is off the CPU's: {errs}")

    t0 = time.perf_counter()
    g_cpu = touch_gpis(cpu)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_dev = touch_gpis(dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    q = torch.as_tensor(np.random.default_rng(4).uniform(
        -0.7, 0.7, (4096, 3)).astype(np.float32))
    m_c, v_c = posterior(g_cpu, q)
    m_d, v_d = posterior(g_dev, q.to(dev))
    e_m = float((m_d.cpu() - m_c).abs().max())
    e_v = float((v_d.cpu() - v_c).abs().max())
    print(f"touch: fit_gpis ({g_dev.num_points} points) card {t_dev:.3f} s, "
          f"CPU {t_cpu:.3f} s; fitted on each, posterior over 4096 queries "
          f"differs by mean {e_m:.2e}, variance {e_v:.2e}")
    check(e_m <= 2e-4 and e_v <= 1e-3, "the card's GPIS fit is off the "
          f"CPU's: mean {e_m:.2e}, variance {e_v:.2e}")

    m = TOUCH_MARCH_SIZE
    res = []
    for d in (cpu, dev):
        g = gpis_from_numpy(g_cpu.X, g_cpu.alpha, g_cpu.L,
                            g_cpu.lengthscale, g_cpu.signal_var,
                            g_cpu.noise, off_eps=g_cpu.off_eps, device=d)
        cam = look_at_camera(eye=(2.2, 0.0, 0.8), target=(0, 0, -0.1),
                             width=m, height=m, focal=0.9 * m, device=d)
        dep, _ = render_depth_var(g, cam, near=1.3, far=2.8, n_samples=96,
                                  pixel_chunk=1024, support_var_frac=0.15)
        res.append(dep.cpu().numpy())
    c, g = res
    both = ~np.isnan(c) & ~np.isnan(g)
    flips = float((np.isnan(c) != np.isnan(g)).mean())
    e_d = float(np.abs(g - c)[both].max()) if both.any() else float("nan")
    print(f"touch: render_depth_var {m}x{m}, card against CPU: "
          f"{int(both.sum())} pixels valid on both, depth {e_d:.2e} m, "
          f"validity flips {flips:.4%}")
    check(both.sum() > 100 and e_d <= 1e-4 and flips <= 1e-3,
          "render_depth_var on the card is off the CPU's")


def hard_scene_view(dev):
    """The hard scene's GT Gaussians (its uniform matte sphere on the
    checkered plane) projected through its first ring camera at
    TOUCH_ARGS's 400x400: 13x13 tiles of 32, the last row and column
    partial.  Returns (projection, colours, opacities, size)."""
    from touchgs_torch.config import RasterizeConfig
    from touchgs_torch.ops.projection import project_gaussians
    from touchgs_torch.tools.train_hard_scene import N_SPHERE
    from touchgs_torch.tools.train_scale_demo import (build_gt_gaussians,
                                                      ring_cameras)

    size = int(TOUCH_ARGS[TOUCH_ARGS.index("--size") + 1])
    means, quats, scales, colors, opac = (
        torch.as_tensor(a, device=dev) for a in build_gt_gaussians())
    colors[:N_SPHERE] = torch.tensor((0.82, 0.82, 0.85), device=dev)
    cam = ring_cameras(8, size, size, device=dev)[0]
    with torch.no_grad():
        proj = project_gaussians(means, quats, scales, cam.w2c, cam.fx,
                                 cam.fy, cam.cx, cam.cy, size, size,
                                 RasterizeConfig(use_pallas=True),
                                 opacities=opac)
    return proj, colors, opac, size


def phase_touch_kernels(dev) -> dict:
    """K1 with rows, K2 and K3 against their plain versions on the hard
    scene's own tiles (``hard_scene_view``: 169 tiles, the last row and
    column partial), at the training path's k_tile 512 and the GT renders'
    8192 (``lossless_gt_raster``): rows and chunks_done equal, K2's T row
    equal and rgb/acc within 3e-5, depth within 3e-4, K3 bit-exact on a
    seeded random cotangent.  Returns, for each kernel, its errors, times
    (median over CUDA events) and bounds at both k_tiles."""
    from touchgs_torch.config import RasterizeConfig
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops import rasterize_plain as plain
    from touchgs_torch.tools.train_scale_demo import lossless_gt_raster

    proj, colors, opac, size = hard_scene_view(dev)
    res = {k: [] for k in ("slot_rows", "composite_fwd", "composite_bwd")}
    for rcfg in (RasterizeConfig(use_pallas=True), lossless_gt_raster(True)):
        x = tile_inputs(rcfg, proj, colors, opac, size, size)
        n_tx, n_tiles, k_tile = x["n_tx"], x["n_tiles"], x["k_tile"]
        geom = (x["th"], x["tw"], k_tile, x["k_chunk"], n_tx, rcfg)
        counts = x["bins"].tile_counts.reshape(-1, n_tx)
        check(n_tx * x["tw"] > size and int(counts[:, -1].sum()) > 0
              and int(counts[-1].sum()) > 0, "hard scene: the partial last "
              f"tile row and column hold no splat ({n_tx}x{n_tx} tiles)")
        k1_args = (x["attrs"], x["bins"].sorted_gauss, x["bins"].tile_starts,
                   x["capped"], n_tiles, k_tile, x["N"])
        nc, tids = x["n_chunks"], x["tile_ids"]

        def k1():
            return rc.slot_rows(*k1_args)

        def k1_plain():
            return plain.slot_rows_plain(*k1_args)

        (gidx, rows), (gidx_p, rows_p) = k1(), k1_plain()
        torch.cuda.synchronize()
        check(torch.equal(gidx, gidx_p) and torch.equal(rows, rows_p),
              f"hard scene k_tile {k_tile}: K1 with rows differs from plain")
        distinct = int(torch.unique(gidx).numel())

        def k2():
            return rc.forward_tiles(nc, tids, rows, *geom)

        def k2_plain():
            return plain.forward_tiles_plain(nc, tids, rows, *geom)

        fwd, fwd_p = k2(), k2_plain()
        torch.cuda.synchronize()
        rgba = torch.tensor([0, 1, 2, 4, 5], device=dev)
        err_rgba = float((fwd[:, rgba] - fwd_p[:, rgba]).abs().max())
        err_d = float((fwd[:, 3] - fwd_p[:, 3]).abs().max())
        check(torch.equal(fwd[:, plain.ROW_DONE], fwd_p[:, plain.ROW_DONE])
              and torch.equal(fwd[:, plain.ROW_T], fwd_p[:, plain.ROW_T]),
              f"hard scene k_tile {k_tile}: K2's chunks_done or T row "
              "differs from plain")
        check(err_rgba <= 3e-5 and err_d <= 3e-4, f"hard scene k_tile "
              f"{k_tile}: K2 rgb/acc/T {err_rgba:.3e}, depth {err_d:.3e}")
        done = fwd[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
        g = torch.randn(fwd.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))

        def k3():
            return rc.backward_tiles(done, tids, rows, fwd, g, *geom)

        def k3_plain():
            return plain.backward_tiles_plain(done, tids, rows, fwd, g,
                                              *geom)

        d, d_p = k3(), k3_plain()
        torch.cuda.synchronize()
        k3_err = float((d - d_p).abs().max())
        check(float(d.abs().max()) > 0 and torch.equal(d, d_p),
              f"hard scene k_tile {k_tile}: K3 not bit-exact ({k3_err:.3e})")
        scanned = int(done.sum()) * x["k_chunk"]
        bounds = path_bounds(x, distinct, scanned)
        errs = (0.0, max(err_rgba, err_d), k3_err)
        fns = ((k1, k1_plain), (k2, k2_plain), (k3, k3_plain))
        print(f"hard scene {size}x{size}, k_tile {k_tile}: {n_tiles} tiles, "
              f"{int(x['bins'].tile_counts.sum())} pairs, "
              f"{int(x['capped'].sum())} live slots, {scanned} entries "
              f"scanned; K1 rows equal, K2 rgb/acc/T {err_rgba:.3e} depth "
              f"{err_d:.3e}, K3 bit-exact")
        for (name, out), err, (fn, fn_p), b in zip(res.items(), errs, fns,
                                                   bounds):
            ms, plain_ms = median_ms(fn, 20), median_ms(fn_p, 1, warmup=0)
            out.append(dict(k_tile=k_tile, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=b[0],
                            bound_by=b[1]))
            print(f"  {name}: {ms:.4f} ms (plain {plain_ms:.3f}, bound "
                  f"{b[0]:.5f} by {b[1]})")
        del x, rows, rows_p, fwd, fwd_p, d, d_p
    return res


def phase_touch(card: str) -> dict:
    """``touchgs_torch.tools.train_hard_scene.main`` on a short schedule
    (TOUCH_ARGS), the launch counters set to 0 just before and read just
    after: K1 with rows, K2 and K3 each launch (GT renders, both arms'
    training, the lossless eval); lossless GT renders; every metric finite;
    touch covers part of the sphere; the touch arm's object depth MAE below
    the vision arm's.  Returns the launch counts."""
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.tools import train_hard_scene

    zero_launches()
    t0 = time.time()
    s = train_hard_scene.main(TOUCH_ARGS)
    torch.cuda.synchronize()
    counts = dict(rc.launches)
    a, b = s["arms"]["touchgs"], s["arms"]["vision_only"]
    print(f"touch: hard scene {time.time() - t0:.1f} s on {card}; "
          f"{s['contacts']} contacts, touch covers {s['touch_coverage']:.1%}"
          f" of the sphere; launches {counts}")
    print(f"touch: stage times {json.dumps(s['stages'])}")
    for row in (a, b):
        print(f"touch: {json.dumps(row)}")
    check(all(counts[k] >= 1 for k in TRAIN_PATH),
          f"hard scene launches {counts}")
    check(s["gt_lossy_tiles"] == [0] * len(s["gt_lossy_tiles"])
          and s["gt_lossy_tiles"], "hard scene GT renders lossy or not "
          "reported")
    check(all(np.isfinite(row[k]) for row in (a, b) for k in (
        "eval_psnr", "depth_mae_cm", "object_depth_mae_cm",
        "iters_per_sec")), f"hard scene metrics not finite: {a}, {b}")
    check(0 < s["touch_coverage"] < 1, "touch covers none or all of the "
          f"sphere: {s['touch_coverage']}")
    check(a["object_depth_mae_cm"] < b["object_depth_mae_cm"],
          f"touch arm's object depth MAE {a['object_depth_mae_cm']:.2f} cm "
          f"not below the vision arm's {b['object_depth_mae_cm']:.2f} cm")
    return counts


def phase_cli(card: str) -> tuple:
    """The user's entry point, ``python -m touchgs_torch.cli``, on a scene
    directory written at full width (``tools/write_scene.py``: the scale
    demo's GT, CLI_VIEWS views of CLI_SIZE², uint16-mm depth and
    uncertainty PNGs, CLI_SEEDS seeds): ``load_scene`` holds what was
    written exactly; ``train`` CLI_STEPS steps with the launch counters set
    to 0 just before and read just after (K1 with rows, K2 and K3 each at
    least once a step), a checkpoint and ``config.json``, a finite loss that
    falls; ``train --load-run`` resumes at CLI_STEPS and ends at CLI_RESUME;
    ``eval``, ``render`` and ``export-splat`` write their files; the
    ``.ply`` re-rendered through K1-K3 matches the trainer's render of an
    eval view within rgb/acc 3e-5 and depth 3e-4; ``train
    --camera-optimizer SO3xR3`` stays finite.  Returns the launch counts of
    the CLI_STEPS-step train and the loaded scene (phase 4k (b) trains on
    it)."""
    import tempfile
    from pathlib import Path

    from touchgs_torch import cli
    from touchgs_torch.config import SCENE_PRESETS
    from touchgs_torch.data.ply import load_gaussians_ply
    from touchgs_torch.data.png import read_rgb
    from touchgs_torch.data.scene import load_scene
    from touchgs_torch.models.splatfacto import render_lossless
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.tools.write_scene import write_scene
    from touchgs_torch.train import checkpoint as ck

    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "cli_scene", Path(tmp) / "outputs"
        t0 = time.perf_counter()
        w = write_scene(root, CLI_VIEWS, CLI_SIZE, CLI_SEEDS, "cuda")
        times["scene_write_s"] = time.perf_counter() - t0
        print(f"cli: wrote {CLI_VIEWS} views of {CLI_SIZE}x{CLI_SIZE} and "
              f"{CLI_SEEDS} seeds, {w['bytes']} bytes, in "
              f"{times['scene_write_s']:.2f} s (GT renders {w['render_s']:.2f}"
              f" s, PNG and npy writes {w['write_s']:.2f} s)")

        split = SCENE_PRESETS["bunny_blender"].train_split_fraction
        t0 = time.perf_counter()
        scene = load_scene(root, train_split_fraction=split)
        times["load_scene_s"] = time.perf_counter() - t0
        sf = scene.scale_factor
        check(np.array_equal(scene.images,
                             w["images"].astype(np.float32) / 255.0),
              "load_scene: images differ from the uint8 written / 255")
        for name, mm in (("depths", w["depth_mm"]),
                         ("uncertainties", w["unc_mm"])):
            check(np.array_equal(getattr(scene, name),
                                 mm.astype(np.float32) / 1000.0 * sf),
                  f"load_scene: {name} differ from the mm written")
        t_abs = np.abs(scene.cameras.c2w[:, :3, 3])
        check(abs(float(t_abs.max()) - 1.0) < 1e-6
              and abs(float(scene.cameras.c2w[:, :3, 3].mean(0).max()))
              < 1e-5, "load_scene: poses not centred and scaled into +/-1")
        check(len(scene.seed_points) == CLI_SEEDS, "load_scene: seeds")
        print(f"cli: load_scene {times['load_scene_s']:.2f} s, exact; "
              f"scale {sf:.6f}, {len(scene.i_train)} train and "
              f"{len(scene.i_eval)} eval views")

        base = ["--data", str(root)] + CLI_FLAGS
        zero_launches()
        t0 = time.perf_counter()
        trainer, run_a = cli.main(["train", "--max-steps", str(CLI_STEPS),
                                   "--output-dir", str(out / "a")] + base)
        torch.cuda.synchronize()
        times["train_s"] = time.perf_counter() - t0
        counts = dict(rc.launches)
        hist = trainer.history
        times["train_it_s"] = hist[-1]["iters_per_sec"]
        print(f"cli: train {CLI_STEPS} steps {times['train_s']:.1f} s "
              f"(scene load and init included), {times['train_it_s']:.2f}"
              f" it/s; loss {hist[0]['loss']:.5f} -> {hist[-1]['loss']:.5f}"
              f", alive {int(hist[-1]['num_alive'])}; launches {counts}")
        check(all(counts[k] >= CLI_STEPS for k in TRAIN_PATH),
              f"cli train launches {counts}, want >= {CLI_STEPS} each")
        check((run_a / "config.json").exists() and (
            run_a / "checkpoints" / f"{CLI_STEPS}.pt").exists(),
              f"cli train: no checkpoint or config.json in {run_a}")
        check(all(np.isfinite(m["loss"]) for m in hist)
              and hist[-1]["loss"] < hist[0]["loss"],
              f"cli train loss {[m['loss'] for m in hist]}")

        t0 = time.perf_counter()
        resumed, run_b = cli.main([
            "train", "--max-steps", str(CLI_RESUME), "--load-run",
            str(run_a), "--output-dir", str(out / "b")] + base)
        torch.cuda.synchronize()
        times["resume_s"] = time.perf_counter() - t0
        # a run from step 0 would log step 0
        check(min(m["step"] for m in resumed.history) >= CLI_STEPS
              and resumed.state.step == CLI_RESUME
              and (run_b / "checkpoints" / f"{CLI_RESUME}.pt").exists(),
              f"cli resume: first step {resumed.history[0]['step']}, "
              f"state step {resumed.state.step}")
        t0 = time.perf_counter()
        ck.CheckpointManager(Path(tmp) / "probe").save(CLI_RESUME,
                                                      resumed.state)
        times["checkpoint_save_s"] = time.perf_counter() - t0
        del trainer, resumed

        load = base + ["--load-run", str(run_b)]
        t0 = time.perf_counter()
        results = cli.main(["eval"] + load)
        times["eval_s"] = time.perf_counter() - t0
        check(all(np.isfinite(results[k]) for k in ("psnr", "ssim",
                                                   "lpips"))
              and (run_b / "eval.json").exists(),
              f"cli eval: {results}")
        rdir = cli.main(["render"] + load)
        rgbs = sorted(rdir.glob("*_rgb.png"))
        check(len(rgbs) == len(scene.i_eval) and read_rgb(rgbs[0]).shape
              == (CLI_SIZE, CLI_SIZE, 3), f"cli render: {len(rgbs)} PNGs")
        t0 = time.perf_counter()
        exported, ply = cli.main(["export-splat"] + load)
        times["export_s"] = time.perf_counter() - t0

        params = load_gaussians_ply(ply, device=exported.device)
        view = int(scene.i_eval[0])
        zero_launches()
        with torch.no_grad():
            a = render_lossless(params, scene.cameras.at(view,
                                                         exported.device),
                                exported.cfg.model,
                                active_sh_degree=exported.cfg.model.sh_degree)
            b = exported.render_view(view)
        torch.cuda.synchronize()
        ply_counts = dict(rc.launches)
        errs = {k: float((getattr(a, k) - getattr(b, k)).abs().max())
                for k in ("rgb", "acc", "depth")}
        print(f"cli: .ply of {int(params.num_alive)} splats (capacity "
              f"{params.capacity}) re-rendered, view {view}: max |err| "
              f"{errs}; launches {ply_counts}")
        check(errs["rgb"] <= 3e-5 and errs["acc"] <= 3e-5
              and errs["depth"] <= 3e-4, f"cli .ply re-render: {errs}")
        check(ply_counts["slot_rows"] >= 2 and ply_counts[
            "composite_fwd"] >= 2, f".ply renders launched {ply_counts}")
        del exported, params

        zero_launches()
        posed, _ = cli.main([
            "train", "--max-steps", str(CLI_POSE_STEPS),
            "--camera-optimizer", "SO3xR3", "--output-dir",
            str(out / "c")] + base)
        torch.cuda.synchronize()
        pose_counts = dict(rc.launches)
        pd = posed.state.pose_deltas
        print(f"cli: SO3xR3 {CLI_POSE_STEPS} steps, loss "
              f"{posed.history[-1]['loss']:.5f}, |pose delta| max "
              f"{float(pd.abs().max()):.3e}; launches {pose_counts}")
        check(all(np.isfinite(m["loss"]) for m in posed.history)
              and bool(torch.isfinite(pd).all())
              and float(pd.abs().max()) > 0,
              "cli SO3xR3: non-finite loss or pose deltas, or none moved")
        check(all(pose_counts[k] >= CLI_POSE_STEPS for k in POSE_PATH)
              and pose_counts["shade_bwd"] == 0,
              f"cli SO3xR3 launches {pose_counts}")
        del posed
    print(f"cli: times {json.dumps(times)} on {card}")
    return counts, scene


def vision_net(net: str, path):
    """The port's net for ``net`` loaded by the real loader from ``path``."""
    from touchgs_torch.vision import depth_anything, dpt, zoedepth

    return {"dpt": dpt.DPT, "zoe_n": zoedepth.ZoeDepth,
            "zoe_nk": zoedepth.ZoeDepth,
            "depth_anything": depth_anything.DepthAnything}[net].from_npz(path)


def vision_input(net: str, rgb: np.ndarray) -> torch.Tensor:
    from touchgs_torch.vision import depth_anything, dpt, zoedepth

    pre = {"dpt": dpt.preprocess, "zoe_n": zoedepth.preprocess,
           "zoe_nk": zoedepth.preprocess,
           "depth_anything": depth_anything.preprocess}[net]
    return pre(rgb, size=VISION_NETS[net], device="cpu")


def phase_vision_nets(tmp, card: str, dev) -> dict:
    """Phase 4e (a): DPT-Large, ZoeD_N, ZoeD_NK and Depth-Anything-Small at
    their published widths on random weights (``random_checkpoint``, seed
    VISION_SEED), written as npz files under ``tmp`` and read back by the
    real loader.  One seeded 480x640 image, each net's preprocess, through
    the net on the CPU and on the card: max |card − CPU| within VISION_TOL
    of the depth's range, and the same run with TF32 on (the nets' fp32
    guard bypassed) outside it; ZoeD_NK routes to the same head on both.
    Prints each net's ms an image (median over CUDA events), its peak
    memory and its times on the host.  Returns {net: npz path}."""
    from pathlib import Path

    from touchgs_torch.tools.random_checkpoint import ARCHS, random_checkpoint

    rgb = np.random.default_rng(VISION_SEED).integers(
        0, 256, (480, 640, 3), dtype=np.uint8)
    paths, rows = {}, {}
    for net in VISION_NETS:
        kind, arch = ARCHS[net]
        t0 = time.perf_counter()
        path = Path(tmp) / f"{net}.npz"
        np.savez(path, **random_checkpoint(kind, arch, VISION_SEED))
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = vision_net(net, path)
        t_load = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        img = vision_input(net, rgb)
        t0 = time.perf_counter()
        ref = model(img)
        t_cpu = time.perf_counter() - t0
        route = (int(torch.argmax(model.route(img))) if net == "zoe_nk"
                 else None)

        model = model.to(dev)
        img_c = img.to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = model(img_c).cpu()
        peak = torch.cuda.max_memory_allocated()
        ms = median_ms(lambda: model(img_c), iters=5)
        scale = max(float(ref.max() - ref.min()), 1e-30)
        err = float((out - ref).abs().max()) / scale
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            with torch.no_grad():
                out32 = type(model).forward(model, img_c).cpu()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
        err32 = float((out32 - ref).abs().max()) / scale
        rows[net] = dict(params=n_params, input=list(img.shape[:2]),
                         ms=ms, peak_gib=peak / 2**30, err=err,
                         err_tf32=err32, depth_min=float(ref.min()),
                         depth_max=float(ref.max()), cpu_s=t_cpu,
                         write_s=t_write, load_s=t_load)
        print(f"vision: {net} ({n_params} parameters, input "
              f"{tuple(img.shape[:2])}): {ms:.3f} ms an image on the card, "
              f"peak {peak / 2**30:.3f} GiB; depth {float(ref.min()):.4f}.."
              f"{float(ref.max()):.4f}; card against CPU {err:.3e} of its "
              f"range (tolerance {VISION_TOL:.0e}), with TF32 on "
              f"{err32:.3e}; CPU forward {t_cpu:.2f} s, npz written "
              f"{t_write:.2f} s, loaded {t_load:.2f} s", flush=True)
        check(out.shape == ref.shape and bool(torch.isfinite(out).all())
              and scale > 1e-3, f"vision {net}: shape {tuple(out.shape)}, "
              f"range {scale}")
        check(err <= VISION_TOL, f"vision {net}: card against CPU {err:.3e}"
              f" of its range, over {VISION_TOL:.0e}")
        check(err32 > VISION_TOL, f"vision {net}: the TF32 run reads "
              f"{err32:.3e}, inside {VISION_TOL:.0e}: the tolerance cannot "
              "tell TF32 from fp32")
        if route is not None:
            logits = model.route(img_c).cpu()
            print(f"vision: zoe_nk routes to head {route} on the CPU, "
                  f"{int(torch.argmax(logits))} on the card (logits "
                  f"{logits.tolist()})")
            check(int(torch.argmax(logits)) == route, "zoe_nk: the card "
                  "routes to another head than the CPU")
        paths[net] = path
        del model, img_c, out, out32
        torch.cuda.empty_cache()
    print(f"vision: {json.dumps(rows)} on {card}")
    return paths


def pipeline_scene(root, dev):
    """A capture directory for ``cli pipeline``: phase 4d's scene
    (``write_scene``) without what stages 5 and 6 write (the depth paths in
    transforms.json, the touch seeds), its GT depths as the aligning
    ``sparse_depths/`` of a simulated scene, and PIPE_TOUCHES touch points
    on the GT sphere, the patch nearest the first view
    (``touch_points.npy``)."""
    import shutil

    from touchgs_torch.tools.write_scene import write_scene

    w = write_scene(root, CLI_VIEWS, CLI_SIZE, CLI_SEEDS, dev)
    meta = json.loads((root / "transforms.json").read_text())
    for f in meta["frames"]:
        del f["depth_file_path"], f["uncertainty_file_path"]
    (root / "transforms.json").write_text(json.dumps(meta, indent=2))
    shutil.rmtree(root / "uncertainty")
    (root / "depth").rename(root / "sparse_depths")
    for name in ("points_touch.npy", "points_colors.npy"):
        (root / name).unlink()
    # one contact patch: the sphere's seeds nearest the first view's eye
    pts = w["points"]
    sphere = pts[np.abs(np.linalg.norm(pts, axis=1) - 0.5) < 0.03]
    eye = w["c2w"][0, :3, 3]
    near = np.argsort(np.linalg.norm(sphere - eye, axis=1))[:PIPE_TOUCHES]
    np.save(root / "touch_points.npy", sphere[near])
    return w


def phase_pipeline(tmp, zoe_npz, card: str, dev) -> dict:
    """Phase 4e (b): ``cli pipeline`` on a full-width capture directory
    (`pipeline_scene`) with ``--zoe-weights`` the ZoeD_N npz of (a):
    gpis-render, read-touch-depths, the monocular depth (ZoeD_N at 384²),
    fuse, add-depth-paths, seed, PIPE_STEPS train steps and eval, none
    skipped; each stage timed.  ``zoe_depth/`` holds a PNG a view, finite
    and positive; fusion, seeds and the depth paths are written; the eval
    metrics are finite; K1 with rows, K2 and K3 are each launched (counters
    set to 0 just before).  Returns the launch counts."""
    from pathlib import Path

    from touchgs_torch import cli
    from touchgs_torch.data.png import read_png
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.vision import monodepth

    root = Path(tmp) / "capture"
    t0 = time.perf_counter()
    pipeline_scene(root, dev)
    times = {"scene_write_s": time.perf_counter() - t0}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                times[name] = time.perf_counter() - t
        return run

    stages = {"gpis_render": "cmd_gpis_render",
              "read_touch_depths": "cmd_read_touch_depths",
              "fuse": "cmd_fuse", "add_depth_paths": "cmd_add_depth_paths",
              "seed": "cmd_seed", "train": "cmd_train", "eval": "cmd_eval"}
    saved = {fn: getattr(cli, fn) for fn in stages.values()}
    saved_predict = monodepth.VisualPipeline.predict
    for name, fn in stages.items():
        setattr(cli, fn, timed(name, saved[fn]))
    monodepth.VisualPipeline.predict = timed("monodepth", saved_predict)
    zero_launches()
    t0 = time.perf_counter()
    try:
        results = cli.main([
            "pipeline", "--data", str(root), "--max-steps", str(PIPE_STEPS),
            "--touch-points", str(root / "touch_points.npy"),
            "--zoe-weights", str(zoe_npz), "--output-dir",
            str(Path(tmp) / "outputs")] + CLI_FLAGS
            + (["--cpu"] if dev.type == "cpu" else []))
    finally:
        for fn, f in saved.items():
            setattr(cli, fn, f)
        monodepth.VisualPipeline.predict = saved_predict
    torch.cuda.synchronize()
    times["pipeline_s"] = time.perf_counter() - t0
    counts = dict(rc.launches)
    print(f"pipeline: stage times {json.dumps(times)}; launches {counts}; "
          f"eval {json.dumps(results)}")
    missing = [n for n in list(stages) + ["monodepth"] if n not in times]
    check(not missing, f"pipeline: stages that did not run: {missing}")
    zoe = sorted((root / "zoe_depth").iterdir())
    mm = np.stack([read_png(f) for f in zoe])
    print(f"pipeline: zoe_depth/ {len(zoe)} PNGs of {mm.shape[1:]}, "
          f"{int(mm.min())}..{int(mm.max())} mm")
    check(len(zoe) == CLI_VIEWS and mm.shape[1:] == (CLI_SIZE, CLI_SIZE)
          and int(mm.min()) > 0, "pipeline: zoe_depth/ is not a positive "
          "depth map a view")
    meta = json.loads((root / "transforms.json").read_text())
    check(len(list((root / "fused_output_dir").iterdir())) == CLI_VIEWS
          and (root / "points_touch.npy").exists() and meta["frames"][0][
              "depth_file_path"].startswith("fused_output_dir/"),
          "pipeline: fusion, seeds or depth paths missing")
    check(all(np.isfinite(results[k]) for k in ("psnr", "ssim", "lpips")),
          f"pipeline eval: {results}")
    check(all(counts[k] >= PIPE_STEPS for k in TRAIN_PATH),
          f"pipeline launches {counts}, want >= {PIPE_STEPS} each")
    return counts


def phase_capture(card: str, dev) -> None:
    """Phase 4e (c): the capture modules on the card against the CPU, on
    the scale demo's GT points through an 800x800 ring camera:
    ``render_pc_depth`` (splat 1) of all 100k; ``point_cloud_to_depth_via_
    mesh`` at grid MESH_GRID of the GT sphere's points that face the camera
    (``visibility_by_normals``: a one-view scan, so orienting the estimated
    normals toward the eye is right; on the whole closed sphere it flips
    the far side's, ROADMAP.md C26).  Validity flips at most 0.1%, depths
    within 1e-5 m at all but 0.1% of the pixels both hit (float32 sums in
    another order move a point across a pixel edge, or a face across the
    iso level).  The mesh's depth against the lossless GT render where the
    sphere faces the camera (cos > 0.5): median within 1 cm; its 90th
    percentile and the share of those pixels it misses are printed (the
    reference's marching tetrahedra emit nothing for a tet whose fourth
    vertex alone lies on its side of the level, C26).  Prints the times."""
    from touchgs_torch.config import ModelConfig
    from touchgs_torch.data.meshing import (estimate_normals,
                                            point_cloud_to_depth_via_mesh)
    from touchgs_torch.data.pc_depth import (render_pc_depth,
                                             visibility_by_normals)
    from touchgs_torch.models.gaussians import GaussianParams
    from touchgs_torch.models.splatfacto import render
    from touchgs_torch.ops.sh import rgb_to_sh_dc
    from touchgs_torch.tools.train_scale_demo import (assert_lossless,
                                                      build_gt_gaussians,
                                                      lossless_gt_raster,
                                                      ring_cameras)

    means, quats, scales, colors, opac = build_gt_gaussians()
    # the CPU's and the card's camera, renders and times
    devs = (torch.device("cpu"), dev)
    cams = [ring_cameras(CLI_VIEWS, CLI_SIZE, CLI_SIZE, device=d)[1]
            for d in devs]
    times, res = {}, [None, None]

    def flips_and_err(c, g):
        """(validity flips, share of the pixels both hit that differ by
        more than 1e-5 m, the largest such difference, share hit)."""
        both = (c > 0) & (g > 0)
        diff = np.abs(c - g)[both]
        return (float(((c > 0) != (g > 0)).mean()),
                float((diff > 1e-5).mean()), float(diff.max()),
                float(both.mean()))

    def timed(name, i, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[f"{name}_{('cpu', 'card')[i]}_s"] = time.perf_counter() - t0
        return out

    for i, (d, cam) in enumerate(zip(devs, cams)):
        pts = torch.as_tensor(means, device=d)
        res[i] = timed("render_pc_depth", i, lambda: render_pc_depth(
            pts, cam.w2c, cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
            cam.height)).cpu().numpy()
    pc = flips_and_err(*res)
    print(f"capture: render_pc_depth {CLI_SIZE}x{CLI_SIZE} of {len(means)} "
          f"points, card against CPU: validity flips {pc[0]:.4%}, depths "
          f"off by more than 1e-5 m at {pc[1]:.4%} (at most {pc[2]:.2e} m), "
          f"{pc[3]:.2%} of pixels hit")
    check(pc[0] <= 1e-3 and pc[1] <= 1e-3 and pc[3] > 0.05,
          "render_pc_depth on the card is off the CPU's")

    sphere = means[np.abs(np.linalg.norm(means, axis=1) - 0.5) < 1e-4]
    eye = cams[0].c2w[:3, 3].numpy()
    scan = sphere[visibility_by_normals(sphere, sphere, eye)]
    nrm = [timed("estimate_normals", i, lambda: estimate_normals(
        torch.as_tensor(scan, device=d), viewpoint=eye)).cpu()
        for i, d in enumerate(devs)]
    cos = float((nrm[0] * nrm[1]).sum(1).min())
    for i, cam in enumerate(cams):
        res[i] = timed("mesh", i, lambda: point_cloud_to_depth_via_mesh(
            scan, cam, grid_res=MESH_GRID)).cpu().numpy()
    me = flips_and_err(*res)
    print(f"capture: {len(scan)} sphere points facing the camera; "
          f"estimate_normals card against CPU: min cos {cos:.6f}; "
          f"point_cloud_to_depth_via_mesh grid {MESH_GRID}: validity flips "
          f"{me[0]:.4%}, depths off by more than 1e-5 m at {me[1]:.4%} (at "
          f"most {me[2]:.2e} m), {me[3]:.2%} of pixels hit")
    check(cos > 1 - 1e-4, f"estimate_normals on the card: min cos {cos}")
    check(me[0] <= 1e-3 and me[1] <= 1e-3 and me[3] > 0.05,
          "point_cloud_to_depth_via_mesh on the card is off the CPU's")

    def t(a):
        return torch.as_tensor(a, device=dev)

    G = len(means)
    gt = GaussianParams(
        means=t(means), quats=t(quats), log_scales=t(np.log(scales)),
        logit_opacities=t(np.log(opac / (1 - opac))),
        sh_dc=t(rgb_to_sh_dc(colors)), sh_rest=torch.zeros((G, 3, 3),
                                                           device=dev),
        alive=torch.ones((G,), dtype=torch.bool, device=dev))
    cfg = ModelConfig(max_gaussians=G, sh_degree=1,
                      rasterize=lossless_gt_raster(dev.type == "cuda"))
    with torch.no_grad():
        out = assert_lossless(render(gt, cams[1], cfg,
                                     active_sh_degree=1)[0])
    gt_depth = out.depth.cpu().numpy()
    acc = out.acc.cpu().numpy()
    # pixels whose GT surface point lies on the sphere (r = 0.5), facing
    # the camera (cos of the ray against the radial normal above 0.5)
    cam = cams[0]
    v, u = np.mgrid[0:CLI_SIZE, 0:CLI_SIZE] + 0.5
    ray = np.stack([(u - float(cam.cx)) / float(cam.fx),
                    -(v - float(cam.cy)) / float(cam.fy),
                    -np.ones_like(u)], -1) @ cam.c2w.numpy()[:3, :3].T
    world = ray * gt_depth[..., None] + eye
    facing = -(ray * world).sum(-1) / np.linalg.norm(ray, axis=-1) / 0.5
    on_sphere = ((acc > 0.99) & (np.abs(np.linalg.norm(world, axis=-1)
                                        - 0.5) < 0.01) & (facing > 0.5))
    hit = on_sphere & (res[1] > 0)
    gap = np.abs(res[1] - gt_depth)[hit] * 100
    med, p90 = float(np.median(gap)), float(np.percentile(gap, 90))
    print(f"capture: mesh depth against the lossless GT render where the "
          f"sphere faces the camera ({int(on_sphere.sum())} pixels, "
          f"{1 - hit.sum() / on_sphere.sum():.2%} missed): median "
          f"{med:.3f} cm, 90th percentile {p90:.3f} cm; times "
          f"{json.dumps(times)} on {card}")
    check(on_sphere.sum() > 1000 and med <= 1.0,
          f"the mesh misses the sphere: median {med} cm, 90th {p90} cm")


def phase_vision(card: str, dev=torch.device("cuda")) -> dict:
    """Phase 4e: the monocular-depth nets, ``cli pipeline`` with ZoeD_N,
    and the capture modules (`phase_vision_nets`, `phase_pipeline`,
    `phase_capture`); the npz files live in a temporary directory removed
    at the end.  Returns the pipeline's launch counts."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths = phase_vision_nets(tmp, card, dev)
        for net, path in paths.items():
            if net != "zoe_n":
                path.unlink()
        counts = phase_pipeline(tmp, paths["zoe_n"], card, dev)
    torch.cuda.empty_cache()
    phase_capture(card, dev)
    print(f"vision: phase 4e {time.perf_counter() - t0:.1f} s")
    return counts


def sensor_frame(seed: int = SENSOR_SEED) -> np.ndarray:
    """A SENSOR_SIZE² tactile frame: `SyntheticSource`'s bump with seeded
    noise, uint8."""
    from touchgs_torch.touch.sensor_loop import SyntheticSource

    frame = next(iter(SyntheticSource(SENSOR_SIZE, 1).frames()))
    noise = np.random.default_rng(seed).integers(-20, 21, frame.shape)
    return np.clip(frame.astype(np.int64) + noise, 0, 255).astype(np.uint8)


def calib_remap(size: int, seed: int) -> np.ndarray:
    """A seeded fisheye-like remap of a size² frame onto itself: output
    pixel (y, x) reads the raw pixel at its radius scaled by 1 + k·r² (k
    drawn from the seed), plus a seeded jitter of a third of a pixel; flat
    indices."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(0.05, 0.15)
    c = (size - 1) / 2
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    u, v = (xx - c) / c, (yy - c) / c
    s = (1 + k * (u * u + v * v)) / (1 + 2 * k)
    sx, sy = (np.clip(np.rint(c + a * s * c + rng.normal(0, 0.3, a.shape)),
                      0, size - 1).astype(np.int64) for a in (u, v))
    return sy * size + sx


def flops_of(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def table_ab(fn) -> dict:
    """``fn``'s ms (median over CUDA events) with ``densetact_nets.
    CUDNN_3X3`` as it is and with every stride-1 3×3 unfolded, in turns
    (table, unfold, unfold, table)."""
    from touchgs_torch.touch import densetact_nets

    table = densetact_nets.CUDNN_3X3
    out = {"table": [], "unfold": []}
    try:
        for mode in ("table", "unfold", "unfold", "table"):
            densetact_nets.CUDNN_3X3 = table if mode == "table" else frozenset()
            out[mode].append(median_ms(fn, iters=5))
    finally:
        densetact_nets.CUDNN_3X3 = table
    return out


def phase_sensor_nets(tmp, card: str, dev) -> dict:
    """Phase 4f (a): DenseDepth and DenseNet_Force (``random_checkpoint``'s
    numpy-seeded DenseNet inits, written as npz and loaded through
    ``DenseTactSensor(depth_weights=..., force_weights=...)``) and STForce
    at ``STFORCE_SWIN`` (``random_checkpoint("stforce")``, read back by
    ``STForce.from_npz``), at their published widths on one seeded
    SENSOR_SIZE² frame, on the CPU and on the card: max |card − CPU|
    within SENSOR_TOL of the output's range; ms an image (median over CUDA
    events), peak memory, the operations (``FlopCounterMode``) and the bound
    at the fp32 peak, and the TF32 run's error for contrast.  Then every
    stride-1 3×3 shape of the two DenseNets timed as unfold + matmul and
    through cuDNN (``profile_vision.conv_shapes``): the way the port takes
    (``densetact_nets.CUDNN_3X3``) within 1.5x of the faster.  The TF32
    run must miss SENSOR_TOL, so that the tolerance tells TF32 from fp32.
    Each DenseNet is also timed with that table and without it, in turns
    (`table_ab`).
    Returns {net: npz}."""
    from pathlib import Path

    from touchgs_torch.tools import profile_vision
    from touchgs_torch.tools.random_checkpoint import (SENSOR_ARCHS,
                                                       random_checkpoint)
    from touchgs_torch.touch import swin_force
    from touchgs_torch.touch.sensor_nets import (DenseTactSensor,
                                                 normalize_tactile)

    frame = sensor_frame()
    paths = {}
    for kind in SENSOR_NETS:
        t0 = time.perf_counter()
        paths[kind] = Path(tmp) / f"{kind}.npz"
        np.savez(paths[kind], **random_checkpoint(kind, SENSOR_ARCHS[kind][1],
                                                  SENSOR_SEED))
        print(f"sensor: {kind} npz written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    weights = dict(depth_weights=str(paths["densetact_depth"]),
                   force_weights=str(paths["densetact_force"]))
    sensors = {d: DenseTactSensor(device=d, **weights) for d in ("cpu", dev)}
    check(all(s._faithful_depth and s._faithful_force
              for s in sensors.values()), "DenseTactSensor did not pick the "
          "faithful nets for ported npz files")
    stforce = swin_force.STForce.from_npz(paths["stforce"])
    check(stforce.arch == swin_force.STFORCE_SWIN,
          f"stforce: arch {stforce.arch}")
    nets = {"densetact_depth": {d: s.depth_net for d, s in sensors.items()},
            "densetact_force": {d: s.force_net for d, s in sensors.items()},
            "stforce": {"cpu": stforce}}
    rows = {}
    for kind in SENSOR_NETS:
        model = nets[kind]["cpu"]
        x = normalize_tactile(torch.as_tensor(frame.astype(np.float32)))
        n_params = sum(p.numel() for p in model.parameters())
        t0 = time.perf_counter()
        ref = model(x)
        t_cpu = time.perf_counter() - t0
        card_model = nets[kind].get(dev) or model.to(dev)
        xc = x.to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = card_model(xc).cpu()
        peak = torch.cuda.max_memory_allocated()
        ms = median_ms(lambda: card_model(xc), iters=10, warmup=3)
        ops = flops_of(lambda: card_model(xc))
        bound_ms, _ = bound(0.0, fp32_ops=ops)
        scale = max(float(ref.max() - ref.min()), 1e-30)
        err = float((out - ref).abs().max()) / scale
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            with torch.no_grad():
                out32 = type(card_model).forward(card_model, xc).cpu()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
        err32 = float((out32 - ref).abs().max()) / scale
        rows[kind] = dict(params=n_params, gflop=ops / 1e9, ms=ms,
                          bound_ms=bound_ms, tflops=ops / ms / 1e9,
                          peak_gib=peak / 2**30, err=err, err_tf32=err32,
                          out_min=float(ref.min()), out_max=float(ref.max()),
                          cpu_s=t_cpu)
        print(f"sensor: {kind} ({n_params} parameters, {SENSOR_SIZE}²): "
              f"{ms:.3f} ms an image on the card, {ops / 1e9:.1f} GFLOP, "
              f"bound {bound_ms:.3f} ms at the fp32 peak "
              f"({100 * bound_ms / ms:.1f}%), peak {peak / 2**30:.3f} GiB; "
              f"output {float(ref.min()):.4f}..{float(ref.max()):.4f}; card "
              f"against CPU {err:.3e} of its range (tolerance "
              f"{SENSOR_TOL:.0e}), with TF32 on {err32:.3e}; CPU forward "
              f"{t_cpu:.2f} s", flush=True)
        check(out.shape == ref.shape and bool(torch.isfinite(out).all())
              and scale > 1e-6, f"sensor {kind}: shape {tuple(out.shape)}, "
              f"range {scale}")
        check(err <= SENSOR_TOL, f"sensor {kind}: card against CPU "
              f"{err:.3e} of its range, over {SENSOR_TOL:.0e}")
        check(err32 > SENSOR_TOL, f"sensor {kind}: the TF32 run reads "
              f"{err32:.3e}, inside {SENSOR_TOL:.0e}: the tolerance cannot "
              "tell TF32 from fp32")
        if kind != "stforce":
            shapes = profile_vision.conv_shapes(card_model, xc)
            rows[kind]["conv_shapes"] = shapes
            for r in shapes:
                print(f"sensor: {kind} 3x3 conv x {r['x']} w {r['w']} "
                      f"x{r['calls']}: unfold {r['unfold_ms']:.3f} ms, "
                      f"cuDNN {r['cudnn_ms']:.3f} ms; faster {r['faster']}, "
                      f"the port takes {r['port']}", flush=True)
                ms = {"unfold": r["unfold_ms"], "cudnn": r["cudnn_ms"]}
                check(ms[r["port"]] <= 1.5 * min(ms.values()),
                      f"sensor {kind}: the port's {r['port']} conv at "
                      f"{r['x']} takes {ms[r['port']]:.3f} ms, over 1.5x "
                      f"the other way's {min(ms.values()):.3f}")
            ab = table_ab(lambda: card_model(xc))
            rows[kind]["ms_table_ab"] = ab
            print(f"sensor: {kind} with the port's CUDNN_3X3 "
                  f"{ab['table']} ms, every 3x3 unfolded {ab['unfold']} ms "
                  "(in turns)", flush=True)
        if kind == "stforce":
            stforce.to("cpu")
        del out, out32, xc
        torch.cuda.empty_cache()
    print(f"sensor: nets {json.dumps(rows)} on {card}")
    return paths


def loop_stats(loop) -> dict:
    """Per stage the median and 90th percentile ms of a `SensorLoop` run,
    and the frames whose total ran over the period."""
    from touchgs_torch.touch.sensor_loop import STAGES

    out = {}
    for stage in STAGES + ("total",):
        ms = np.array([t[stage] for t in loop.frame_times]) * 1e3
        out[stage] = dict(median_ms=float(np.median(ms)),
                          p90_ms=float(np.percentile(ms, 90)))
    period = 1.0 / loop.rate_hz
    out["frames"] = len(loop.frame_times)
    out["over_period"] = int(sum(t["total"] > period
                                 for t in loop.frame_times))
    return out


def phase_sensor_loop(tmp, paths, card: str, dev) -> None:
    """Phase 4f (b): `SensorLoop`, the reference's RunCamera, over
    LOOP_FRAMES `SyntheticSource` frames of SENSOR_SIZE² with a seeded
    calib remap and the faithful depth and force nets on the card, at
    LOOP_HZ: once writing PNGs and force.csv, once without; then
    LOOP_COMPACT_FRAMES frames through the compact nets.  Prints each
    stage's median and 90th percentile and the frames over the period."""
    from pathlib import Path

    from touchgs_torch.data.png import read_png
    from touchgs_torch.touch.sensor_loop import SensorLoop, SyntheticSource
    from touchgs_torch.touch.sensor_nets import DenseTactSensor

    remap = calib_remap(SENSOR_SIZE, SENSOR_SEED)
    sensor = DenseTactSensor(
        calib_index=remap, device=dev,
        depth_weights=str(paths["densetact_depth"]),
        force_weights=str(paths["densetact_force"]))
    first = sensor.rectify(sensor_frame())
    sensor.get_depth(first), sensor.get_force(first)       # warm-up
    stats = {}
    for name, out in (("writes", Path(tmp) / "loop"), ("no_writes", None)):
        loop = SensorLoop(sensor=sensor, out_dir=out, rate_hz=LOOP_HZ)
        t0 = time.perf_counter()
        n = loop.run(SyntheticSource(SENSOR_SIZE, LOOP_FRAMES,
                                     seed=SENSOR_SEED))
        wall = time.perf_counter() - t0
        check(n == LOOP_FRAMES, f"sensor loop: {n} frames of {LOOP_FRAMES}")
        stats[name] = loop_stats(loop)
        stats[name]["wall_s"] = wall
        if out is not None:
            depths = sorted((out / "depth").iterdir())
            d = read_png(depths[-1])
            rows = (out / "force.csv").read_text().splitlines()
            check(len(depths) == LOOP_FRAMES and d.dtype == np.uint8
                  and d.shape == (SENSOR_SIZE, SENSOR_SIZE)
                  and rows[0] == "index,fx,fy,fz,tx,ty,tz"
                  and len(rows) == LOOP_FRAMES + 1,
                  f"sensor loop: {len(depths)} depth PNGs {d.shape}, "
                  f"{len(rows)} force rows")
        print(f"sensor: loop ({name}) {n} frames in {wall:.2f} s at "
              f"{LOOP_HZ} Hz, {stats[name]['over_period']} over the "
              f"{1e3 / LOOP_HZ:.1f} ms period; " + ", ".join(
                  f"{s} {v['median_ms']:.2f}/{v['p90_ms']:.2f} ms"
                  for s, v in stats[name].items() if isinstance(v, dict)),
              flush=True)
    compact = DenseTactSensor(device=dev)
    compact.get_depth(first), compact.get_force(first)
    loop = SensorLoop(sensor=compact, rate_hz=LOOP_HZ)
    check(loop.run(SyntheticSource(SENSOR_SIZE, LOOP_COMPACT_FRAMES))
          == LOOP_COMPACT_FRAMES, "sensor loop: the compact nets' frames")
    stats["compact"] = loop_stats(loop)
    print(f"sensor: loop {json.dumps(stats)} (median/p90 ms a stage) on "
          f"{card}")


def sensor_train_batch():
    """TRAIN_BATCH `SyntheticSource` frames of SENSOR_SIZE², their bump as
    the depth target (20..220) and seeded 6-vectors in [0, 1]."""
    from touchgs_torch.touch.sensor_loop import SyntheticSource

    images = np.stack(list(SyntheticSource(SENSOR_SIZE, TRAIN_BATCH)
                           .frames())).astype(np.float32)
    depths = (images[..., 0] - 120.0) / 80.0 * 200.0 + 20.0
    forces = np.random.default_rng(SENSOR_SEED).uniform(
        0, 1, (TRAIN_BATCH, 6)).astype(np.float32)
    return images, depths.astype(np.float32), forces


def sensor_train_step(kind, dev, seed: int = SENSOR_SEED):
    """A fresh compact net on ``dev`` (flax's init from a seeded generator)
    and its train step."""
    from touchgs_torch.touch import sensor_nets as sn
    from touchgs_torch.touch import sensor_train as st

    net = sn.flax_init_(sn.ForceNet() if kind == "force"
                        else sn.TouchDepthNet(),
                        torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=TRAIN_LR[kind], eps=1e-8)
    step = (st.make_force_train_step(net, opt) if kind == "force" else
            st.make_depth_train_step(net, opt, loss=kind))
    return net, step


def phase_sensor_train(card: str, dev) -> None:
    """Phase 4f (c): ``make_depth_train_step`` ("densetact" and "silog") on
    `TouchDepthNet` and ``make_force_train_step`` on `ForceNet` at
    SENSOR_SIZE² with a batch of TRAIN_BATCH: TRAIN_STEPS steps each on the
    seeded batch, the loss finite and falling (the last three steps' mean
    under the first), the median step (CUDA
    events); then one step of each net on the card against one on the CPU
    from the same parameters: the loss within rtol 1e-4, the parameters
    after within 3·lr everywhere and within 1e-5 at 95% of them (Adam turns
    float32 noise in near-zero gradients into steps of up to lr; the CPU
    tests measured at most 2.5%); TRAIN_LR is the JAX package's tests'
    rate for each net."""
    images, depths, forces = sensor_train_batch()
    rows = {}
    for kind in ("densetact", "silog", "force"):
        target = forces if kind == "force" else depths
        x, y = (torch.as_tensor(a, device=dev) for a in (images, target))
        _, step = sensor_train_step(kind, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            m = step(x, y)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
            losses.append(float(m["loss"]))
        rows[kind] = dict(step_ms=float(np.median(times[1:])),
                          first_step_ms=times[0], loss_first=losses[0],
                          loss_last=losses[-1],
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"sensor: train {kind}: {TRAIN_STEPS} steps at batch "
              f"{TRAIN_BATCH} x {SENSOR_SIZE}², median "
              f"{rows[kind]['step_ms']:.2f} ms a step (first "
              f"{times[0]:.1f}), loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
              f"peak {rows[kind]['peak_gib']:.3f} GiB", flush=True)
        check(all(np.isfinite(losses)) and np.mean(losses[-3:]) < losses[0],
              f"sensor train {kind}: losses {losses}")
    for kind in ("densetact", "force"):
        target = forces if kind == "force" else depths
        nets, metrics = {}, {}
        for d in ("cpu", dev):
            nets[d], step = sensor_train_step(kind, d, seed=SENSOR_SEED + 1)
            metrics[d] = float(step(torch.as_tensor(images, device=d),
                                    torch.as_tensor(target, device=d))["loss"])
        with torch.no_grad():
            diff = torch.cat([(p.cpu() - q).abs().flatten() for p, q in zip(
                nets[dev].parameters(), nets["cpu"].parameters())])
        share, worst = float((diff > 1e-5).float().mean()), float(diff.max())
        rel = abs(metrics[dev] - metrics["cpu"]) / abs(metrics["cpu"])
        rows[kind].update(card_vs_cpu_loss_rel=rel, params_apart=share,
                          params_max=worst)
        print(f"sensor: train {kind} one step card against CPU: loss "
              f"{metrics[dev]:.6f} / {metrics['cpu']:.6f} ({rel:.2e} "
              f"apart), {share:.3%} of the parameters more than 1e-5 apart, "
              f"at most {worst:.3e} (lr {TRAIN_LR[kind]})", flush=True)
        check(rel <= 1e-4 and share <= 0.05 and worst <= 3 * TRAIN_LR[kind],
              f"sensor train {kind}: card against CPU loss {rel:.2e}, "
              f"parameters {share:.3%} apart, at most {worst:.3e}")
    print(f"sensor: train {json.dumps(rows)} on {card}")


def phase_sensor(card: str, dev=torch.device("cuda")) -> dict:
    """Phase 4f: the DenseTact sensor stack (`phase_sensor_nets`,
    `phase_sensor_loop`, `phase_sensor_train`), with the launch counters
    set to 0 just before and read just after (no kernel of the port's is
    on this path); its npz files live in a temporary directory removed at
    the end.  Returns the launch counts."""
    import tempfile

    from touchgs_torch.ops import rasterize_cuda as rc

    t0 = time.perf_counter()
    zero_launches()
    with tempfile.TemporaryDirectory() as tmp:
        paths = phase_sensor_nets(tmp, card, dev)
        torch.cuda.empty_cache()
        phase_sensor_loop(tmp, paths, card, dev)
    torch.cuda.empty_cache()
    phase_sensor_train(card, dev)
    counts = dict(rc.launches)
    torch.cuda.empty_cache()
    print(f"sensor: phase 4f {time.perf_counter() - t0:.1f} s; launches "
          f"{counts}")
    return counts


def phase_nerf(card: str, dev=torch.device("cuda")) -> dict:
    """Phase 4g: the depth-supervised NeRF, ``NerfTrainer`` at
    ``NerfConfig()`` (8 levels of 2^15 entries, 4096 rays of 48 + 48
    samples, MLP width 64) on phase 4d's scene (`write_scene`: CLI_VIEWS
    views of CLI_SIZE², its GT rendered through K1 and K2, loaded by
    ``load_scene``): NERF_DS_STEPS steps with DS-NeRF, NERF_URF_STEPS with
    URF and σ decay; it/s, the loss at the start and the end (falling, for
    DS-NeRF), ``render_view`` of a held-out view (its PSNR against the GT
    and its time); then one step on the card against one on the CPU from
    the same parameters and pixels with injected uniforms: every metric
    within rtol 1e-4, the parameters within 3·lr everywhere and within
    1e-5 at 95% of them.  The launch counters are set to 0 just before and
    read just after.  Returns the launch counts."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from touchgs_torch.config import SCENE_PRESETS
    from touchgs_torch.data.scene import load_scene
    from touchgs_torch.models import nerf
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.tools.write_scene import write_scene

    t_phase = time.perf_counter()
    zero_launches()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "nerf_scene"
        write_scene(root, CLI_VIEWS, CLI_SIZE, CLI_SEEDS, "cuda")
        scene = load_scene(root, train_split_fraction=SCENE_PRESETS[
            "bunny_blender"].train_split_fraction)
    rows = {}
    cfg = nerf.NerfConfig()
    for name, c, steps, log_every in (
            ("ds_nerf", cfg, NERF_DS_STEPS, 50),
            ("urf", dataclasses.replace(
                cfg, depth_loss_type=nerf.NerfDepthLossType.URF,
                should_decay_sigma=True), NERF_URF_STEPS, 10)):
        trainer = nerf.NerfTrainer(scene, c, seed=0, device=dev)
        trainer.run(3)                                   # warm-up
        log = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(steps, log_every=log_every, log_fn=log.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows[name] = dict(steps=steps, it_s=steps / wall,
                          loss_first=log[0]["loss"], loss_last=log[-1]["loss"],
                          psnr_first=log[0]["psnr"], psnr_last=log[-1]["psnr"],
                          sigma=float(trainer.sigma))
        check(all(np.isfinite(m["loss"]) for m in log),
              f"nerf {name}: losses {[m['loss'] for m in log]}")
        if name == "ds_nerf":
            check(log[-1]["loss"] < log[0]["loss"], "nerf ds_nerf: the loss "
                  f"did not fall: {log[0]['loss']} -> {log[-1]['loss']}")
            view = int(scene.i_eval[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = trainer.render_view(view)
            render_s = time.perf_counter() - t0
            mse = float(np.mean((np.clip(img, 0, 1) - scene.images[view])
                                ** 2))
            rows[name].update(render_view=view, render_s=render_s,
                              psnr_view=-10 * np.log10(max(mse, 1e-10)))
            check(img.shape == scene.images[view].shape
                  and np.isfinite(img).all(), f"nerf render {img.shape}")
        print(f"nerf: {name} {json.dumps(rows[name])}", flush=True)
        del trainer
        torch.cuda.empty_cache()
    counts = dict(rc.launches)

    # one step on the card against one on the CPU, JAX-free injected draws
    u = nerf.draw_uniforms(cfg, cfg.rays_per_batch,
                           torch.Generator().manual_seed(5))
    logs = {}
    models = {}
    for d in ("cpu", dev):
        tr = nerf.NerfTrainer(scene, cfg, seed=0, device=d)
        tr.draw_uniforms = lambda d=d: tuple(a.to(d) for a in u)
        logs[d] = tr.run(1)
        models[d] = tr.model
    rel = max(abs(logs[dev][k] - logs["cpu"][k]) / max(abs(logs["cpu"][k]),
                                                       1e-12)
              for k in ("loss", "rgb_loss", "depth_loss", "distortion",
                        "psnr"))
    with torch.no_grad():
        diff = torch.cat([(p.cpu() - q).abs().flatten() for p, q in zip(
            models[dev].parameters(), models["cpu"].parameters())])
    share, worst = float((diff > 1e-5).float().mean()), float(diff.max())
    rows["card_vs_cpu"] = dict(metrics_rel=rel, params_apart=share,
                               params_max=worst)
    print(f"nerf: one step card against CPU: metrics {rel:.2e} apart "
          f"(rtol 1e-4), {share:.3%} of the parameters more than 1e-5 "
          f"apart, at most {worst:.3e} (lr {cfg.lr})", flush=True)
    check(rel <= 1e-4 and share <= 0.05 and worst <= 3 * cfg.lr,
          f"nerf card against CPU: metrics {rel:.2e}, parameters "
          f"{share:.3%} apart, at most {worst:.3e}")
    print(f"nerf: {json.dumps(rows)} on {card}; phase 4g "
          f"{time.perf_counter() - t_phase:.1f} s; launches {counts}")
    return counts


def phase_profile(run, steps: int = PROFILE_STEPS,
                  label: str = "profile") -> dict:
    """Device time by kernel over ``run()``, which takes ``steps`` more
    training steps, from torch.profiler, and the device's busy share of
    their wall time (the profiler slows the host, so the share under it is
    a lower bound).  Returns the busy and wall ms a step and the device
    operations a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    per_step = sum(e.count for e in kernels) / steps
    print(f"{label}: {steps} steps, device busy {busy_ms / steps:.3f} ms per "
          f"step of {wall_ms / steps:.3f} ms wall under the profiler "
          f"({100 * busy_ms / wall_ms:.1f}% busy); {per_step:.0f} device "
          f"operations per step, of {len(kernels)} distinct names")
    for e in kernels[:PROFILE_TOP]:
        ms = e.device_time_total / 1e3 / steps
        print(f"  {ms:8.3f} ms/step {100 * ms * steps / busy_ms:5.1f}%  "
              f"{e.count / steps:5.1f}x  {e.key[:90]}")
    return dict(busy_ms=busy_ms / steps, wall_ms=wall_ms / steps,
                ops=per_step)


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
    call (``median_ms``, the wrapper's host work included) and queue-full
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
        t = median_ms(lambda: anatomy.variant(*args), 20)
        q[mode] = batched_ms(lambda: anatomy.variant(*args), 20)
        t_p = median_ms(lambda: anatomy.variant_plain(*args), 3, warmup=1)
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
        t = median_ms(lambda: anatomy.bf16_probe(at), 20)
        q[leg] = batched_ms(lambda: anatomy.bf16_probe(at), 20)
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
              f"roof {r['issue_ms']:.4f} ms at {r['sass_per_pair']:.2f} SASS a "
              f"pair ({100 * r['issue_share']:.1f}%); MUFU floor "
              f"{r['mufu_ms']:.4f} ms ({100 * r['mufu_share']:.1f}%)")
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
    from ``old`` (the last build's log), and the entry loops of the old and
    the new build (P = 4 where a kernel has several instances)."""
    for name in names:
        for line in cb.build_logs[name].splitlines():
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
        cb.call("composite_fwd", nc.data_ptr(), tids.data_ptr(),
                at.data_ptr(), out.data_ptr(), *tail, 1, cb.current_stream(),
                src=old)
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
        cb.call("composite_bwd", done.data_ptr(), tids.data_ptr(),
                at.data_ptr(), f_new.data_ptr(), g.data_ptr(),
                out.data_ptr(), *tail, cb.current_stream(), src=old)
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
            cb.call("anatomy_variants", x.nc.data_ptr(), x.tids.data_ptr(),
                    x.at.data_ptr(), out.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), i,
                    n_tiles, th, tw, k_tile, k_chunk, n_tx, cfg.alpha_clip,
                    cfg.alpha_threshold, cb.current_stream(), src=old)
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
            cb.call("bf16_probe", at.data_ptr(), out.data_ptr(),
                    int(leg == "bf16"), at.shape[0], cb.current_stream(),
                    src=old)
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


# phase 4h: the live viewer, multi-scene training and sharded training
PAR_WARMUP, PAR_STEPS = 5, 20      # train steps without, then with a viewer
VIEW_W, VIEW_H = 640, 480          # the page's frame size
VIEW_PERIOD_S = 0.25               # the page's poll period (/state, a frame)
VIEW_FRAMES = 10                   # frames timed after training
MS_SCENES, MS_STEPS, MS_VIEWS = 4, 25, 4
# a short schedule: refines at steps 10 (densifying) and 20 (culling), an
# opacity reset at step 15
MS_DENSIFY = dict(warmup_steps=5, refine_every=10, reset_opacity_every=15)
SHARDS, SHARD_STEPS = 4, 10        # in-process tile slices; timed steps
SHARD_HOLD = 5                     # graphed against eager steps


def flagship_cfg(**kw):
    from touchgs_torch.config import ModelConfig, RasterizeConfig, TrainConfig

    return TrainConfig(
        model=ModelConfig(max_gaussians=CAPACITY, sh_degree=3,
                          rasterize=RasterizeConfig(use_pallas=True)),
        view_cache_bytes=1 << 30, log_every=1, **kw)


def same_step(name: str, loss, ref_loss, params, ref_params, optim) -> float:
    """Check one step against another at the JAX package's 1-vs-N
    tolerances: loss rtol 1e-4, parameters atol 1e-5 on the live slots.
    An entry whose gradient is float32 noise about 0 moves by a whole Adam
    step of its sign (ROADMAP.md C32), so those are held as a share: at
    most 0.1% of a group's entries, none more than two steps apart.
    Returns the largest parameter difference."""
    from touchgs_torch.train.optim import PARAM_GROUPS

    lrs = {"means": optim.means_lr_init, "quats": optim.quats_lr,
           "log_scales": optim.scales_lr,
           "logit_opacities": optim.opacities_lr,
           "sh_dc": optim.features_dc_lr, "sh_rest": optim.features_rest_lr}
    loss, ref_loss = float(loss), float(ref_loss)
    check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss),
          f"{name}: loss {loss} against {ref_loss}")
    alive = ref_params.alive
    check(torch.equal(params.alive, alive), f"{name}: alive masks differ")
    worst, apart = 0.0, {}
    for g in PARAM_GROUPS:
        d = (getattr(params, g)[alive] - getattr(ref_params, g)[alive]).abs()
        if d.numel() == 0:
            continue
        share = float((d > 1e-5).float().mean())
        check(share <= 1e-3 and float(d.max()) <= 2 * lrs[g] + 1e-5,
              f"{name}: {g} {share:.4%} of the entries more than 1e-5 "
              f"apart, at most {float(d.max()):.3e}")
        worst = max(worst, float(d.max()))
        apart[g] = share
    print(f"{name}: loss {loss:.7f} (reference {ref_loss:.7f}), parameters "
          f"at most {worst:.3e} apart; share more than 1e-5 apart "
          + ", ".join(f"{g} {v:.4%}" for g, v in apart.items()))
    return worst


def hold_kernels(name: str, attrs, sorted_gauss, starts, counts, tile_ids,
                 geom, tile0: int = 0, backward: bool = True) -> float:
    """K1 with rows, K2 and (``backward``) K3 against their plain versions
    on one path's inputs, with phase 2's checks; returns the largest
    error."""
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.ops import rasterize_plain as plain

    th, tw, k_tile, k_chunk, n_tx, rcfg = geom
    n = counts.shape[0]
    capped = torch.clamp(counts, max=k_tile).contiguous()
    args = (sorted_gauss, starts.contiguous(), capped, n, k_tile,
            attrs.shape[0] - plain.DEAD_SPREAD, tile0)
    gidx, rows = rc.slot_rows(attrs, *args)
    gidx_p, rows_p = plain.slot_rows_plain(attrs, *args)
    check(torch.equal(gidx, gidx_p) and torch.equal(rows, rows_p),
          f"{name}: K1 with rows differs from plain")
    nc = ((capped + k_chunk - 1) // k_chunk).to(torch.int32)
    fwd = rc.forward_tiles(nc, tile_ids, rows, *geom)
    fwd_p = plain.forward_tiles_plain(nc, tile_ids, rows, *geom)
    sel = torch.tensor([0, 1, 2, 4, 5], device=fwd.device)
    err = float((fwd[:, sel] - fwd_p[:, sel]).abs().max())
    err_d = float((fwd[:, 3] - fwd_p[:, 3]).abs().max())
    check(torch.equal(fwd[:, plain.ROW_DONE], fwd_p[:, plain.ROW_DONE])
          and torch.equal(fwd[:, plain.ROW_T], fwd_p[:, plain.ROW_T])
          and err <= 3e-5 and err_d <= 3e-4,
          f"{name}: K2 outside tolerance ({err:.3e}, depth {err_d:.3e})")
    msg = f"{name}: K1 rows equal, K2 {err:.3e} (depth {err_d:.3e})"
    worst = max(err, err_d)
    if backward:
        done = fwd[:, plain.ROW_DONE, 0].to(torch.int32).contiguous()
        gen = torch.Generator(device=fwd.device)
        gen.manual_seed(1)
        g = torch.randn(fwd.shape, generator=gen, device=fwd.device)
        d = rc.backward_tiles(done, tile_ids, rows, fwd, g, *geom)
        d_p = plain.backward_tiles_plain(done, tile_ids, rows, fwd, g, *geom)
        diff = (d - d_p).abs()
        check(not bool((diff > 1e-5 + 1e-4 * d_p.abs()).any()),
              f"{name}: K3 outside tolerance")
        msg += f", K3 {float(diff.max()):.3e} (bit-exact {torch.equal(d, d_p)})"
        worst = max(worst, float(diff.max()))
    torch.cuda.synchronize()
    print(msg + f" on {n} tiles")
    return worst


def step_times(step, state, batch, n: int) -> list:
    """ms of each of ``n`` steps, each ending in a host read of its loss."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        float(m["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_viewer(card: str, trainer) -> tuple:
    """(a) ``Trainer.run`` at the flagship with and without a live
    ``ViewerServer`` polled as its page polls it; frames after training
    against the trainer's own render; returns the counts of the frames
    after training and the errors of the kernels on a frame's inputs."""
    import threading
    import urllib.request

    from touchgs_torch.data.cameras import Camera
    from touchgs_torch.data.png import decode_png
    from touchgs_torch.models.splatfacto import render, shade
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.viewer import ViewerServer, orbit_c2w
    from touchgs_torch.viewer.server import frame_bytes

    dev = trainer.device
    query = (f"theta=0.4&phi=0.35&radius=3.0&w={VIEW_W}&h={VIEW_H}")
    trainer.run(PAR_WARMUP)
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    trainer.run(PAR_WARMUP + PAR_STEPS,
                log_fn=lambda m: stamps.append(time.perf_counter()))
    plain_ms = np.diff(stamps) * 1e3

    served, trips, stop = [], [], threading.Event()
    with ViewerServer(trainer=trainer, port=0) as v:
        def page():  # /state and a frame every VIEW_PERIOD_S, as the page
            modes = ("rgb", "depth", "acc")
            while not stop.is_set():
                t0 = time.perf_counter()
                with urllib.request.urlopen(v.url + "state", timeout=60) as r:
                    json.loads(r.read())
                url = f"{v.url}render?{query}&mode={modes[len(served) % 3]}"
                with urllib.request.urlopen(url, timeout=60) as r:
                    served.append(r.read())
                trips.append((time.perf_counter() - t0) * 1e3)
                stop.wait(max(0.0, VIEW_PERIOD_S - (time.perf_counter() - t0)))

        zero_launches()
        client = threading.Thread(target=page, daemon=True)
        client.start()
        stamps = [time.perf_counter()]
        trainer.run(PAR_WARMUP + 2 * PAR_STEPS, viewer=v,
                    log_fn=lambda m: stamps.append(time.perf_counter()))
        stop.set()
        client.join(timeout=120)
        check(not client.is_alive(), "the viewer's client did not stop")
        torch.cuda.synchronize()
        during = dict(rc.launches)
        viewer_ms = np.diff(stamps) * 1e3
        n_during = len(served)
        check(n_during >= 1, "no frame was served while training")
        want = {"slot_lists": 0, "slot_rows": PAR_STEPS + n_during,
                "composite_fwd": PAR_STEPS + n_during,
                "composite_bwd": PAR_STEPS, "ssim_fwd": PAR_STEPS,
                "ssim_bwd": PAR_STEPS, "shade_fwd": PAR_STEPS + n_during,
                "shade_bwd": PAR_STEPS}
        check(during == want, f"launches while training with the viewer "
              f"{during}, want {want}")
        with urllib.request.urlopen(v.url + "state", timeout=60) as r:
            state = json.loads(r.read())
        check(state["step"] == PAR_WARMUP + 2 * PAR_STEPS - 1
              and not state["training"], f"/state after training: {state}")

        # after training: the three modes against the trainer's own render
        zero_launches()
        pngs = {}
        for m in ("rgb", "depth", "acc"):
            with urllib.request.urlopen(f"{v.url}render?{query}&mode={m}",
                                        timeout=60) as r:
                pngs[m] = r.read()
        trips_after = []
        for _ in range(VIEW_FRAMES):
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"{v.url}render?{query}&mode=rgb",
                                        timeout=60) as r:
                r.read()
            trips_after.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        counts = dict(rc.launches)
        n_frames = 3 + VIEW_FRAMES
        want = {"slot_lists": 0, "slot_rows": n_frames,
                "composite_fwd": n_frames, "composite_bwd": 0,
                "ssim_fwd": 0, "ssim_bwd": 0, "shade_fwd": n_frames,
                "shade_bwd": 0}
        check(counts == want, f"viewer launches after training {counts}, "
              f"want {want}")
        c2w = orbit_c2w(0.4, 0.35, 3.0)
        frame_ms = []
        for _ in range(VIEW_FRAMES):
            t0 = time.perf_counter()
            v._render(c2w, VIEW_W, VIEW_H)
            frame_ms.append((time.perf_counter() - t0) * 1e3)

    f = np.float32(0.8 * max(VIEW_W, VIEW_H))
    cam = Camera(fx=torch.tensor(f, device=dev), fy=torch.tensor(f, device=dev),
                 cx=torch.tensor(np.float32(VIEW_W / 2), device=dev),
                 cy=torch.tensor(np.float32(VIEW_H / 2), device=dev),
                 c2w=torch.as_tensor(c2w, device=dev), width=VIEW_W,
                 height=VIEW_H)
    mcfg = trainer.cfg.model
    with torch.no_grad():
        out, _ = render(trainer.state.params, cam, mcfg,
                        active_sh_degree=mcfg.sh_degree)
    host = {"rgb": out.rgb.cpu().numpy(), "depth": out.depth.cpu().numpy(),
            "acc": out.acc.cpu().numpy()}
    for m, png in pngs.items():
        got = decode_png(png).pixels
        check(np.array_equal(got, frame_bytes(host, m)),
              f"viewer {m} frame differs from the trainer's render")
        check(np.ptp(got) > 0, f"viewer {m} frame is blank")
    print(f"viewer: rgb, depth and acc frames at {VIEW_W}x{VIEW_H} equal the "
          f"trainer's render byte for byte; mean rgb "
          f"{float(host['rgb'].mean()):.4f}")

    with torch.no_grad():
        proj, colors, opac, _ = shade(trainer.state.params, cam, mcfg,
                                      mcfg.sh_degree)
        x = tile_inputs(mcfg.rasterize, proj, colors, opac, VIEW_W, VIEW_H)
        err = hold_kernels("viewer frame", x["attrs"], x["bins"].sorted_gauss,
                           x["bins"].tile_starts, x["bins"].tile_counts,
                           x["tile_ids"], (x["th"], x["tw"], x["k_tile"],
                                           x["k_chunk"], x["n_tx"],
                                           x["rcfg"]), backward=False)
    med, med_v = float(np.median(plain_ms)), float(np.median(viewer_ms))
    print(f"viewer: frame {float(np.median(frame_ms)):.3f} ms (render and "
          f"copy to the host, median of {VIEW_FRAMES}), round trip "
          f"{float(np.median(trips_after)):.3f} ms after training and "
          f"{float(np.median(trips)):.3f} ms while training "
          f"({n_during} frames); step median {med:.3f} ms without the "
          f"viewer, {med_v:.3f} ms with it ({med_v / med:.3f}x), "
          f"{PAR_STEPS} steps each, on {card}")
    return counts, err


def multiscene_data(s: int, dev) -> tuple:
    """Scene ``s`` of the multi-scene batch: flagship parameters drawn on
    the card from seed ``s`` (100k live Gaussians in 131072 slots, SH 3)
    and MS_VIEWS random 800x800 views, with a Scene of 2048 seeds for the
    single-scene Trainer (whose state is then replaced)."""
    from touchgs_torch.data.cameras import Cameras
    from touchgs_torch.data.scene import Scene
    from touchgs_torch.models.gaussians import GaussianParams
    from touchgs_torch.ops.sh import rgb_to_sh_dc

    gen = torch.Generator(device=dev)
    gen.manual_seed(100 + s)
    n, C = N_GAUSSIANS, CAPACITY

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    live = torch.arange(C, device=dev) < n
    pad = live[:, None].float()
    quats = torch.randn((C, 4), generator=gen, device=dev)
    params = GaussianParams(
        means=(rand(C, 3) * 2 - 1) * pad,
        quats=quats / quats.norm(dim=-1, keepdim=True) * pad,
        log_scales=torch.log(0.006 + 0.012 * rand(C, 3)) * pad,
        logit_opacities=torch.full((C,), float(np.log(0.1 / 0.9)),
                                   device=dev) * live,
        sh_dc=rgb_to_sh_dc(rand(C, 3)) * pad,
        sh_rest=torch.zeros((C, 15, 3), device=dev), alive=live)
    rng = np.random.default_rng(200 + s)
    c2w = np.stack([look_at_c2w((2.5 * np.sin(a), 0.4 + 0.1 * s,
                                 2.5 * np.cos(a)))
                    for a in np.linspace(0, np.pi / 2, MS_VIEWS) + 0.3 * s])
    f = np.full(MS_VIEWS, 0.9 * WIDTH, np.float32)
    scene = Scene(
        cameras=Cameras(fx=f, fy=f.copy(),
                        cx=np.full(MS_VIEWS, WIDTH / 2, np.float32),
                        cy=np.full(MS_VIEWS, HEIGHT / 2, np.float32),
                        c2w=c2w, width=WIDTH, height=HEIGHT),
        images=rng.uniform(0, 1, (MS_VIEWS, HEIGHT, WIDTH, 3)
                           ).astype(np.float32),
        depths=rng.uniform(1, 3, (MS_VIEWS, HEIGHT, WIDTH)).astype(np.float32),
        uncertainties=rng.uniform(0, 1, (MS_VIEWS, HEIGHT, WIDTH)
                                  ).astype(np.float32),
        i_train=np.arange(MS_VIEWS), i_eval=np.array([], int),
        seed_points=rng.uniform(-1, 1, (2048, 3)).astype(np.float32),
        seed_colors=rng.uniform(0, 1, (2048, 3)).astype(np.float32),
        scale_factor=1.0, transform=np.eye(4)[:3], name=f"scene{s}")
    return params, scene


def clone_state(state):
    import copy

    return copy.deepcopy(state)


def phase_multiscene(card: str, dev) -> tuple:
    """(b) S = 4 flagship scenes, unsharded and on a data=1, model=1 mesh
    in the NCCL world of one that ``phase_parallel`` set up: step 1 of the
    batch against four single-scene steps and against the mesh's step 1;
    the kernels on the batch's grid (on a model=1 mesh, the rank's slice
    of the packed grid) against their plain versions; then 25 steps of
    ``run_multiscene`` with refines and an opacity reset, unsharded and
    on the mesh in turns (batch, mesh, mesh, batch), and four single-scene
    ``Trainer`` runs of the same schedule.  Returns the launch counts of
    the first batch run and the first mesh run, and the kernels' largest
    error."""
    from touchgs_torch.config import DensifyConfig
    from touchgs_torch.models.densify import DensifyState
    from touchgs_torch.models.splatfacto import shade
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.parallel import multiscene as ms
    from touchgs_torch.parallel.mesh import make_mesh
    from touchgs_torch.train.graphs import GraphedStep, state_tensors
    from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam
    from touchgs_torch.train.trainer import (TrainState, Trainer,
                                             make_train_step)

    S = MS_SCENES
    cfg = flagship_cfg(densify=DensifyConfig(**MS_DENSIFY))
    data = [multiscene_data(s, dev) for s in range(S)]
    opt = FusedAdam(cfg.optim)
    mesh = make_mesh(data=1, model=1)
    check(torch.distributed.get_backend() == "nccl"
          and None not in (mesh.group, mesh.axis("model").group,
                           mesh.axis("data").group),
          f"a data=1, model=1 mesh on NCCL groups: {mesh}")

    def single_state(p):
        p = clone_state(p)
        return TrainState(params=p, opt_state=opt.init(
            {g: getattr(p, g) for g in PARAM_GROUPS}),
            densify=DensifyState.zeros(CAPACITY, dev), step=0)

    def batch_state(on_mesh: bool):
        state = ms.make_multiscene_state([clone_state(p) for p, _ in data],
                                         cfg, opt)
        return ms.shard_multiscene_state(state, mesh) if on_mesh else state

    # every view on the card once
    views = [[torch.as_tensor(getattr(sc, k), device=dev)
              for k in ("images", "depths", "uncertainties")]
             for _, sc in data]
    cams = [[sc.cameras.at(i, dev) for i in range(MS_VIEWS)]
            for _, sc in data]

    def batch(view_of):  # view_of[s]: the view of scene s
        return (ms.stack_cameras([cams[s][v] for s, v in enumerate(view_of)]),
                *(torch.stack([views[s][k][v] for s, v in enumerate(view_of)])
                  for k in range(3)))

    # step 1 against four single-scene steps, and on the mesh
    state = batch_state(False)
    step = ms.make_multiscene_train_step(cfg, opt)
    mesh_step = ms.make_multiscene_train_step(cfg, opt, mesh)
    check(isinstance(step, GraphedStep) and isinstance(mesh_step,
                                                       GraphedStep),
          "make_multiscene_train_step did not return a graphed step")
    state, m = step.__wrapped__(state, *batch([0] * S), 0)
    single = make_train_step(cfg, opt).__wrapped__
    for s in range(S):
        st, sm = single(single_state(data[s][0]), cams[s][0],
                        *(views[s][k][0] for k in range(3)), 0)
        same_step(f"multi-scene step 1, scene {s}", m["loss_per_scene"][s],
                  sm["loss"], ms.scene_params(state.params, s), st.params,
                  cfg.optim)
    del st
    mstate, mm = mesh_step.__wrapped__(batch_state(True), *batch([0] * S),
                                       0)
    full = ms.gather_multiscene_state(mstate, mesh)
    for k in ("loss_per_scene", "psnr_per_scene"):
        got, want = mm[k].double(), m[k].double()
        check(bool(((got - want).abs() <= 1e-5 * want.abs()).all()),
              f"mesh step 1: {k} {mm[k].tolist()} against {m[k].tolist()}")
    for s in range(S):
        same_step(f"mesh step 1, scene {s}", mm["loss_per_scene"][s],
                  m["loss_per_scene"][s], ms.scene_params(full.params, s),
                  ms.scene_params(state.params, s), cfg.optim)
    def same(a, b):  # the dead slots' quaternions are NaN in both
        return bool(((a == b) | (a.isnan() & b.isnan())).all())

    exact = all(same(getattr(full.params, g), getattr(state.params, g))
                for g in PARAM_GROUPS)
    print(f"mesh step 1 (data=1, model=1, NCCL world of one): losses "
          f"{mm['loss_per_scene'].tolist()}, PSNRs "
          f"{mm['psnr_per_scene'].tolist()}; parameters equal to the "
          f"batch's, every slot: {exact}")
    del full

    # the kernels on the batch's grid against plain; on a model=1 mesh the
    # rank's slice of the packed grid is this whole grid (the card test
    # test_packed_grid_slices_on_card holds 2 and 4 slices)
    with torch.no_grad():
        shaded = [shade(ms.scene_params(state.params, s),
                        ms.camera_at(batch([0] * S)[0], s), cfg.model, 3)
                  for s in range(S)]
        projs, colors, opac, _ = zip(*shaded)
        x = rc.pack_scenes(projs, colors, opac, WIDTH, HEIGHT,
                           cfg.model.rasterize,
                           k_chunk=cfg.model.rasterize.k_chunk)
        err = hold_kernels(f"multi-scene grid ({S} scenes)", x["attrs"],
                           x["sorted_gauss"], x["tile_starts"],
                           x["tile_counts"], x["tile_ids"], x["geom"])
    del x, shaded, projs, colors, opac, state, mstate

    # 25 steps of the schedule: eager and graphed, unsharded and on the
    # mesh; the graphed batch and mesh timed in turns against four graphed
    # single-scene Trainer runs
    def schedule(on_mesh: bool, graphed: bool) -> dict:
        ev = {"refine": 0, "reset_opacity": 0}
        fn = mesh_step if on_mesh else step
        refine_fn = ms.make_multiscene_refine_step(
            cfg, mesh if on_mesh else None)
        reset_fn = ms.make_multiscene_reset_opacity_step(cfg)
        captures = []

        def refine(*a, **k):
            ev["refine"] += 1
            captures.append(fn.events["capture"])
            return refine_fn(*a, **k)

        def reset(*a, **k):
            ev["reset_opacity"] += 1
            captures.append(fn.events["capture"])
            return reset_fn(*a, **k)

        st = batch_state(on_mesh)
        rng_views = np.random.default_rng(5)
        stamps, logs = [], []

        def log(m):
            stamps.append(time.perf_counter())
            logs.append(m["loss_per_scene"] + m["psnr_per_scene"])

        c0 = fn.events["capture"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        stamps.append(time.perf_counter())
        st, met = ms.run_multiscene(
            st, cfg, fn if graphed else fn.__wrapped__,
            lambda i, rng: (*batch(rng_views.integers(0, MS_VIEWS, S)),
                            min(i // cfg.sh_degree_interval, 3)),
            MS_STEPS, refine_fn=refine, reset_fn=reset,
            n_train_views=MS_VIEWS, log_fn=log,
            mesh=mesh if on_mesh else None)
        torch.cuda.synchronize()
        counts = dict(rc.launches)
        name = (("graphed " if graphed else "")
                + ("mesh" if on_mesh else "multi-scene"))
        want = {"slot_lists": 0, "slot_rows": MS_STEPS,
                "composite_fwd": MS_STEPS, "composite_bwd": MS_STEPS,
                "ssim_fwd": MS_STEPS * S, "ssim_bwd": MS_STEPS * S,
                "shade_fwd": 0, "shade_bwd": 0}
        check(counts == want, f"{name} launches {counts}, want {want} "
              f"(one of each K1-K3 a step for all {S} scenes, one SSIM a "
              f"scene, the op chain's shading)")
        check(ev["refine"] >= 1 and ev["reset_opacity"] >= 1,
              f"{name} schedule ran {ev}")
        losses = met["loss_per_scene"].tolist()
        check(all(np.isfinite(losses)), f"{name} losses {losses}")
        alive = ms.alive_per_scene(st, mesh if on_mesh else None).tolist()
        if graphed:  # one capture, before the first refine and reset
            n = fn.events["capture"] - c0
            check(n <= 1 and all(c == fn.events["capture"]
                                 for c in captures),
                  f"{name}: {n} captures, {captures} at the refines and "
                  f"the reset")
        ms_ = np.diff(stamps) * 1e3
        return dict(ms=ms_, counts=counts, events=ev, losses=losses,
                    alive=alive, logs=np.array(logs),
                    peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                    state=[t.clone() for t in state_tensors(st)],
                    first_s=ms_[0] / 1e3)

    def singles() -> list:  # four graphed single-scene Trainer runs
        out = []
        for s, (p, scene) in enumerate(data):
            tr = Trainer(scene, cfg)
            tr.state = single_state(p)
            tr.rng = np.random.default_rng(5 + s)
            st = [time.perf_counter()]
            tr.run(MS_STEPS, log_fn=lambda m: st.append(time.perf_counter()))
            out.append(float(np.median(np.diff(st)[1:] * 1e3)))
            del tr
        return out

    def same_run(name, got, ref) -> None:
        rel = np.abs(got["logs"] - ref["logs"]) / np.abs(ref["logs"])
        exact = all(bool(((a == b) | (a.isnan() & b.isnan())).all())
                    for a, b in zip(got["state"], ref["state"]))
        print(f"{name} against eager: {MS_STEPS} steps, losses and PSNRs "
              f"at most {rel.max():.3e} apart (relative), alive "
              f"{got['alive']} against {ref['alive']}, every state tensor "
              f"equal: {exact}")
        check(rel.max() <= 1e-3 and got["alive"] == ref["alive"] and exact,
              f"{name} differs from its eager run")

    alive0 = [int(p.alive.sum()) for p, _ in data]
    runs = {}
    for key in (("batch", False), ("mesh", False)):
        runs[key] = schedule(key[0] == "mesh", False)
        torch.cuda.empty_cache()
    times = {"batch": [], "mesh": [], "single": []}
    first = {}
    for turn in ("batch", "mesh", "single", "single", "mesh", "batch"):
        if turn == "single":
            times["single"].append(singles())
        else:
            r = schedule(turn == "mesh", True)
            runs.setdefault((turn, True), r)
            first.setdefault(turn, r["first_s"])
            times[turn].append(r["ms"][1:])
        torch.cuda.empty_cache()
    eager, graph = runs[("batch", False)], runs[("batch", True)]
    eager_m, graph_m = runs[("mesh", False)], runs[("mesh", True)]
    print(f"multi-scene: {S} scenes, {MS_STEPS} steps, {eager['events']}; "
          f"alive {alive0} -> {eager['alive']}; losses "
          f"{[round(v, 5) for v in eager['losses']]}; eager step median "
          f"{float(np.median(eager['ms'])):.3f} ms")
    check(eager_m["alive"] == eager["alive"]
          and np.allclose(eager_m["losses"], eager["losses"], rtol=1e-5),
          f"mesh run: alive {eager_m['alive']}, losses "
          f"{eager_m['losses']}, against the batch's {eager['alive']}, "
          f"{eager['losses']}")
    same_run("graphed multi-scene", graph, eager)
    same_run("graphed mesh", graph_m, eager_m)
    single = float(np.mean(times["single"]))
    med = {k: float(np.median(np.concatenate(times[k])))
           for k in ("batch", "mesh")}
    med_e = {k: float(np.median(runs[(k, False)]["ms"]))
             for k in ("batch", "mesh")}
    for k, name in (("batch", "multi-scene"), ("mesh", "multi-scene mesh "
                                                "(data=1, model=1, NCCL "
                                                "world of one)")):
        r = runs[(k, True)]
        fn = step if k == "batch" else mesh_step
        print(f"{name} graphed: step median {med[k]:.3f} ms for {S} scenes "
              f"({S * 1e3 / med[k]:.2f} scene-steps/s) against "
              f"{med_e[k]:.3f} ms eager ({med_e[k] / med[k]:.2f}x); four "
              f"graphed single-scene Trainer runs "
              f"{[round(float(v), 3) for v in np.mean(times['single'], 0)]} "
              f"ms ({1e3 / single:.2f} scene-steps/s): "
              f"{single * S / med[k]:.3f}x the scene-steps (turns batch, "
              f"mesh, single, single, mesh, batch, {MS_STEPS} steps a "
              f"run); first step (capture) {first[k]:.3f} s; captures "
              f"{fn.events['capture']}; graph pool "
              f"{pool_bytes(fn.pool) / 2**20:.1f} MiB; launches "
              f"{r['counts']}; peak memory {r['peak']:.2f} GiB; kernels on "
              f"the packed grid at most {err:.3e} from plain; on {card}")
    return (eager["counts"], eager_m["counts"], graph["counts"],
            graph_m["counts"], err)


def phase_sharded(card: str, dev, batch) -> tuple:
    """(c) the flagship step with its tile grid in SHARDS slices in one
    process, and the sharded step in a NCCL world of one, each against the
    unsharded step from the same state (``multiscene_data``'s parameters,
    on the flagship scene's first view ``batch``); K1's slice lists against the global
    lists; each graphed against its eager step over SHARD_HOLD steps; their
    times, eager and graphed, in turns against the unsharded graphed step;
    then ``scaling_bench`` at a world of one.  Returns the launch counts of
    the two eager sharded steps and of the two graphed ones, and the
    kernels' errors on a slice."""
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.parallel.mesh import make_mesh
    from touchgs_torch.parallel.sharded import (gather_state,
                                                make_sharded_train_step,
                                                shard_state)
    from touchgs_torch.models.densify import DensifyState
    from touchgs_torch.tools import scaling_bench
    from touchgs_torch.train.graphs import GraphedStep, state_tensors
    from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam
    from touchgs_torch.train.trainer import TrainState, make_train_step

    cfg = flagship_cfg()
    opt = FusedAdam(cfg.optim)
    params = multiscene_data(MS_SCENES, dev)[0]
    state0 = TrainState(params=params, opt_state=opt.init(
        {g: getattr(params, g) for g in PARAM_GROUPS}),
        densify=DensifyState.zeros(CAPACITY, dev), step=0)
    mesh = make_mesh()
    check(mesh.size == 1 and mesh.group is not None, f"mesh {mesh}")
    plain_step = make_train_step(cfg, opt)
    shard_step = make_train_step(cfg, opt, tile_shards=SHARDS)
    nccl_step = make_sharded_train_step(cfg, mesh, opt)
    check(isinstance(shard_step, GraphedStep)
          and isinstance(nccl_step, GraphedStep),
          "the sharded steps are not graphed")

    ref, rm = plain_step(clone_state(state0), *batch)
    zero_launches()
    st4, m4 = shard_step.__wrapped__(clone_state(state0), *batch)
    stn, mn = nccl_step.__wrapped__(shard_state(clone_state(state0), mesh),
                                    *batch)
    torch.cuda.synchronize()
    counts = dict(rc.launches)
    want = {"slot_lists": 0, "slot_rows": SHARDS + 1,
            "composite_fwd": SHARDS + 1, "composite_bwd": SHARDS + 1,
            "ssim_fwd": 2, "ssim_bwd": 2, "shade_fwd": 2, "shade_bwd": 2}
    check(counts == want, f"sharded launches {counts}, want {want}")
    same_step(f"tile_shards={SHARDS}", m4["loss"], rm["loss"], st4.params,
              ref.params, cfg.optim)
    same_step("NCCL world of one", mn["loss"], rm["loss"],
              gather_state(stn, mesh).params, ref.params, cfg.optim)
    del st4, stn, ref

    # K1's lists of each slice against the global lists' slice; the
    # kernels on the last slice (global tile ids, padding) against plain
    x = flagship_inputs(dev)
    n_tiles, k_tile = x["n_tiles"], x["k_tile"]
    sg, starts, capped = (x["bins"].sorted_gauss, x["bins"].tile_starts,
                          x["capped"])
    full = rc.slot_lists(sg, starts, capped, n_tiles, k_tile, x["N"])
    per = -(-n_tiles // SHARDS)
    for s in range(SHARDS):
        sl = slice(s * per, min((s + 1) * per, n_tiles))
        part = rc.slot_lists(sg, starts[sl].contiguous(),
                             capped[sl].contiguous(), sl.stop - sl.start,
                             k_tile, x["N"], tile0=sl.start)
        check(torch.equal(part, full[sl]),
              f"K1's lists of slice {s} differ from the global lists")
    last = (n_tiles - 1) // per           # the last slice with a tile
    sl = slice(last * per, n_tiles)
    err = hold_kernels(f"slice {last} of {SHARDS}", x["attrs"], sg,
                       starts[sl], x["bins"].tile_counts[sl],
                       x["tile_ids"][sl].contiguous(),
                       (x["th"], x["tw"], k_tile, x["k_chunk"], x["n_tx"],
                        x["rcfg"]), tile0=sl.start)
    print(f"K1: the lists of each of {SHARDS} slices (tile0 = 0, {per}, "
          f"{2 * per}, {3 * per}) equal the global lists' slice")
    del x, full

    # each graphed step against its eager step from one state
    graph_counts = dict.fromkeys(rc.launches, 0)
    first = {}
    for name, fn, place in (
            (f"{SHARDS} slices", shard_step, lambda st: st),
            ("NCCL world of one", nccl_step,
             lambda st: shard_state(st, mesh))):
        out = {}
        for side in ("eager", "graph"):
            st, losses = place(clone_state(state0)), []
            run = fn if side == "graph" else fn.__wrapped__
            zero_launches()
            torch.cuda.synchronize()
            for i in range(SHARD_HOLD):
                t0 = time.perf_counter()
                st, m = run(st, *batch)
                losses.append(float(m["loss"]))
                if i == 0:
                    first.setdefault(name, {})[side] = time.perf_counter() - t0
            torch.cuda.synchronize()
            if side == "graph":
                for k, v in rc.launches.items():
                    graph_counts[k] += v
            out[side] = (np.array(losses), state_tensors(st))
        rel = np.abs(out["graph"][0] - out["eager"][0]) / out["eager"][0]
        exact = all(bool(((a == b) | (a.isnan() & b.isnan())).all())
                    for a, b in zip(out["graph"][1], out["eager"][1]))
        print(f"sharded ({name}) graphed against eager: {SHARD_HOLD} steps, "
              f"losses at most {rel.max():.3e} apart (relative), every "
              f"state tensor equal: {exact}; first step (capture) "
              f"{first[name]['graph']:.3f} s against "
              f"{first[name]['eager']:.3f} s eager; captures "
              f"{fn.events['capture']}; graph pool "
              f"{pool_bytes(fn.pool) / 2**20:.1f} MiB")
        check(rel.max() <= 1e-3 and exact and fn.events["capture"] == 1,
              f"sharded ({name}): the graphed step differs from its eager "
              f"step, or captured {fn.events['capture']} times")
        del out
    want = {"slot_lists": 0, "slot_rows": SHARD_HOLD * (SHARDS + 1),
            "composite_fwd": SHARD_HOLD * (SHARDS + 1),
            "composite_bwd": SHARD_HOLD * (SHARDS + 1),
            "ssim_fwd": SHARD_HOLD * 2, "ssim_bwd": SHARD_HOLD * 2,
            "shade_fwd": SHARD_HOLD * 2, "shade_bwd": SHARD_HOLD * 2}
    check(graph_counts == want, f"graphed sharded launches {graph_counts}, "
          f"want {want}")

    # times, in turns: unsharded graphed, SHARDS slices and the NCCL world
    # of one, eager and graphed, ...
    states = {"unsharded": (plain_step, clone_state(state0)),
              f"{SHARDS} slices": (shard_step.__wrapped__,
                                   clone_state(state0)),
              f"{SHARDS} slices graphed": (shard_step, clone_state(state0)),
              "NCCL world of one": (nccl_step.__wrapped__,
                                    shard_state(clone_state(state0), mesh)),
              "NCCL world of one graphed": (
                  nccl_step, shard_state(clone_state(state0), mesh))}
    for fn, st in states.values():  # the graphed ones capture here
        fn(st, *batch)
    times = {k: [] for k in states}
    for _ in range(2):
        for k, (fn, st) in states.items():
            times[k] += step_times(fn, st, batch, SHARD_STEPS // 2)
    med = {k: float(np.median(v)) for k, v in times.items()}
    print("sharded: step median " + ", ".join(
        f"{k} {v:.3f} ms ({v / med['unsharded']:.3f}x)"
        for k, v in med.items()) + f" of the unsharded graphed step, "
        f"{SHARD_STEPS} steps each in turns, on {card}")
    del states
    line = scaling_bench.measure(torch.device("cuda"))
    print(f"scaling_bench (world of one): {json.dumps(line)}")
    return counts, graph_counts, err


def phase_parallel(card: str, dev=torch.device("cuda")) -> dict:
    """Phase 4h: the viewer (a), multi-scene (b, unsharded and on a mesh)
    and sharded (c) paths, each driven with the launch counters set to 0
    just before and read just after; (b) and (c) in one NCCL world of one.
    Returns their counts and the kernels' errors."""
    import socket

    from touchgs_torch.parallel.distributed import init_distributed
    from touchgs_torch.train.trainer import Trainer

    t0 = time.time()
    trainer = Trainer(make_scene(), flagship_cfg())
    batch = (*trainer._batch(0), 3)
    counts_v, err_v = phase_viewer(card, trainer)
    del trainer
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    check(init_distributed(f"127.0.0.1:{port}", 1, 0) is False
          and torch.distributed.get_backend() == "nccl",
          "a NCCL world of one")
    counts_m, counts_mm, counts_mg, counts_mmg, err_m = phase_multiscene(
        card, dev)
    torch.cuda.empty_cache()
    counts_s, counts_sg, err_s = phase_sharded(card, dev, batch)
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"phase 4h: {time.time() - t0:.1f} s")
    return {"viewer": counts_v, "multiscene": counts_m,
            "multiscene_mesh": counts_mm, "sharded": counts_s,
            "multiscene_graph": counts_mg, "mesh_graph": counts_mmg,
            "sharded_graph": counts_sg,
            "errors": {"viewer": err_v, "multiscene": err_m,
                       "sharded": err_s}}


def guarded_touch(arm_module, steps: int = ARM_STEPS) -> dict:
    """The guarded touch with ``arm_module``'s ``CompliantArm`` and
    ``ArmSim`` (the port's, or the JAX package's in the tests): approach
    along -z at 5 cm/s onto a plane 3 cm below the tool until the contact
    force reaches ARM_F_STOP, then hold it.  Returns whether it was held
    after the last step, the contact force, and q after every step."""
    arm = arm_module.CompliantArm(ARM_DH, ARM_MASS, ARM_COM)
    z0 = float(arm.fk(ARM_Q0)[2, 3])
    sim = arm_module.ArmSim(arm, q0=ARM_Q0, plane_z=z0 - 0.03,
                            k_contact=2000.0)
    qs = np.empty((steps, len(ARM_Q0)))
    for i in range(steps):
        held = sim.step_guarded([0.0, 0.0, -1.0], speed=0.05,
                                f_stop=ARM_F_STOP, stiffness=ARM_K,
                                damping=ARM_D, dt=1e-3, tol_n=0.5)
        qs[i] = np.asarray(sim.state()[0])
    force = np.asarray(sim.contact_force())
    arm.close()
    return {"held": held, "force": force, "q": qs}


def native_capture(out, dev, frames: int = CAPTURE_FRAMES) -> dict:
    """Phase 4i (c): the port's ``tgs_sync_capture --sim 1`` takes
    ``frames`` synchronized snapshots at CAPTURE_HZ into ``out/capture``
    (``poses.csv`` with its header and a row each); its ``imgs_cam0/``
    replays through ``DirectorySource`` and ``SensorLoop`` with the
    compact nets on ``dev``, every frame processed; the last frame's depth
    and wrench on ``dev`` within SENSOR_TOL of the range of the CPU's.
    Returns the times, the loop's stages and the errors."""
    import subprocess

    from touchgs_torch.native import loader
    from touchgs_torch.touch.sensor_loop import DirectorySource, SensorLoop
    from touchgs_torch.touch.sensor_nets import DenseTactSensor

    cap = out / "capture"
    t0 = time.perf_counter()
    r = subprocess.run(
        [str(loader.tool("tgs_sync_capture")), "--out", str(cap), "--sim",
         "1", "--auto-capture", str(frames), "--rate-hz", str(CAPTURE_HZ)],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=60)
    capture_s = time.perf_counter() - t0
    check(r.returncode == 0, f"tgs_sync_capture exited {r.returncode}: "
          f"{r.stderr[-300:]}")
    rows = (cap / "poses.csv").read_text().splitlines()
    check(rows[0] == "index,frame,x,y,z,qx,qy,qz,qw,stamp"
          and len(rows) == frames + 1,
          f"tgs_sync_capture: poses.csv {rows[:1]} and {len(rows) - 1} rows")
    results = {}
    sensor = DenseTactSensor(device=dev)
    loop = SensorLoop(sensor=sensor, rate_hz=LOOP_HZ,
                      on_frame=lambda i, res: results.__setitem__(i, res))
    t0 = time.perf_counter()
    n = loop.run(DirectorySource(cap / "imgs_cam0"))
    loop_s = time.perf_counter() - t0
    check(n == frames and sorted(results) == list(range(frames)),
          f"sensor loop over the capture: {n} frames of {frames}")
    last = results[frames - 1]
    cpu = DenseTactSensor(device="cpu")
    ref_depth = cpu.depth(last["rect"])
    ref_force = cpu.get_force(last["rect"])
    errors = {
        "depth": float((sensor.depth(last["rect"]).cpu() - ref_depth).abs()
                       .max() / (ref_depth.max() - ref_depth.min())),
        "force": float(np.abs(last["force"] - ref_force).max()
                       / np.ptp(ref_force))}
    check(all(e <= SENSOR_TOL for e in errors.values()),
          f"capture replay on {dev} against the CPU: {errors} of the range,"
          f" want <= {SENSOR_TOL}")
    return {"frames": n, "frame_shape": list(last["rect"].shape),
            "capture_s": capture_s, "loop_s": loop_s,
            "loop": loop_stats(loop), "errors": errors}


def phase_native(card: str, dev=torch.device("cuda")) -> dict:
    """Phase 4i: the native layer (``touchgs_torch/native/``), host code
    with no kernel of the port's.  Where ``g++``, ``make``, zlib or libjpeg
    is missing it says so, checks that ``decode_png`` falls back to
    ``data/png.py`` and that ``NativeLoader`` raises, and returns;
    otherwise any failure raises.
    Phase 4d's scene is written first (its GT renders through K1 and K2
    are phase 4d's path, set-up here); then, with the launch counters set
    to 0 just before and read just after: (a) the library and both tools
    built from the checkout, timed; (b) every PNG of the scene through
    ``NativeLoader`` (NATIVE_THREADS threads, all prefetched in a shuffled
    order, then read in it) and through ``decode_png``, each equal to
    ``decode_png_plain`` (``data/png.py``) exactly, ms an image each;
    (c) `native_capture` on ``dev``; (d) ``tgs_capture`` without a camera
    exits 1 with its message; (e) the guarded touch on ``ArmSim`` holds
    ARM_F_STOP within 0.5 N.  Returns the launch counts."""
    import subprocess
    import tempfile
    from pathlib import Path

    from touchgs_torch.data.png import write_png
    from touchgs_torch.native import arm as native_arm
    from touchgs_torch.native import loader
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.tools.write_scene import write_scene

    t_phase = time.perf_counter()
    missing = loader.missing_prerequisites()
    if missing:
        zero_launches()
        with tempfile.TemporaryDirectory() as tmp:
            png = Path(tmp) / "rgb.png"
            write_png(png, np.random.default_rng(NATIVE_SEED).integers(
                0, 256, (CLI_SIZE, CLI_SIZE, 3), dtype=np.uint8))
            check(not loader.native_available() and torch.equal(
                loader.decode_png(png), loader.decode_png_plain(png)),
                  "native: decode_png does not fall back to data/png.py")
            try:
                loader.NativeLoader([png])
            except RuntimeError:
                pass
            else:
                check(False, "native: a NativeLoader without its library")
        print(f"native: unavailable on this machine: {'; '.join(missing)}"
              f"; decode_png falls back to data/png.py, NativeLoader raises;"
              f" phase 4i {time.perf_counter() - t_phase:.1f} s; launches "
              f"{rc.launches}")
        return dict(rc.launches)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "scene"
        write_scene(root, CLI_VIEWS, CLI_SIZE, CLI_SEEDS, "cuda")
        zero_launches()
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, check=True).stdout.splitlines()[0]
        t0 = time.perf_counter()
        loader.build()
        build_s = time.perf_counter() - t0
        check(loader.native_available(),
              f"native: the library does not load: {loader._error}")
        print(f"native: built libtouchgs_native.so, tgs_capture and "
              f"tgs_sync_capture in {build_s:.2f} s ({gxx})", flush=True)

        paths = sorted(p for sub in ("imgs", "depth", "uncertainty")
                       for p in (root / sub).glob("*.png"))
        order = np.random.default_rng(NATIVE_SEED).permutation(len(paths))
        ms = {}
        t0 = time.perf_counter()
        ref = {i: loader.decode_png_plain(paths[i]) for i in order}
        ms["data/png.py"] = (time.perf_counter() - t0) * 1e3 / len(paths)
        t0 = time.perf_counter()
        got = {i: loader.decode_png(paths[i]) for i in order}
        ms["decode_png"] = (time.perf_counter() - t0) * 1e3 / len(paths)
        bad = [str(paths[i]) for i in order if not torch.equal(got[i], ref[i])]
        t0 = time.perf_counter()
        nl = loader.NativeLoader(paths, n_threads=NATIVE_THREADS)
        for i in order:
            nl.prefetch(int(i))
        got = {i: nl.get(int(i)) for i in order}
        ms["NativeLoader"] = (time.perf_counter() - t0) * 1e3 / len(paths)
        nl.close()
        bad += [str(paths[i]) for i in order
                if not torch.equal(got[i], ref[i])]
        check(not bad, f"native decodes differ from data/png.py's: {bad}")
        kinds = sorted({tuple(t.shape) for t in ref.values()})
        print(f"native: {len(paths)} PNGs of {kinds} equal data/png.py's "
              f"exactly; ms an image " + ", ".join(
                  f"{k} {v:.3f}" for k, v in ms.items())
              + f" (host times) on {card}", flush=True)

        cap = native_capture(Path(tmp), dev)
        print(f"native: capture {json.dumps(cap)} on {card}", flush=True)

    r = subprocess.run([str(loader.tool("tgs_capture")), "--device",
                        "/dev/null", "--count", "1"], capture_output=True,
                       text=True, timeout=30)
    check(r.returncode == 1 and "tgs_capture:" in r.stderr,
          f"tgs_capture without a camera: exit {r.returncode}, "
          f"{r.stderr[-200:]!r}")
    t0 = time.perf_counter()
    touch = guarded_touch(native_arm)
    arm_s = time.perf_counter() - t0
    fz = float(touch["force"][2])
    check(touch["held"] and abs(fz - ARM_F_STOP) < 0.5,
          f"arm: the guarded touch held {touch['held']} at {fz:.3f} N")
    counts = dict(rc.launches)
    print(f"native: tgs_capture without a camera exits 1 "
          f"({r.stderr.strip()[:80]!r}); the guarded touch holds {fz:.3f} N "
          f"after {ARM_STEPS} steps in {arm_s:.2f} s; phase 4i "
          f"{time.perf_counter() - t_phase:.1f} s; launches {counts}")
    return counts


def phase_bench(card: str, train_step_ms: float | None = None,
                dev=torch.device("cuda")) -> dict:
    """Phase 4j: the port's benchmark as a user runs it, ``python3
    bench_torch.py`` in a process of its own on the card (its launch
    counters start at 0 there), with the kernels the earlier phases built
    (with ``--bench`` it builds them itself).  It must exit 0 with exactly
    one JSON line on stdout, a rate above 0, no note and the card named;
    its launch line must show K4 once and K1 with rows, K2 and K3 each at
    least WARMUP_STEPS + TIMED_STEPS times over its steps; its census must
    be printed with no lossy tile.  Its stderr is echoed, the headline
    beside the train phase's median step.  Then ``pair_stats`` on the card
    at k_tile 1024, whose total pairs must equal what the flagship's
    initial state bins to, and the pairs kept at
    ``RasterizeConfig().k_tile``.  Returns the bench's launch counts over
    its steps."""
    import subprocess
    from pathlib import Path

    import bench_torch
    from touchgs_torch.config import RasterizeConfig
    from touchgs_torch.tools import pair_stats

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "bench_torch.py"],
                       cwd=Path(__file__).resolve().parent,
                       capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in r.stderr.splitlines():
        print(f"  bench| {line}")
    print(f"  bench| stdout: {r.stdout.strip()}", flush=True)
    check(r.returncode == 0, f"bench_torch.py exit {r.returncode}")
    lines = r.stdout.splitlines()
    check(len(lines) == 1, f"bench_torch.py printed {len(lines)} lines")
    h = json.loads(lines[0])
    name = torch.cuda.get_device_name(0)
    check(h["value"] > 0 and "note" not in h and h["device"] == name,
          f"bench headline {h}, want a rate, no note and device {name!r}")
    last = r.stderr.strip().splitlines()[-1]
    check(last.startswith("launches: "), f"bench's last line {last!r}")
    counts = json.loads(last[len("launches: "):])["steps"]
    n_steps = bench_torch.WARMUP_STEPS + bench_torch.TIMED_STEPS
    check(counts["compile_smoke"] == 1
          and all(counts[k] >= n_steps for k in TRAIN_PATH),
          f"bench launches {counts}: want K4 once and K1 with rows, K2, K3 "
          f"and the SSIM pair at least {n_steps} times each")
    m = re.search(r"lossy-truncated tiles \(capped & unsaturated\): "
                  r"(\d+)/(\d+)", r.stderr)
    check(m is not None and int(m.group(1)) == 0,
          f"bench census: {m.group(0) if m else 'not printed'}")
    step = ("" if train_step_ms is None else
            f"; the train phase's median step {train_step_ms:.3f} ms "
            f"({1e3 / train_step_ms:.2f} it/s, a host read every step)")
    windows = bench_torch.TIMED_STEPS // bench_torch.CHUNK
    print(f"bench: {h['value']} it/s (median of {windows} windows of "
          f"{bench_torch.CHUNK} steps, a host read a window){step}; the "
          f"process {wall:.1f} s; launches over its steps {counts}; on "
          f"{card}", flush=True)

    want = int(flagship_inputs(dev)["bins"].tile_counts.sum())
    ps = pair_stats.main(1024, dev, WIDTH, HEIGHT, N_GAUSSIANS, CAPACITY)
    check(ps["total"] == want,
          f"pair_stats: {ps['total']} pairs, the flagship bins to {want}")
    k_tile = RasterizeConfig().k_tile
    kept = int(np.minimum(ps["tile_counts"], k_tile).sum())
    print(f"pair_stats: {want} pairs, as the flagship's initial state bins "
          f"to; at the default k_tile {k_tile} it keeps {kept} "
          f"({100 * kept / want:.2f}%); phase 4j "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return counts


# the experiment tools of touchgs_torch/tools/ that phase 4l runs, and the
# measured calls a row of each at that run
TOOLS = ("exp_tile_size", "exp_kernels", "exp_kernels2", "exp_scatter",
         "exp_scatter2", "exp_tail", "exp_tail2", "exp_tail3")
TOOLS_ITERS = 3


def geometry_name(geo) -> str:
    th, tw, k_tile, tcap = geo
    return f"{th}x{tw} k={k_tile} tcap={tcap}"


def phase_tools(card: str) -> dict:
    """Phase 4l: the eight experiment tools, each ``main(["--iters",
    TOOLS_ITERS])`` in this process with the launch counters set to 0 just
    before the first and read just after the last; each must exit 0 (a
    ``FAILED`` row is a finding, printed; a failed hold of
    ``exp_tile_size`` exits 1).  ``exp_tile_size`` holds K2 and K3 against
    their plain versions on the bench's tiles at each of its five
    geometries; then K2 and K3 are held on the bench's tiles at
    ``exp_tile_size.ODD_GEOMETRY``, a tile that is not a multiple of 32:
    K3 equal, K2's T row and chunks_done equal, rgb/acc 3e-5, depth 3e-4.
    Returns the tools' launch counts and each geometry's errors of K2
    (``composite_fwd``) and K3 (``composite_bwd``)."""
    import importlib

    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.tools import exp_tile_size as ts

    t0 = time.perf_counter()
    zero_launches()
    sweep = {}
    for name in TOOLS:
        tool = importlib.import_module(f"touchgs_torch.tools.{name}")
        out: dict = {}
        t = time.perf_counter()
        code = tool.main(["--iters", str(TOOLS_ITERS)], out=out)
        rows = out.get("rows", {})
        failed = [k for k, v in rows.items() if isinstance(v, str)
                  or isinstance(v, dict) and "failed" in v]
        print(f"tools: {name} exit {code} in {time.perf_counter() - t:.1f} "
              f"s; FAILED rows: {failed or 'none'}", flush=True)
        check(code == 0, f"{name} exited {code}")
        if name == "exp_tile_size":
            sweep = {geometry_name(g): r["hold"] for g, r in rows.items()}
    counts = dict(rc.launches)
    h = ts.hold(ts.Scene.bench(), ts.config(*ts.ODD_GEOMETRY))
    print(f"tools: {geometry_name(ts.ODD_GEOMETRY)} (not a multiple of 32):")
    ts.print_hold(h)
    check(h["ok"], f"K2 or K3 differs from plain at {ts.ODD_GEOMETRY}")
    sweep[geometry_name(ts.ODD_GEOMETRY)] = h
    print(f"tools: launches over the tools {counts}; phase 4l "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    return dict(counts=counts, errors={
        "composite_fwd": {g: max(h["k2_rgba"], h["k2_depth"])
                          for g, h in sweep.items()},
        "composite_bwd": {g: h["k3"] for g, h in sweep.items()}})


def pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in the CUDA-graph memory pool
    ``pool`` (its segments in ``torch.cuda.memory_snapshot``)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def alive_gap(a, b) -> float:
    """The largest |a − b| over the parameter groups' live slots of two
    ``GaussianParams`` with one alive mask (the dead slots' quaternions are
    zero, and their updates not finite)."""
    from touchgs_torch.train.optim import PARAM_GROUPS

    check(torch.equal(a.alive, b.alive), "alive masks differ")
    return max(float((getattr(a, g)[a.alive] - getattr(b, g)[a.alive])
                     .abs().max()) for g in PARAM_GROUPS
               if getattr(a, g)[a.alive].numel())


def phase_graph_step(card: str, trainer) -> dict:
    """Phase 4k (a) and (c), the graphed step (``train/graphs.py``) on the
    flagship: from two copies of ``trainer``'s state, GRAPH_STEPS steps
    with the plain step (``__wrapped__``) and as many with the graphed
    step, on the same views at SH degree GRAPH_SH, the launch counters set
    to 0 just before each and read just after: each step's loss and PSNR
    within rtol 1e-3, one capture, K1 with rows, K2 and K3 exactly
    GRAPH_STEPS launches each on the graphed side (the warm-up's counted
    apart); the largest parameter gap printed.  The first graphed step's
    time (warm-up, capture and a replay) and the graph pool's bytes.  Then
    (c) the steps timed in turns, eager, graphed, graphed, eager, each
    ending in a synchronize, and PROFILE_STEPS of each under
    torch.profiler.  Returns the graphed side's launch counts."""
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.train.graphs import WARMUP_ITERS, GraphedStep
    from touchgs_torch.train.trainer import make_train_step

    t_phase = time.perf_counter()
    events: dict = {}
    step = make_train_step(trainer.cfg, trainer.optimizer, events=events)
    check(isinstance(step, GraphedStep),
          f"make_train_step returned {type(step).__name__} on the card")
    fns = {"eager": step.__wrapped__, "graph": step}
    states = {k: clone_state(trainer.state) for k in fns}
    rng = np.random.default_rng(GRAPH_SEED)
    views = [int(rng.choice(trainer.scene.i_train))
             for _ in range(GRAPH_STEPS)]
    logs, counts, first_s = {}, {}, {}
    warm0 = dict(rc.launches_warmup)
    for name, fn in fns.items():
        zero_launches()
        state, log = states[name], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i, v in enumerate(views):
            t0 = time.perf_counter()
            state, m = fn(state, *trainer._batch(v), GRAPH_SH)
            log.append((float(m["loss"]), float(m["psnr"])))
            if i == 0:
                first_s[name] = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts[name] = dict(rc.launches)
        logs[name] = np.array(log)
        states[name] = state
        if name == "graph":
            pool = pool_bytes(step.pool)
            peak = torch.cuda.max_memory_allocated()
    warm = {k: rc.launches_warmup[k] - warm0[k] for k in warm0}
    rel = np.abs(logs["graph"] - logs["eager"]) / np.abs(logs["eager"])
    gap = alive_gap(states["graph"].params, states["eager"].params)
    print(f"graph: {GRAPH_STEPS} steps at SH {GRAPH_SH}: loss "
          f"{logs['eager'][0, 0]:.6f} -> {logs['eager'][-1, 0]:.6f} eager, "
          f"{logs['graph'][-1, 0]:.6f} graphed; largest relative gap loss "
          f"{rel[:, 0].max():.3e}, psnr {rel[:, 1].max():.3e}; final "
          f"parameters at most {gap:.3e} apart (live slots)")
    print(f"graph: first step {first_s['graph']:.3f} s graphed ("
          f"{WARMUP_ITERS} warm-up steps on a clone, the capture and a "
          f"replay) against {first_s['eager']:.3f} s eager; captures "
          f"{events['capture']}; graph pool {pool / 2**20:.1f} MiB, peak "
          f"allocated {peak / 2**30:.2f} GiB; launches {counts['graph']}, "
          f"warm-up {warm}")
    check(bool(np.isfinite(logs["graph"]).all()) and rel.max() <= 1e-3,
          f"graphed against eager: relative gap {rel.max():.3e}")
    want = {k: 0 if k == "slot_lists" else GRAPH_STEPS for k in rc.launches}
    check(counts == {"eager": want, "graph": want},
          f"graph launches {counts}, want {want} on each side")
    check(events["capture"] == 1, f"captures {events['capture']}, want 1")
    check(warm == {k: 0 if k == "slot_lists" else WARMUP_ITERS
                   for k in warm}, f"warm-up launches {warm}")

    times: dict = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        state = states[name]
        for i in range(GRAPH_TIMED):
            batch = trainer._batch(views[i % len(views)])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = fns[name](state, *batch, GRAPH_SH)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
        states[name] = state
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"graph: median step {med['graph']:.3f} ms graphed, "
          f"{med['eager']:.3f} eager ({med['eager'] / med['graph']:.2f}x), "
          f"{2 * GRAPH_TIMED} steps each in turns (eager, graphed, graphed, "
          f"eager), each ending in a synchronize; quartiles graphed "
          f"{np.percentile(times['graph'], 25):.3f}/"
          f"{np.percentile(times['graph'], 75):.3f}, eager "
          f"{np.percentile(times['eager'], 25):.3f}/"
          f"{np.percentile(times['eager'], 75):.3f} ms; on {card}")
    prof = {}
    for name, fn in fns.items():
        box = [states[name]]

        def run():
            for i in range(PROFILE_STEPS):
                box[0], _ = fn(box[0], *trainer._batch(views[i]), GRAPH_SH)

        prof[name] = phase_profile(run, PROFILE_STEPS, f"graph: {name}")
    print(f"graph: under the profiler the graphed step keeps the device "
          f"busy {prof['graph']['busy_ms']:.3f} of "
          f"{prof['graph']['wall_ms']:.3f} ms "
          f"({100 * prof['graph']['busy_ms'] / prof['graph']['wall_ms']:.1f}"
          f"%), {prof['graph']['ops']:.0f} device operations a step; eager "
          f"{prof['eager']['busy_ms']:.3f} of {prof['eager']['wall_ms']:.3f}"
          f" ms, {prof['eager']['ops']:.0f}; phase 4k (a, c) "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts["graph"]


def graph_scene():
    """Phase 4d's scene (``write_scene`` at CLI_VIEWS x CLI_SIZE² with
    CLI_SEEDS seeds, loaded with the ``bunny_blender`` split), for phase
    4k (b) when it runs alone."""
    import tempfile
    from pathlib import Path

    from touchgs_torch.config import SCENE_PRESETS
    from touchgs_torch.data.scene import load_scene
    from touchgs_torch.tools.write_scene import write_scene

    with tempfile.TemporaryDirectory() as tmp:
        write_scene(Path(tmp), CLI_VIEWS, CLI_SIZE, CLI_SEEDS, "cuda")
        return load_scene(Path(tmp), train_split_fraction=SCENE_PRESETS[
            "bunny_blender"].train_split_fraction)


@contextlib.contextmanager
def plain_steps():
    """``make_train_step`` returning the plain step (the graphed step's
    ``__wrapped__``) while the block runs, for the eager arm of phase 4k
    (b): the trainer builds its steps through it."""
    from touchgs_torch.train import trainer as tr

    real = tr.make_train_step

    def plain(*args, **kw):
        step = real(*args, **kw)
        return getattr(step, "__wrapped__", step)

    tr.make_train_step = plain
    try:
        yield
    finally:
        tr.make_train_step = real


def phase_graph_trainer(card: str, scene) -> dict:
    """Phase 4k (b): ``Trainer.run`` on phase 4d's scene for
    GRAPH_TRAIN_STEPS steps, graphed and then eager (``plain_steps``) from
    the same seeds, the launch counters set to 0 just before each: both
    runs refine at least twice, reset the opacities, raise the active SH
    degree and escalate k_tile from GRAPH_K_TILE; K1 with rows, K2 and K3
    exactly GRAPH_TRAIN_STEPS launches each; the graphed run's captures
    at most its SH degrees + escalations + growths + 1, the eager run's 0;
    the final mean PSNR of the eval views (lossless renders) within 0.1 dB
    and the alive counts within 1%.  Returns the graphed run's counts."""
    from touchgs_torch.config import (SCENE_PRESETS, DensifyConfig,
                                      ModelConfig, RasterizeConfig,
                                      TrainConfig)
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cfg = TrainConfig(
        model=ModelConfig(max_gaussians=CAPACITY, sh_degree=3,
                          rasterize=RasterizeConfig(use_pallas=True,
                                                    k_tile=GRAPH_K_TILE)),
        depth=SCENE_PRESETS["bunny_blender"].depth,
        densify=DensifyConfig(**GRAPH_DENSIFY),
        sh_degree_interval=GRAPH_SH_INTERVAL, log_every=GRAPH_LOG_EVERY,
        view_cache_bytes=1 << 30)
    views = scene.i_eval if len(scene.i_eval) else scene.i_train
    runs = {}
    for name in ("graph", "eager"):
        with (plain_steps() if name == "eager" else contextlib.nullcontext()):
            trainer = Trainer(scene, cfg)
            zero_launches()
            t0 = time.perf_counter()
            trainer.run(GRAPH_TRAIN_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = dict(rc.launches)
        psnrs = []
        for v in views:
            out = trainer.render_view(int(v))
            mse = float(((out.rgb - torch.as_tensor(
                scene.images[v], device=out.rgb.device)) ** 2).mean())
            psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
        h = trainer.history
        runs[name] = dict(
            psnr=float(np.mean(psnrs)), alive=int(trainer.state.params.num_alive),
            events=dict(trainer.events), counts=counts, wall_s=wall,
            it_s=h[-1]["iters_per_sec"], k_tile=trainer._k_tile,
            escalations=[m["k_tile_escalated_to"] for m in h
                         if "k_tile_escalated_to" in m],
            sh=trainer.active_sh_degree(GRAPH_TRAIN_STEPS - 1),
            loss=(h[0]["loss"], h[-1]["loss"]))
        print(f"graph trainer ({name}): {json.dumps(runs[name])}",
              flush=True)
        del trainer
        torch.cuda.empty_cache()
    g, e = runs["graph"], runs["eager"]
    want = {k: 0 if k == "slot_lists" else GRAPH_TRAIN_STEPS
            for k in rc.launches}
    for name, r in runs.items():
        ev = r["events"]
        check(ev["refine"] >= 2 and ev["reset_opacity"] >= 1 and r["sh"] > 0
              and r["escalations"] and r["counts"] == want,
              f"graph trainer ({name}): schedule {ev}, SH {r['sh']}, "
              f"escalations {r['escalations']}, launches {r['counts']}")
    bound = g["sh"] + 1 + len(g["escalations"]) + g["events"]["grow"] + 1
    check(g["events"]["capture"] <= bound and e["events"]["capture"] == 0,
          f"graph trainer: captures {g['events']['capture']} (at most "
          f"{bound}), eager {e['events']['capture']}")
    check(abs(g["psnr"] - e["psnr"]) <= 0.1
          and abs(g["alive"] - e["alive"]) <= 0.01 * e["alive"],
          f"graph trainer: psnr {g['psnr']:.4f} against {e['psnr']:.4f}, "
          f"alive {g['alive']} against {e['alive']}")
    print(f"graph trainer: {GRAPH_TRAIN_STEPS} steps, eval psnr "
          f"{g['psnr']:.4f} graphed against {e['psnr']:.4f} eager, alive "
          f"{g['alive']} against {e['alive']}, captures "
          f"{g['events']['capture']} (bound {bound}), {g['it_s']:.2f} it/s "
          f"against {e['it_s']:.2f}; on {card}", flush=True)
    pose_counts = phase_graph_pose(card, scene, cfg)
    print(f"phase 4k (b) {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    return g["counts"], pose_counts


def phase_graph_pose(card: str, scene, cfg) -> dict:
    """Phase 4k (b)'s SO3xR3 leg: ``Trainer.run`` with the pose optimizer
    on ``scene``, every view a training view (4d's split trains on two of
    twelve), for GRAPH_POSE_STEPS steps, graphed and then eager
    (``plain_steps``), the launch counters set to 0 just before each: one
    capture per active SH degree across every view (the view a device
    index in the graph's buffer), none eager; each step's loss and the
    final pose deltas within rtol 1e-3; K1 with rows, K2 and K3 exactly
    GRAPH_POSE_STEPS launches each.  Then the graphed pose step timed in
    turns against the non-pose graphed step (non-pose, pose, pose,
    non-pose, GRAPH_TIMED steps a turn, each ending in a synchronize) at
    SH degree GRAPH_SH.  Returns the graphed run's counts."""
    from touchgs_torch.config import PoseOptConfig
    from touchgs_torch.ops import rasterize_cuda as rc
    from touchgs_torch.train.trainer import Trainer

    pose_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, rasterize=dataclasses.replace(
            cfg.model.rasterize, k_tile=512, k_tile_max_train=512)),
        densify=dataclasses.replace(cfg.densify, warmup_steps=10 ** 6),
        pose_opt=PoseOptConfig(mode="SO3xR3"), log_every=1,
        sh_degree_interval=GRAPH_POSE_SH_INTERVAL)
    scene = dataclasses.replace(scene, i_train=np.arange(len(scene.cameras)))
    runs = {}
    for name in ("graph", "eager"):
        with (plain_steps() if name == "eager" else contextlib.nullcontext()):
            trainer = Trainer(scene, pose_cfg)
            views = []
            real = trainer._batch
            trainer._batch = lambda v: (views.append(v), real(v))[1]
            zero_launches()
            t0 = time.perf_counter()
            trainer.run(GRAPH_POSE_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[name] = dict(
            loss=np.array([m["loss"] for m in trainer.history]),
            pose=trainer.state.pose_deltas.cpu().numpy(),
            captures=trainer.events["capture"], counts=dict(rc.launches),
            views=sorted(set(views)), wall_s=wall,
            sh=trainer.active_sh_degree(GRAPH_POSE_STEPS - 1),
            pool=(pool_bytes(trainer.train_step.pool)
                  if name == "graph" else 0))
        del trainer
        torch.cuda.empty_cache()
    g, e = runs["graph"], runs["eager"]
    rel = np.abs(g["loss"] - e["loss"]) / np.abs(e["loss"])
    gap = float(np.abs(g["pose"] - e["pose"]).max())
    print(f"graph pose (SO3xR3): {GRAPH_POSE_STEPS} steps over views "
          f"{g['views']} at SH 0..{g['sh']}: captures {g['captures']} "
          f"graphed, {e['captures']} eager; losses at most {rel.max():.3e} "
          f"apart (relative); pose deltas |max| "
          f"{float(np.abs(e['pose']).max()):.3e}, at most {gap:.3e} apart; "
          f"graph pool {g['pool'] / 2**20:.1f} MiB; {g['wall_s']:.2f} s "
          f"graphed against {e['wall_s']:.2f} s eager; launches "
          f"{g['counts']}", flush=True)
    want = {k: GRAPH_POSE_STEPS if k in POSE_PATH else 0
            for k in rc.launches}
    check(g["captures"] == g["sh"] + 1 and e["captures"] == 0
          and len(g["views"]) >= 3,
          f"graph pose: captures {g['captures']} for SH 0..{g['sh']} over "
          f"views {g['views']}, eager {e['captures']}")
    check(g["counts"] == want and e["counts"] == want,
          f"graph pose launches {g['counts']}, eager {e['counts']}, want "
          f"{want}")
    check(bool(np.isfinite(g["loss"]).all()) and rel.max() <= 1e-3
          and np.allclose(g["pose"], e["pose"], rtol=1e-3, atol=1e-8)
          and float(np.abs(g["pose"]).max()) > 0,
          f"graph pose against eager: losses {rel.max():.3e} apart, pose "
          f"deltas {gap:.3e}")

    # the graphed pose step against the non-pose graphed step, in turns
    trainers = {"non-pose": Trainer(scene, dataclasses.replace(
                    pose_cfg, pose_opt=PoseOptConfig())),
                "pose": Trainer(scene, pose_cfg)}
    views = [int(v) for v in scene.i_train]
    for tr in trainers.values():  # the capture at GRAPH_SH
        tr.state, _ = tr.train_step(tr.state, *tr._batch(views[0]),
                                    GRAPH_SH, tr.view_index(views[0]))
    times = {k: [] for k in trainers}
    for name in ("non-pose", "pose", "pose", "non-pose"):
        tr = trainers[name]
        for i in range(GRAPH_TIMED):
            v = views[i % len(views)]
            batch = (*tr._batch(v), GRAPH_SH, tr.view_index(v))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.state, _ = tr.train_step(tr.state, *batch)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    caps = {k: tr.events["capture"] for k, tr in trainers.items()}
    del trainers
    torch.cuda.empty_cache()
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"graph pose: median step {med['pose']:.3f} ms with SO3xR3 "
          f"against {med['non-pose']:.3f} ms without "
          f"({med['pose'] / med['non-pose']:.3f}x), both graphed, "
          f"{2 * GRAPH_TIMED} steps each in turns (non-pose, pose, pose, "
          f"non-pose) over {len(views)} views at SH {GRAPH_SH}, each ending "
          f"in a synchronize; captures {caps}; on {card}", flush=True)
    check(caps == {"non-pose": 1, "pose": 1},
          f"graph pose timing: captures {caps}, want one each")
    return g["counts"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from touchgs_torch.utils.profiling import card  # fails outside a checkout

    if sys.argv[1:] == ["--vision"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(card(), flush=True)
        phase_vision(card())
        return 0
    if sys.argv[1:] == ["--parallel"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(card(), flush=True)
        phase_parallel(card())
        return 0
    if sys.argv[1:] == ["--native"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(card(), flush=True)
        phase_native(card())
        return 0
    if sys.argv[1:] == ["--bench"]:
        print(card(), flush=True)
        phase_bench(card())
        return 0
    if sys.argv[1:] == ["--graph"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(card(), flush=True)
        from touchgs_torch.train.trainer import Trainer

        phase_graph_step(card(), Trainer(make_scene(), flagship_cfg()))
        torch.cuda.empty_cache()
        phase_graph_trainer(card(), graph_scene())
        return 0
    if sys.argv[1:] == ["--sensor"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(card(), flush=True)
        phase_sensor(card())
        phase_nerf(card())
        return 0
    if sys.argv[1:] == ["--tools"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(card(), flush=True)
        phase_tools(card())
        return 0
    if sys.argv[1:] == ["--shade"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(card(), flush=True)
        from touchgs_torch.ops import cuda_build

        cuda_build.build()
        print(cuda_build.build_logs.get("shade", "(shade already built)"))
        print(json.dumps({"kernels": phase_shade_kernels(
            torch.device("cuda"))}))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        print(card(), flush=True)
        phase_ab(torch.device("cuda"), sys.argv[2])
        phase_ab_anatomy(torch.device("cuda"), sys.argv[2])
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

    k4, loops = phase_build()
    kernels = (phase_kernels(dev) + phase_ssim_kernels(dev)
               + phase_shade_kernels(dev))
    phase_reference(dev)
    counts, trainer, step_ms = phase_train(card_name)
    phase_profile(lambda: trainer.run(trainer.state.step + PROFILE_STEPS))
    graph_counts = phase_graph_step(card_name, trainer)
    del trainer
    torch.cuda.empty_cache()
    phase_scan(dev, card_name, step_ms)
    torch.cuda.empty_cache()
    phase_demo(card_name)
    torch.cuda.empty_cache()
    phase_touch_card_vs_cpu(dev)
    touch_kernels = phase_touch_kernels(dev)
    touch_counts = phase_touch(card_name)
    torch.cuda.empty_cache()
    cli_counts, cli_scene = phase_cli(card_name)
    torch.cuda.empty_cache()
    graph_trainer_counts, pose_graph_counts = phase_graph_trainer(
        card_name, cli_scene)
    del cli_scene
    torch.cuda.empty_cache()
    pipeline_counts = phase_vision(card_name)
    torch.cuda.empty_cache()
    sensor_counts = phase_sensor(card_name)
    nerf_counts = phase_nerf(card_name)
    torch.cuda.empty_cache()
    parallel = phase_parallel(card_name)
    torch.cuda.empty_cache()
    native_counts = phase_native(card_name)
    torch.cuda.empty_cache()
    bench_counts = phase_bench(card_name, step_ms)
    torch.cuda.empty_cache()
    tools = phase_tools(card_name)
    torch.cuda.empty_cache()
    path_counts, x, probe = phase_anatomy_path()
    kernels += [k4] + phase_anatomy(x, probe, loops)
    # a kernel of the training path counts its launches there, any other
    # (K1's lists alone, K4-K6) on the anatomy path
    for k in kernels:
        main_path = counts.get(k["name"], 0) > 0
        k["path"] = "train" if main_path else "anatomy"
        k["launches"] = (counts if main_path else path_counts)[k["name"]]
        if main_path:
            k["launches_hard_scene"] = touch_counts[k["name"]]
            k["launches_cli"] = cli_counts[k["name"]]
            k["launches_pipeline"] = pipeline_counts[k["name"]]
            k["launches_sensor"] = sensor_counts[k["name"]]
            k["launches_nerf"] = nerf_counts[k["name"]]
            for path in ("viewer", "multiscene", "multiscene_mesh",
                         "sharded", "multiscene_graph", "mesh_graph",
                         "sharded_graph"):
                k[f"launches_{path}"] = parallel[path][k["name"]]
            k["launches_pose_graph"] = pose_graph_counts[k["name"]]
            k["launches_native"] = native_counts[k["name"]]
            k["launches_graph"] = graph_counts[k["name"]]
            k["launches_graph_trainer"] = graph_trainer_counts[k["name"]]
        if k["name"] in touch_kernels:  # K1-K3
            k["hard_scene"] = touch_kernels[k["name"]]
            # the largest error of K1-K3 against plain on each path's inputs
            k["parallel_max_abs_err"] = parallel["errors"]
        if k["name"] in bench_counts:  # K1-K4
            k["launches_bench"] = bench_counts[k["name"]]
        if k["name"] in tools["errors"]:  # K2, K3
            k["launches_tools"] = tools["counts"][k["name"]]
            k["tile_sweep"] = tools["errors"][k["name"]]
    print(f"chip_smoke: {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
