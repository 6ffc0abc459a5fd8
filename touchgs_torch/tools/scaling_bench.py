"""Train-step throughput against the number of ranks (port of
``tools/scaling_bench.py``).

Each rank runs ``parallel/sharded.py``'s step on one 256x256 view of 20k
random Gaussians in a capacity of 32768 (SH 1): the parameters split by
rows over the ranks, the tile grid by slices, through K1-K3 on CUDA and
the scan path on the CPU.  Rank 0 prints one JSON line a measurement:

    {"n_devices": N, "iters_per_sec": X, "mpix_per_sec": Y,
     "mesh": {"data": D, "model": M}, "backend": "nccl", "device": "...",
     "loss": L, "first_step_s": T}

On the card the step is a CUDA graph: the first step's seconds (warm-up,
capture and one replay) are ``first_step_s``, also printed to stderr as
``first step (capture)``, as ``bench_torch.py`` prints them.

On GPUs, one process a card, under torchrun (NCCL; ``init_distributed``
reads torchrun's variables):

    torchrun --nproc_per_node 1 -m touchgs_torch.tools.scaling_bench

A machine with one card measures a world of one only: NCCL refuses two
ranks on one GPU.  On the CPU, ``--device cpu --sweep 1,2,4`` starts each
world's gloo processes itself, one world after another.  ``--out FILE``
appends the lines to FILE; nothing is written otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH = HEIGHT = 256
N_GAUSS, CAPACITY = 20_000, 32_768
STEPS, WARMUP = 10, 2


def measure(device: torch.device) -> dict:
    """Time STEPS sharded steps after WARMUP on this rank's share of the
    world (``init_distributed`` first, from the environment)."""
    from touchgs_torch.config import ModelConfig, RasterizeConfig, TrainConfig
    from touchgs_torch.data.cameras import Camera
    from touchgs_torch.models.densify import DensifyState
    from touchgs_torch.models.gaussians import init_random
    from touchgs_torch.parallel.distributed import global_mesh, init_distributed
    from touchgs_torch.parallel.sharded import (make_sharded_train_step,
                                                shard_state)
    from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam
    from touchgs_torch.train.trainer import TrainState

    init_distributed(device=device)
    n = (torch.distributed.get_world_size()
         if torch.distributed.is_initialized() else 1)
    mesh = global_mesh(model=2 if n >= 4 and n % 2 == 0 else 1)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = TrainConfig(model=ModelConfig(
        max_gaussians=CAPACITY, sh_degree=1,
        rasterize=RasterizeConfig(use_pallas=device.type == "cuda")))
    params = init_random(n=N_GAUSS, capacity=CAPACITY, sh_degree=1,
                         device=device)
    optimizer = FusedAdam(cfg.optim)
    state = shard_state(TrainState(
        params=params,
        opt_state=optimizer.init({g: getattr(params, g)
                                  for g in PARAM_GROUPS}),
        densify=DensifyState.zeros(CAPACITY, device), step=0), mesh)

    def scalar(v):
        return torch.tensor(np.float32(v), device=device)

    cam = Camera(fx=scalar(0.9 * WIDTH), fy=scalar(0.9 * WIDTH),
                 cx=scalar(WIDTH / 2), cy=scalar(HEIGHT / 2),
                 c2w=torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0],
                                   [0, 0, 1, 2.5], [0, 0, 0, 1]],
                                  device=device),
                 width=WIDTH, height=HEIGHT)
    rng = np.random.default_rng(0)
    image = torch.tensor(rng.uniform(0, 1, (HEIGHT, WIDTH, 3)),
                         dtype=torch.float32, device=device)
    depth = torch.tensor(rng.uniform(1, 3, (HEIGHT, WIDTH)),
                         dtype=torch.float32, device=device)
    unc = torch.ones((HEIGHT, WIDTH), device=device)
    step = make_sharded_train_step(cfg, mesh, optimizer)

    def sync(m):
        float(m["loss"])   # waits for the step on every backend

    # on the card the first step warms up, captures the step as a CUDA
    # graph (its collectives inside) and replays it once
    t0 = time.perf_counter()
    state, m = step(state, cam, image, depth, unc, 1)
    sync(m)
    first_s = time.perf_counter() - t0
    if mesh.rank == 0:
        label = ("first step (capture)" if device.type == "cuda"
                 else "first step")
        print(f"{label}: {first_s:.3f} s", file=sys.stderr, flush=True)
    for _ in range(WARMUP - 1):
        state, m = step(state, cam, image, depth, unc, 1)
    sync(m)
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, m = step(state, cam, image, depth, unc, 1)
    sync(m)
    ips = STEPS / (time.perf_counter() - t0)
    return {
        "n_devices": n,
        "iters_per_sec": ips,
        "mpix_per_sec": ips * WIDTH * HEIGHT / 1e6,
        "mesh": mesh.shape,
        "backend": (torch.distributed.get_backend()
                    if torch.distributed.is_initialized() else "none"),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "loss": float(m["loss"]),
        "first_step_s": first_s,
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cpu_world(n: int) -> str:
    """Run a world of ``n`` gloo processes on the CPU; rank 0's line."""
    env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               NUM_PROCESSES=str(n), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "touchgs_torch.tools.scaling_bench",
         "--device", "cpu"],
        env=dict(env, PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    outs = [p.communicate(timeout=1800) for p in procs]
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"world {n}, rank {r} failed:\n{err[-2000:]}")
    return outs[0][0].strip().splitlines()[-1]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, K1-K3) or cpu (gloo, the scan path)")
    ap.add_argument("--sweep", default=None,
                    help="with --device cpu: comma-separated world sizes, "
                         "each run in its own gloo processes")
    ap.add_argument("--out", default=None, help="append the lines here")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("scaling_bench wants a CUDA device and none is "
                           "available; pass --device cpu for gloo")
    if args.sweep:
        if dev.type != "cpu":
            raise ValueError("--sweep starts its own processes on the CPU "
                             "only; on GPUs run one world under torchrun")
        lines = [_cpu_world(int(n))
                 for n in args.sweep.split(",")]
    else:
        result = measure(dev)
        rank = (torch.distributed.get_rank()
                if torch.distributed.is_initialized() else 0)
        lines = [json.dumps(result)] if rank == 0 else []
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    for line in lines:
        print(line, flush=True)
    if args.out and lines:
        with open(args.out, "a") as f:
            f.write("".join(line + "\n" for line in lines))
    return lines


if __name__ == "__main__":
    main()
