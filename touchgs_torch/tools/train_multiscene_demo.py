"""Multi-scene batch training with per-scene density control (port of
``tools/train_multiscene_demo.py``).

S synthetic scenes (random Gaussians seen from a ring of cameras, the GT
rendered by the port) train at once through ``parallel/multiscene.py``:
one step for all scenes, densification per scene on the single-scene
schedule.  Each scene is then trained alone by a ``Trainer`` with the same
configuration, and the two are set side by side: eval PSNR, alive counts
and the wall-clock of each.  On CUDA every render goes through the tile
kernels, the S scenes of a step through one launch of each, the step
captured as a CUDA graph and replayed (its first step, the capture, timed
and printed as ``first step (capture)``); with ``--device cpu`` through
the scan path.

``--data D --model M`` trains the batch over a D × M mesh of processes, as
the JAX tool does on its ``data=4, model=2`` mesh: scenes on ``data``,
each scene's Gaussians and tiles on ``model``.  Run it under ``torchrun``
with D·M processes (NCCL, one process a GPU; gloo with ``--device
cpu``).  A mesh that is not the world raises: without a process group,
only ``--data 1 --model 1``.  Rank 0 prints, evaluates and runs the
single-scene comparison.

    python -m touchgs_torch.tools.train_multiscene_demo            # the GPU
    python -m touchgs_torch.tools.train_multiscene_demo --device cpu --scenes 2 --steps 250
    torchrun --nproc_per_node 4 -m touchgs_torch.tools.train_multiscene_demo --device cpu --data 2 --model 2

It prints one JSON line a scene, then the markdown table; ``--out FILE``
also appends the table to FILE (nothing is written otherwise).
``main(argv)`` returns the rows and the times (on ranks other than 0,
the alive counts alone).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from touchgs_torch.config import (DensifyConfig, ModelConfig, OptimConfig,
                                  RasterizeConfig, TrainConfig)
from touchgs_torch.data.cameras import Cameras
from touchgs_torch.data.scene import Scene
from touchgs_torch.models.gaussians import GaussianParams, init_from_points
from touchgs_torch.models.splatfacto import render
from touchgs_torch.ops.sh import rgb_to_sh_dc
from touchgs_torch.parallel.distributed import init_distributed
from touchgs_torch.parallel.mesh import make_mesh
from touchgs_torch.parallel.multiscene import (
    alive_per_scene,
    gather_multiscene_state,
    make_multiscene_state,
    make_multiscene_train_step,
    run_multiscene,
    scene_params,
    shard_multiscene_state,
)
from touchgs_torch.tools.train_scale_demo import look_at_camera
from touchgs_torch.train.optim import FusedAdam
from touchgs_torch.train.trainer import Trainer


def random_gaussians(n: int, seed: int = 0, spread: float = 0.5) -> tuple:
    """numpy (means, quats, scales, colors, opacities) of ``n`` random
    Gaussians inside ±spread, as ``tests/synthetic.py`` draws them."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = np.exp(rng.uniform(-4.5, -3.0, (n, 3))).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    return means, quats, scales, colors, opac


def synthetic_scene(seed: int, n_views: int = 6, width: int = 96,
                    height: int = 72, n_gauss: int = 300,
                    use_pallas: bool = False,
                    device: torch.device | str = "cuda") -> Scene:
    """A scene of ``n_gauss`` random Gaussians seen from a ring of
    ``n_views`` cameras (``tests/test_train.py``'s), its GT images and
    depths rendered at SH 0, seeded from the GT means with N(0, 0.05)
    noise."""
    means, quats, scales, colors, opac = random_gaussians(n_gauss, seed)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    gt = GaussianParams(
        means=t(means), quats=t(quats), log_scales=t(np.log(scales)),
        logit_opacities=t(np.log(opac / (1 - opac))),
        sh_dc=t(rgb_to_sh_dc(colors)),
        sh_rest=torch.zeros((n_gauss, 0, 3), device=device),
        alive=torch.ones((n_gauss,), dtype=torch.bool, device=device))
    mcfg = ModelConfig(max_gaussians=n_gauss, sh_degree=0,
                       rasterize=RasterizeConfig(gaussian_chunk=128,
                                                 use_pallas=use_pallas,
                                                 k_tile=8192))
    cams = [look_at_camera(eye=(2.0 * np.cos(a), 2.0 * np.sin(a), 1.0),
                           width=width, height=height, focal=0.9375 * width,
                           device=device)
            for a in 2 * np.pi * np.arange(n_views) / n_views]
    images, depths = [], []
    for cam in cams:
        with torch.no_grad():
            out, _ = render(gt, cam, mcfg, active_sh_degree=0)
        images.append(out.rgb.cpu().numpy())
        depths.append(out.depth.cpu().numpy())
    return Scene(
        cameras=Cameras(
            fx=np.array([float(c.fx) for c in cams], np.float32),
            fy=np.array([float(c.fy) for c in cams], np.float32),
            cx=np.array([float(c.cx) for c in cams], np.float32),
            cy=np.array([float(c.cy) for c in cams], np.float32),
            c2w=np.stack([c.c2w.cpu().numpy() for c in cams]),
            width=width, height=height),
        images=np.stack(images), depths=np.stack(depths),
        uncertainties=np.ones((n_views, height, width), np.float32),
        i_train=np.arange(n_views), i_eval=np.array([], int),
        seed_points=means + np.random.default_rng(seed + 1).normal(
            0, 0.05, means.shape).astype(np.float32),
        seed_colors=colors, scale_factor=1.0, transform=np.eye(4)[:3],
        name=f"synthetic{seed}")


def demo_cfg(steps: int, capacity: int, use_pallas: bool) -> TrainConfig:
    """The JAX demo's configuration."""
    return TrainConfig(
        max_steps=steps,
        model=ModelConfig(max_gaussians=capacity, sh_degree=1,
                          rasterize=RasterizeConfig(gaussian_chunk=128,
                                                    use_pallas=use_pallas)),
        densify=DensifyConfig(warmup_steps=60, refine_every=60,
                              stop_refine_at=steps - 60,
                              reset_opacity_every=10 ** 6,
                              prune_opacity_threshold=0.005),
        optim=OptimConfig(means_lr_max_steps=steps),
        sh_degree_interval=max(steps // 2, 1), grow_capacity=False,
        log_every=max(steps // 5, 1), seed=0)


def scene_views(scenes, views, device) -> tuple:
    """(stacked cameras, images, depths, uncertainties) of view ``views[s]``
    of each scene ``s``, on ``device``."""
    from touchgs_torch.parallel.multiscene import stack_cameras

    def stack(attr):
        return torch.as_tensor(np.stack([getattr(sc, attr)[v]
                                         for sc, v in zip(scenes, views)]),
                               device=device)

    cams = stack_cameras([sc.cameras.at(v, device)
                          for sc, v in zip(scenes, views)])
    return cams, stack("images"), stack("depths"), stack("uncertainties")


def mean_psnr(params: GaussianParams, scene: Scene, cfg: TrainConfig,
              device) -> float:
    """Mean PSNR of ``params`` over every view of ``scene``."""
    ps = []
    for v in range(len(scene.cameras)):
        with torch.no_grad():
            out, _ = render(params, scene.cameras.at(v, device), cfg.model,
                            active_sh_degree=1)
        mse = float(np.mean((out.rgb.cpu().numpy() - scene.images[v]) ** 2))
        ps.append(-10 * np.log10(max(mse, 1e-10)))
    return float(np.mean(ps))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--out", default=None,
                    help="append the markdown table to this file")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the tile kernels) or cpu (the scan path)")
    ap.add_argument("--data", type=int, default=1,
                    help="mesh ranks over the scenes")
    ap.add_argument("--model", type=int, default=1,
                    help="mesh ranks over each scene's Gaussians and tiles")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_multiscene_demo wants a CUDA device and "
                           "none is available; pass --device cpu")
    init_distributed(device=dev)
    mesh = make_mesh(data=args.data, model=args.model)
    lead = mesh.rank == 0
    use_pallas = dev.type == "cuda"
    S, steps = args.scenes, args.steps
    cfg = demo_cfg(steps, args.capacity, use_pallas)
    if lead:
        print(f"building {S} scenes...", flush=True)
    scenes = [synthetic_scene(7 * s + 1, use_pallas=use_pallas, device=dev)
              for s in range(S)]
    n_views, W, H = len(scenes[0].cameras), scenes[0].cameras.width, \
        scenes[0].cameras.height

    params = [init_from_points(sc.seed_points, sc.seed_colors,
                               capacity=args.capacity, sh_degree=1, seed=s,
                               device=dev)
              for s, sc in enumerate(scenes)]
    opt = FusedAdam(cfg.optim)
    state = shard_multiscene_state(make_multiscene_state(params, cfg, opt),
                                   mesh)
    graphed = make_multiscene_train_step(cfg, opt, mesh)
    first: dict = {}

    def step(state, *batch):
        """The graphed step; the first call timed alone (on the card its
        warm-up, capture and one replay)."""
        if first:
            return graphed(state, *batch)
        _sync(dev)
        t = time.perf_counter()
        out = graphed(state, *batch)
        _sync(dev)
        first["s"] = time.perf_counter() - t
        if lead:
            label = ("first step (capture)" if dev.type == "cuda"
                     else "first step")
            print(f"{label}: {first['s']:.3f} s", flush=True)
        return out

    alive0 = alive_per_scene(state, mesh).tolist()
    view_rng = np.random.default_rng(123)

    def batch_fn(step_i, rng):
        views = [int(view_rng.choice(sc.i_train)) for sc in scenes]
        return (*scene_views(scenes, views, dev),
                min(step_i // cfg.sh_degree_interval, 1))

    _sync(dev)
    t0 = time.perf_counter()
    state, _ = run_multiscene(state, cfg, step, batch_fn, steps=steps,
                              n_train_views=n_views,
                              log_fn=(lambda m: print(m, flush=True))
                              if lead else None, mesh=mesh)
    _sync(dev)
    ms_s = time.perf_counter() - t0
    state = gather_multiscene_state(state, mesh)
    alive1 = state.params.alive.sum(dim=-1).tolist()
    if alive1 == alive0:
        raise RuntimeError("multi-scene densification never fired")
    if not lead:
        return {"alive": alive1}
    ms_psnr = [mean_psnr(scene_params(state.params, s), sc, cfg, dev)
               for s, sc in enumerate(scenes)]

    ss_psnr, ss_alive, ss_s = [], [], 0.0
    for s, sc in enumerate(scenes):
        tr = Trainer(sc, dataclasses.replace(cfg, seed=s), device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        tr.run(max_steps=steps)
        _sync(dev)
        ss_s += time.perf_counter() - t0
        ss_psnr.append(mean_psnr(tr.state.params, sc, cfg, dev))
        ss_alive.append(int(tr.state.params.num_alive))

    rows = [{"scene": s, "alive0": alive0[s], "ms_alive": alive1[s],
             "single_alive": ss_alive[s], "ms_psnr": ms_psnr[s],
             "single_psnr": ss_psnr[s]} for s in range(S)]
    for r in rows:
        print(json.dumps(r), flush=True)
    table = "\n".join(
        f"| {r['scene']} | {r['alive0']} | {r['ms_alive']} | "
        f"{r['single_alive']} | {r['ms_psnr']:.2f} dB | "
        f"{r['single_psnr']:.2f} dB | {r['ms_psnr'] - r['single_psnr']:+.2f} |"
        for r in rows)
    md = f"""
## Multi-scene batch training with per-scene densification

`python -m touchgs_torch.tools.train_multiscene_demo`: {S} synthetic scenes
({n_views} views of {W}x{H}) trained at once on `{args.device}` over a
data={mesh.data} × model={mesh.model} mesh of {mesh.size} process(es)
({steps} steps, capacity {args.capacity}) against a single-scene `Trainer`
run of each.  Multi-scene {ms_s:.1f} s for all {S} scenes together
({steps / ms_s:.2f} batched it/s); the {S} single runs {ss_s:.1f} s.

| scene | seeds alive | multi-scene alive | single alive | multi PSNR | single PSNR | Δ |
|---|---|---|---|---|---|---|
{table}
"""
    print(md, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(md)
    return {"rows": rows, "multiscene_s": ms_s, "single_s": ss_s,
            "first_step_s": first["s"]}


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
