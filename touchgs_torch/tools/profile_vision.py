"""Time the monocular-depth nets and the DenseTact sensor nets on the card,
and their convolutions.

    python -m touchgs_torch.tools.profile_vision [--nets dpt stforce ...]

For each net at its published width on a random checkpoint
(``tools/random_checkpoint.py``), on one seeded image (480x640 through a
vision net's preprocess; a 640x640 tactile image, ImageNet-normalized, for
a sensor net), in float32 with TF32 off: the ms an image (median over CUDA
events) and the peak memory with the port's convolutions (``vision.dpt.
conv``: a stride-1 3×3 as unfold + matmul; ``touch.densetact_nets.conv``:
the same unless the shape is in its ``CUDNN_3X3``), then with every
convolution through cuDNN (``F.conv2d``), their largest difference, the
slowest convolutions under cuDNN, each beside the port's time for it, every
stride-1 3×3 shape timed both ways (`conv_shapes`), and under
``torch.profiler`` each way the device kernels one forward launches and
the one that takes the most device time.  One JSON line a net.  Exits 1
without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from touchgs_torch.tools.random_checkpoint import (ARCHS, SENSOR_ARCHS,
                                                   random_checkpoint)
from touchgs_torch.touch import densetact_nets, sensor_nets, swin_force
from touchgs_torch.vision import depth_anything, dpt, monodepth, zoedepth


def tactile(rgb, size: int = 640, device=None) -> torch.Tensor:
    """The top-left (size, size) of an RGB image, ImageNet-normalized as a
    tactile frame."""
    return sensor_nets.normalize_tactile(torch.as_tensor(
        np.asarray(rgb[:size, :size], np.float32), device=device))


# net → (class, preprocess, its size, the raw image's (H, W))
NETS = {"dpt": (dpt.DPT, dpt.preprocess, 384, (480, 640)),
        "zoe_n": (zoedepth.ZoeDepth, zoedepth.preprocess, (384, 512),
                  (480, 640)),
        "zoe_nk": (zoedepth.ZoeDepth, zoedepth.preprocess, (384, 512),
                   (480, 640)),
        "depth_anything": (depth_anything.DepthAnything,
                           depth_anything.preprocess, 518, (480, 640)),
        "densetact_depth": (densetact_nets.DenseDepth, tactile, 640,
                            (640, 640)),
        "densetact_force": (densetact_nets.DenseNetForce, tactile, 640,
                            (640, 640)),
        "stforce": (swin_force.STForce, tactile, 640, (640, 640))}
# the modules that call a ``conv`` of their own by name
CALLERS = (dpt, zoedepth, depth_anything, monodepth, densetact_nets)


def cudnn_conv(x, p, name, stride=1, padding="SAME"):
    return dpt.conv2d_xla(x, p[f"{name}.weight"], p.get(f"{name}.bias"),
                          stride, padding)


@contextlib.contextmanager
def conv_through(wrap):
    """Every caller's ``conv`` replaced by ``wrap(its own conv)`` inside the
    block, restored after."""
    saved = {mod: mod.conv for mod in CALLERS}
    for mod, own in saved.items():
        mod.conv = wrap(own)
    try:
        yield
    finally:
        for mod, own in saved.items():
            mod.conv = own


def median_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def conv_times(model, img, fn=None) -> list:
    """(ms, name, input shape, weight shape, stride) of every ``conv`` call
    of one forward, one at a time, through ``fn`` (None: the port's own)."""
    rows = []

    def wrap(own):
        call = own if fn is None else fn

        def timed(x, p, name, stride=1, padding="SAME"):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            y = call(x, p, name, stride, padding)
            b.record()
            b.synchronize()
            rows.append((a.elapsed_time(b), name, tuple(x.shape),
                         tuple(p[f"{name}.weight"].shape), stride))
            return y

        return timed

    with conv_through(wrap):
        model(img)
    return rows


def conv_shapes(model, img, runs: int = 3) -> list:
    """Every stride-1 3×3 shape of one forward, timed as unfold + matmul
    (`vision.dpt.conv`) and through cuDNN: its input and weight shapes, its
    calls a forward, each way's ms summed over them (the median of ``runs``
    forwards), which is faster and which the port takes."""
    totals = {}
    for mode, fn in (("unfold", dpt.conv), ("cudnn", cudnn_conv)):
        for _ in range(runs):
            sums = {}
            for ms, _, x, w, stride in conv_times(model, img, fn):
                if stride == 1 and w[2:] == (3, 3):
                    key = (x, w)
                    sums[key] = sums.get(key, 0.0) + ms
            for key, ms in sums.items():
                totals.setdefault(key, {}).setdefault(mode, []).append(ms)
    counts = {}
    for _, _, x, w, stride in conv_times(model, img, dpt.conv):
        if stride == 1 and w[2:] == (3, 3):
            counts[(x, w)] = counts.get((x, w), 0) + 1
    dense = isinstance(model, (densetact_nets.DenseDepth,
                               densetact_nets.DenseNetForce))
    rows = []
    for (x, w), t in totals.items():
        ms = {mode: float(np.median(v)) for mode, v in t.items()}
        port = ("cudnn" if dense and (x[1], w[0]) + x[2:]
                in densetact_nets.CUDNN_3X3 else "unfold")
        rows.append({"x": list(x), "w": list(w), "calls": counts[(x, w)],
                     "unfold_ms": ms["unfold"], "cudnn_ms": ms["cudnn"],
                     "faster": min(("unfold", "cudnn"), key=ms.get),
                     "port": port})
    return rows


def kernel_census(fn) -> dict:
    """Device kernels launched by one call of ``fn`` under torch.profiler:
    their count, and the one with the most device time (name, launches,
    ms)."""
    from torch.profiler import ProfilerActivity, profile as trace

    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = max(kernels, key=lambda e: e.self_device_time_total)
    return {"kernels": sum(e.count for e in kernels),
            "top_kernel": top.key[:80], "top_launches": top.count,
            "top_ms": top.self_device_time_total / 1e3}


def profile(net: str, seed: int = 11, top: int = 3,
            device: str = "cuda") -> dict:
    cls, pre, size, raw = NETS[net]
    kind, arch = {**ARCHS, **SENSOR_ARCHS}[net]
    model = cls(random_checkpoint(kind, arch, seed), arch).to(device)
    rgb = np.random.default_rng(seed).integers(0, 256, raw + (3,),
                                               dtype=np.uint8)
    img = pre(rgb, size=size, device=device)
    row = {"net": net, "input": list(img.shape[:2])}
    outs = {}
    for mode, fn in (("port", None), ("cudnn", cudnn_conv)):
        with conv_through(lambda own: own if fn is None else fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            outs[mode] = model(img)
            row[f"{mode}_ms"] = median_ms(lambda: model(img))
            row[f"{mode}_peak_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2**30)
            if device == "cuda":
                row[f"{mode}_trace"] = kernel_census(lambda: model(img))
    row["max_diff"] = float((outs["port"] - outs["cudnn"]).abs().max())
    slow = sorted(conv_times(model, img, cudnn_conv), reverse=True)[:top]
    port = {r[1]: r[0] for r in conv_times(model, img)}
    row["slowest_cudnn_convs"] = [
        {"name": name, "cudnn_ms": ms, "port_ms": port[name], "x": x, "w": w,
         "stride": stride} for ms, name, x, w, stride in slow]
    row["conv_shapes"] = conv_shapes(model, img)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nets", nargs="+", choices=sorted(NETS),
                   default=list(NETS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_vision: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from touchgs_torch.utils.profiling import card

    print(card(), flush=True)
    with torch.no_grad():
        for net in args.nets:
            print(json.dumps(profile(net)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
