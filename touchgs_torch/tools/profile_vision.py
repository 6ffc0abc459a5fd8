"""Time the monocular-depth nets on the card, and their convolutions.

    python -m touchgs_torch.tools.profile_vision [--nets dpt zoe_n ...]

For each net at its published width on a random checkpoint
(``tools/random_checkpoint.py``), on one seeded 480x640 image through its
preprocess, in float32 with TF32 off: the ms an image (median over CUDA
events) and the peak memory with the port's convolutions
(``vision.dpt.conv``: a stride-1 3×3 as unfold + matmul), then with every
convolution through cuDNN (``F.conv2d``), their largest difference, and
the slowest convolutions under cuDNN, each beside the port's time for it,
and under ``torch.profiler`` each way the device kernels one forward
launches and the one that takes the most device time.  One JSON line a
net.  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from touchgs_torch.tools.random_checkpoint import ARCHS, random_checkpoint
from touchgs_torch.vision import depth_anything, dpt, monodepth, zoedepth

NETS = {"dpt": (dpt.DPT, dpt.preprocess, 384),
        "zoe_n": (zoedepth.ZoeDepth, zoedepth.preprocess, (384, 512)),
        "zoe_nk": (zoedepth.ZoeDepth, zoedepth.preprocess, (384, 512)),
        "depth_anything": (depth_anything.DepthAnything,
                           depth_anything.preprocess, 518)}
# the modules that call ``conv`` by name, and the port's own
CALLERS = (dpt, zoedepth, depth_anything, monodepth)
PORT_CONV = dpt.conv


def cudnn_conv(x, p, name, stride=1, padding="SAME"):
    return dpt.conv2d_xla(x, p[f"{name}.weight"], p.get(f"{name}.bias"),
                          stride, padding)


def use_conv(fn) -> None:
    for mod in CALLERS:
        mod.conv = fn


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


def conv_times(model, img, fn) -> list:
    """(ms, name, input shape, weight shape, stride, padding) of every
    ``conv`` call of one forward through ``fn``, one at a time."""
    rows = []

    def timed(x, p, name, stride=1, padding="SAME"):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        y = fn(x, p, name, stride, padding)
        b.record()
        b.synchronize()
        rows.append((a.elapsed_time(b), name, tuple(x.shape),
                     tuple(p[f"{name}.weight"].shape), stride, padding))
        return y

    use_conv(timed)
    try:
        model(img)
    finally:
        use_conv(PORT_CONV)
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
    cls, pre, size = NETS[net]
    kind, arch = ARCHS[net]
    model = cls(random_checkpoint(kind, arch, seed), arch).to(device)
    rgb = np.random.default_rng(seed).integers(0, 256, (480, 640, 3),
                                               dtype=np.uint8)
    img = pre(rgb, size=size, device=device)
    row = {"net": net, "input": list(img.shape[:2])}
    outs = {}
    for mode, fn in (("port", PORT_CONV), ("cudnn", cudnn_conv)):
        use_conv(fn)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            outs[mode] = model(img)
            row[f"{mode}_ms"] = median_ms(lambda: model(img))
            row[f"{mode}_peak_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2**30)
            if device == "cuda":
                row[f"{mode}_trace"] = kernel_census(lambda: model(img))
        finally:
            use_conv(PORT_CONV)
    row["max_diff"] = float((outs["port"] - outs["cudnn"]).abs().max())
    slow = sorted(conv_times(model, img, cudnn_conv), reverse=True)[:top]
    port = {r[1]: r[0] for r in conv_times(model, img, PORT_CONV)}
    row["slowest_cudnn_convs"] = [
        {"name": name, "cudnn_ms": ms, "port_ms": port[name], "x": x, "w": w,
         "stride": stride} for ms, name, x, w, stride, _ in slow]
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
