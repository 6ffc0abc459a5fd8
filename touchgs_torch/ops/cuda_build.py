"""Build and load the CUDA kernels under ``touchgs_torch/csrc/``.

Each ``<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C launcher (``<name>_launch``), loaded with ``ctypes``;
``ssim.cu`` and ``shade.cu`` hold two each (``ssim_fwd_launch``,
``ssim_bwd_launch``; ``shade_fwd_launch``, ``shade_bwd_launch``).
Builds happen at first use, one ``nvcc`` process per source, all started
together, into ``csrc/build/<hash of the sources and flags>/``, so a changed
source rebuilds and an unchanged one is reused.  Nothing is built on import.

Beside the build: the helpers every kernel wrapper uses (device dispatch,
argument checks, the raw handle of the current stream), the launch itself
with its count (``launch``, ``launches``), and ``compile_smoke``, the
build-and-launch check (port of ``bench.py::pallas_compile_smoke``).

``launches`` counts every kernel launch by key: a wrapper's name (K1's
lists alone, ``slot_lists``, and with their rows, ``slot_rows``, apart; K5
by mode, ``anatomy_<mode>``; K6 by leg, ``bf16_probe_<leg>``).  A CUDA
graph's capture and warm-up count theirs apart (``launches_on``), and each
replay adds its capture's counts (``add_launches``).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"
KERNELS = ("slot_lists", "composite_fwd", "composite_bwd", "compile_smoke",
           "anatomy_variants", "bf16_probe", "ssim", "shade")
# launchers that live in another source's library than their own name's
LIBRARY = {"ssim_fwd": "ssim", "ssim_bwd": "ssim", "shade_fwd": "shade",
           "shade_bwd": "shade"}
# No fast-math flag: exp2f and the divides stay IEEE-accurate.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-source extra flags: K3 and the shade kernels round every operation on
# its own, as their plain versions do (see composite_bwd.cu, shade.cu)
EXTRA_FLAGS = {"composite_bwd": ("-fmad=false",), "shade": ("-fmad=false",)}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# launcher argument types: pointers and the stream as c_void_p
SIGNATURES = {
    # sorted_gauss, starts, counts, attrs (or null), gidx, rows (or null);
    # n_tiles, k_tile, dead, tile0; stream
    "slot_lists": [_P] * 6 + [_I] * 4 + [_P],
    "composite_fwd": [_P, _P, _P, _P] + [_I] * 6 + [_F, _F, _I, _P],
    "composite_bwd": [_P] * 6 + [_I] * 6 + [_F, _F, _P],
    "compile_smoke": [_P, _P, _I, _P],
    # n_chunks, tile_ids, attrs, out, scratch; mode, n_tiles, th, tw,
    # k_tile, k_chunk, n_tx; alpha_clip, alpha_thr; stream
    "anatomy_variants": [_P] * 5 + [_I] * 7 + [_F, _F, _P],
    # attrs, out; bf16 (0/1), n_tiles; stream
    "bf16_probe": [_P, _P, _I, _I, _P],
    # x, y; C, H, W; x's and y's strides; taps (host); c1, c2; maps (or
    # null), scratch, its words, out; stream
    "ssim_fwd": [_P, _P] + [_I] * 9 + [_P, _F, _F, _P, _P, _I, _P, _P],
    # x, y; C, H, W; x's and y's strides; taps (host), maps, grad, dx;
    # dx's strides; stream
    "ssim_bwd": [_P, _P] + [_I] * 9 + [_P] * 4 + [_I] * 3 + [_P],
    # means, quats, log_scales, logit_opacities, sh_dc, sh_rest, alive,
    # offset (or null), w2c, c2w, fx, fy, cx, cy; table, means2d, depths,
    # radii, cull_radii, valid; n, dead, n_rest, active, width, height;
    # near, eps2d, sigma_cutoff, 1 / alpha_threshold; stream
    "shade_fwd": [_P] * 20 + [_I] * 6 + [_F] * 4 + [_P],
    # grad_table, the six groups, w2c, c2w, fx, fy, cx, cy; their seven
    # gradients (the offset's last); n, n_rest, active, width, height;
    # near, eps2d; stream
    "shade_bwd": [_P] * 20 + [_I] * 5 + [_F] * 2 + [_P],
}
# kernel launches by key; only a launch of a CUDA kernel counts.  A live
# viewer renders on another thread than training, so the counts are
# incremented under a lock.
launches = dict.fromkeys((
    "slot_lists", "slot_rows", "composite_fwd", "composite_bwd", "ssim_fwd",
    "ssim_bwd", "shade_fwd", "shade_bwd", "compile_smoke", "anatomy_full",
    "anatomy_no_mxu", "anatomy_alpha_only", "anatomy_noexp",
    "bf16_probe_f32", "bf16_probe_bf16"), 0)
# the launches of the graphed step's warm-ups, on a clone of the state
# (``train/graphs.py``), counted apart from ``launches``
launches_warmup = dict.fromkeys(launches, 0)
_count_lock = threading.Lock()
# raw stream handle -> the dict that counts the launches made on that stream
# instead of ``launches`` (``launches_on``)
_redirect: dict = {}

_launchers: dict = {}
# ptxas output (registers, shared memory, spills) of the last build, by kernel
build_logs: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_dir(src: Path = CSRC) -> Path:
    h = hashlib.sha256(repr((NVCC_FLAGS, EXTRA_FLAGS)).encode())
    for p in sorted(src.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(src: Path = CSRC, names: tuple = KERNELS) -> Path:
    """Compile every kernel library of ``names`` that is missing, from the
    sources in ``src`` (the package's own by default); returns the
    directory."""
    out_dir = build_dir(src)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o",
               str(tmp), str(src / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out_dir


def library(name: str, src: Path = CSRC) -> Path:
    """``lib<name>.so`` built from ``src``: the package's own sources build
    all their libraries at once, other sources only ``name``'s."""
    return build(src, KERNELS if src == CSRC else (name,)) / f"lib{name}.so"


def sass(name: str, src: Path = CSRC) -> dict:
    """{kernel function: [(address, opcode, operands)]} of ``lib<name>.so``
    built from ``src``, from ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
         str(library(name, src))],
        capture_output=True, text=True, check=True).stdout
    code: dict = {}
    current = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = code.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][\w.]*)([^;]*)", line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return code


def sass_counts(name: str) -> dict:
    """{kernel function: Counter of SASS opcodes} of ``lib<name>.so``
    (static counts: an unrolled loop counts once per copy)."""
    return {fn: collections.Counter(op for _, op, _ in ins)
            for fn, ins in sass(name).items()}


# The opcodes by which an entry loop is found, in order: exp2 (MUFU.EX2, or
# a variant of it such as a packed bf16 form) where the kernel has one, else
# the α clip's min (FMNMX: K5's noexp has no exp2).
LOOP_MARKERS = ("MUFU.EX2", "FMNMX")


def is_op(op: str, name: str) -> bool:
    """True when the SASS opcode ``op`` is ``name`` or a variant of it
    (``MUFU.EX2.F16x2`` is a ``MUFU.EX2``)."""
    return op == name or op.startswith(name + ".")


def sass_loop_counts(name: str, src: Path = CSRC) -> dict:
    """{kernel function: Counter of the SASS opcodes of its entry loop}: of
    the innermost loops (from a backward branch's target to the branch)
    that hold instructions of the function's marker, the first of
    LOOP_MARKERS it has, the one that holds the most of them: where the
    compiler unrolled the entry loop and left a remainder loop beside it,
    the unrolled body.  Functions without such a loop are left out."""
    loops = {}
    for fn, ins in sass(name, src).items():
        marker = next((m for m in LOOP_MARKERS
                       if any(is_op(op, m) for _, op, _ in ins)), None)
        marks = [a for a, op, _ in ins if marker and is_op(op, marker)]
        spans = []
        for addr, op, rest in ins:
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
                lo = int(m.group(1), 16)
                n = sum(lo <= a <= addr for a in marks)
                if n:
                    spans.append((lo, addr, n))
        inner = [(lo, hi, n) for lo, hi, n in spans
                 if not any(lo <= o[0] and o[1] <= hi and o[:2] != (lo, hi)
                            for o in spans)]
        if inner:
            lo, hi, _ = max(inner, key=lambda s: (s[2], s[0] - s[1]))
            loops[fn] = collections.Counter(op for a, op, _ in ins
                                            if lo <= a <= hi)
    return loops


def launcher(name: str, src: Path = CSRC):
    """The ``<name>_launch`` C function, building the libraries if needed;
    ``src`` other than the package's sources builds and loads those."""
    fn = _launchers.get((name, src))
    if fn is None:
        lib = ctypes.CDLL(str(library(LIBRARY.get(name, name), src)))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _launchers[(name, src)] = fn
    return fn


INFO_KEYS = ("pixels_per_thread", "threads", "registers", "blocks_per_sm",
             "shared_bytes")


def kernel_info(name: str, npix: int, k_chunk: int, variant: int = 0) -> dict:
    """Launch shape of a kernel in K2's thread shape (``composite_fwd`` with
    ``variant`` its early_exit flag, ``composite_bwd``, or
    ``anatomy_variants`` with ``variant`` the index of its mode in
    ``anatomy.MODES``) for tiles of ``npix`` pixels: pixels per thread,
    threads a block, registers a thread, resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and shared bytes a
    block."""
    fn = getattr(ctypes.CDLL(str(library(name))), f"{name}_info")
    fn.argtypes = [_I, _I, _I, _P]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(INFO_KEYS))()
    err = fn(npix, k_chunk, variant, out)
    if err != 0:
        raise RuntimeError(f"{name}_info failed: CUDA error {err}")
    return dict(zip(INFO_KEYS, out))


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on CUDA, False when every one is on the
    CPU; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on unsupported devices {sorted(kinds)}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple) -> None:
    if t.dtype != dtype or t.shape != shape or not t.is_contiguous():
        layout = "" if t.is_contiguous() else "non-contiguous "
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)}, "
                         f"got {layout}{t.dtype} {tuple(t.shape)}")


def current_stream() -> int:
    """The raw handle of the current CUDA device's current stream, read
    without building a ``torch.cuda.Stream`` (-1: the current device)."""
    return torch._C._cuda_getCurrentRawStream(-1)


def launch(name: str, *args, key: Optional[str] = None,
           src: Path = CSRC) -> None:
    """Run ``<name>_launch`` (built from ``src``) on the current stream
    with ``args``, pointers as ints; a nonzero CUDA error raises.  The
    launch counts as ``key`` (``name`` by default)."""
    stream = current_stream()
    err = launcher(name, src)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    with _count_lock:
        _redirect.get(stream, launches)[key or name] += 1


@contextlib.contextmanager
def launches_on(stream: torch.cuda.Stream, into: dict):
    """Count the launches made on ``stream`` in ``into`` (keyed as
    ``launches``) instead of ``launches`` while the block runs.  Keyed by
    the stream, not the thread: autograd launches K3 from its own thread,
    on the stream of the forward, and a viewer's renders on another thread
    and stream keep counting in ``launches``."""
    with _count_lock:
        _redirect[stream.cuda_stream] = into
    try:
        yield into
    finally:
        with _count_lock:
            del _redirect[stream.cuda_stream]


def add_launches(counts: dict) -> None:
    """Add ``counts`` to ``launches``: a replayed CUDA graph launches its
    kernels without running the wrappers."""
    with _count_lock:
        for k, n in counts.items():
            launches[k] += n


def compile_smoke_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def compile_smoke(x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: ``x·2`` through a trivial kernel, so that a broken toolchain or
    card fails here, before any real work.  ``x`` defaults to ones of shape
    (8, 128) on the card; a CPU tensor takes the plain version."""
    if x is None:
        x = torch.ones((8, 128), dtype=torch.float32, device="cuda")
    if not on_cuda(x):
        return compile_smoke_plain(x)
    check_tensor(x, "x", torch.float32, tuple(x.shape))
    out = torch.empty_like(x)
    launch("compile_smoke", x.data_ptr(), out.data_ptr(), x.numel())
    return out
