"""Build and load the CUDA kernels under ``touchgs_torch/csrc/``.

Each ``<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C launcher (``<name>_launch``), loaded with ``ctypes``.
Builds happen at first use, one ``nvcc`` process per source, all started
together, into ``csrc/build/<hash of the sources and flags>/``, so a changed
source rebuilds and an unchanged one is reused.  Nothing is built on import.

Beside the build: the helpers every kernel wrapper uses (device dispatch,
argument checks, pointers, the launch itself), and ``compile_smoke``, the
build-and-launch check (port of ``bench.py::pallas_compile_smoke``).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"
KERNELS = ("slot_lists", "composite_fwd", "composite_bwd", "compile_smoke",
           "anatomy_variants", "bf16_probe")
# No fast-math flag: exp2f and the divides stay IEEE-accurate.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-source extra flags: the backward rounds every operation on its own,
# as its plain version does (see composite_bwd.cu)
EXTRA_FLAGS = {"composite_bwd": ("-fmad=false",)}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# launcher argument types: pointers and the stream as c_void_p
SIGNATURES = {
    "slot_lists": [_P, _P, _P, _P, _I, _I, _I, _P],
    "composite_fwd": [_P, _P, _P, _P] + [_I] * 6 + [_F, _F, _I, _P],
    "composite_bwd": [_P] * 6 + [_I] * 6 + [_F, _F, _P],
    "compile_smoke": [_P, _P, _I, _P],
    # n_chunks, tile_ids, attrs, out, scratch; mode, n_tiles, th, tw,
    # k_tile, k_chunk, n_tx; alpha_clip, alpha_thr; stream
    "anatomy_variants": [_P] * 5 + [_I] * 7 + [_F, _F, _P],
    # attrs, out; bf16 (0/1), n_tiles; stream
    "bf16_probe": [_P, _P, _I, _I, _P],
}
# launches of compile_smoke (the other wrappers count their own)
launches = {"compile_smoke": 0}

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


def sass_loop_counts(name: str, src: Path = CSRC) -> dict:
    """{kernel function: Counter of the SASS opcodes of its innermost loop
    that holds every MUFU.EX2 (the compositing kernels' entry loop, one
    exp2 a pair)}: the body from a backward branch's target to the branch.
    Functions without such a loop are left out."""
    loops = {}
    for fn, ins in sass(name, src).items():
        marks = [a for a, op, _ in ins if op == "MUFU.EX2"]
        spans = []
        for addr, op, rest in ins:
            m = re.search(r"0x([0-9a-f]+)", rest)
            if not (marks and op.startswith("BRA") and m):
                continue
            target = int(m.group(1), 16)
            if target <= min(marks) and addr >= max(marks):
                spans.append((addr - target, target, addr))
        if spans:
            _, lo, hi = min(spans)
            loops[fn] = collections.Counter(op for a, op, _ in ins
                                            if lo <= a <= hi)
    return loops


def launcher(name: str, src: Path = CSRC):
    """The ``<name>_launch`` C function, building the libraries if needed;
    ``src`` other than the package's sources builds and loads those."""
    fn = _launchers.get((name, src))
    if fn is None:
        lib = ctypes.CDLL(str(library(name, src)))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _launchers[(name, src)] = fn
    return fn


INFO_KEYS = ("pixels_per_thread", "threads", "registers", "blocks_per_sm",
             "shared_bytes")


def kernel_info(name: str, npix: int, k_chunk: int, variant: int = 0) -> dict:
    """Launch shape of a compositing kernel (``composite_fwd`` with
    ``variant`` its early_exit flag, or ``composite_bwd``) for tiles of
    ``npix`` pixels: pixels per thread, threads a block, registers a thread,
    resident blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
    and shared bytes a block."""
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
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def call(name: str, *args, src: Path = CSRC) -> None:
    """Run ``<name>_launch`` (built from ``src``); a nonzero CUDA error
    raises."""
    err = launcher(name, src)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


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
    call("compile_smoke", ptr(x), ptr(out), x.numel(), stream(out))
    launches["compile_smoke"] += 1
    return out
