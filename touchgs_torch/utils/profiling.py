"""Profiling and per-kernel roofline accounting on the card (port of
``touchgs_tpu/utils/profiling.py``).

- ``ChipSpec``, ``StageCost``, ``composite_cost``, ``binning_cost`` and
  ``report``: the analytic operation/byte models of the rasterization
  stages, with the same fields, formulas and ``unit`` values as the JAX
  package, so a ``StageCost`` reads the same in both.  ``unit="mxu"`` is
  priced at ``peak_flops_f32`` and ``unit="vpu"`` (elementwise work) at
  ``peak_flops_vpu``; on the H100 both are the fp32 rate outside the tensor
  cores, because the port's K=8 contractions are fp32 FMAs, never TF32.
- ``measure(fn, *args)``: mean seconds per call on the card, from CUDA
  events.  It raises without a card or on a CPU tensor; it never times on
  the host clock.  ``timed_row`` prints an experiment tool's row from it.
"""
from __future__ import annotations

import dataclasses
import math
import subprocess
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_f32: float    # matrix work in fp32 (no TF32)
    peak_flops_bf16: float   # bf16 on the tensor cores
    peak_flops_vpu: float    # fp32 elementwise: the datasheet peak
    # measured sustained fp32 rate of the compositing op mix: the bare α
    # chain of K5's alpha_only variant (tools/exp_kernel_anatomy.py)
    vpu_sustained: float
    hbm_bw: float            # bytes/s


# NVIDIA H100 SXM, published peaks at 700 W: 67 TFLOP/s fp32 outside the
# tensor cores, 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3.  vpu_sustained is
# what K5's alpha_only sustains on an NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit (SM clock 1980 MHz): 21 ops per (entry, pixel), counted from
# csrc/anatomy_variants.cu, × 319,872 entries × 1024 pixels in 0.3198 ms,
# from python -m touchgs_torch.tools.exp_kernel_anatomy (PERF.md, section 6).
H100 = ChipSpec(name="h100", peak_flops_f32=67e12, peak_flops_bf16=989e12,
                peak_flops_vpu=67e12, vpu_sustained=21.5e12, hbm_bw=3.35e12)


@dataclasses.dataclass
class StageCost:
    """Analytic cost of one pipeline stage."""

    name: str
    flops: float
    bytes_accessed: float
    unit: str = "mxu"   # which compute peak bounds this stage: mxu | vpu

    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_accessed, 1.0)

    def roofline_time(self, chip: ChipSpec) -> float:
        """Least seconds under the roofline model (datasheet peak)."""
        peak = (chip.peak_flops_vpu if self.unit == "vpu"
                else chip.peak_flops_f32)
        return max(self.flops / peak, self.bytes_accessed / chip.hbm_bw)

    def practical_time(self, chip: ChipSpec) -> float:
        """Least seconds against the measured sustained rate
        (``ChipSpec.vpu_sustained``)."""
        peak = (chip.vpu_sustained if self.unit == "vpu"
                else chip.peak_flops_f32)
        return max(self.flops / peak, self.bytes_accessed / chip.hbm_bw)


def composite_cost(scanned_pairs: float, tile_pixels: int, n_tiles: int,
                   name: str = "composite_fwd", flops_per_pair: int = 34,
                   attr_lanes: int = 16) -> StageCost:
    """Compositing kernel cost from the (entry, tile) pairs actually scanned
    (chunks_done × k_chunk per tile, from row 6 of the forward's output),
    not the k_tile capacity.  ``flops_per_pair`` is the operations per
    (entry, pixel): about 34 forward, 76 backward.  Memory traffic is the
    gathered attribute rows and the stacked tile outputs."""
    return StageCost(
        name=name,
        flops=float(scanned_pairs) * tile_pixels * flops_per_pair,
        bytes_accessed=float(scanned_pairs) * attr_lanes * 4
        + n_tiles * tile_pixels * 8 * 4,
        unit="vpu",
    )


def binning_cost(num_gaussians: int, tiles_per_gaussian_cap: int) -> StageCost:
    """Key build and sort of the (gaussian, tile) pairs, in the JAX
    package's model: log2(pairs) merge passes, each streaming the (key,
    value) pairs through memory once.  ``torch.sort`` on the card is a radix
    sort with fewer passes, so on the H100 this overstates the bytes; the
    formula is kept so that both packages price a stage alike."""
    pairs = num_gaussians * tiles_per_gaussian_cap
    passes = max(math.ceil(math.log2(max(pairs, 2))), 1)
    return StageCost(
        name="binning",
        flops=float(pairs) * 10,
        bytes_accessed=float(pairs) * 8 * (2 + passes),
    )


def _tensors(obj):
    """The tensors in ``obj`` and in its lists, tuples, dicts and
    dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def measure(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Mean seconds per call of ``fn(*args)`` on the card after ``warmup``
    calls: CUDA events around ``iters`` calls.  Raises on a CPU tensor
    among the arguments and when there is no card."""
    cpu = [t for t in _tensors(args) if t.device.type != "cuda"]
    if cpu:
        raise ValueError(f"measure times the card: an argument lies on "
                         f"{cpu[0].device}")
    if not torch.cuda.is_available():
        raise RuntimeError("measure needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def timed_row(rows: dict, name: str, fn: Callable, *args, iters: int = 20,
              width: int = 28) -> float | None:
    """Time ``fn(*args)`` on the card (``measure``) and print ``name`` with
    its ms, as the JAX experiment tools print their rows; a call that
    raises prints ``FAILED`` with the reason instead.  ``rows[name]`` gets
    the ms or the ``FAILED`` line; returns the ms, or None."""
    try:
        ms = measure(fn, *args, iters=iters) * 1e3
    except Exception as e:  # a failing row is a finding: print it, go on
        rows[name] = f"FAILED: {type(e).__name__}: {str(e)[:150]}"
        print(f"{name:<{width}} {rows[name]}", flush=True)
        return None
    rows[name] = ms
    print(f"{name:<{width}} {ms:9.4f} ms", flush=True)
    return ms


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def report(stages: list[StageCost], measured_s: dict[str, float],
           chip: ChipSpec = H100) -> str:
    """Human-readable roofline table."""
    lines = [
        f"roofline report — chip {chip.name} "
        f"(peak {chip.peak_flops_f32/1e12:.0f} Tf32, "
        f"{chip.hbm_bw/1e9:.0f} GB/s; VPU datasheet "
        f"{chip.peak_flops_vpu/1e12:.1f}T / sustained "
        f"{chip.vpu_sustained/1e12:.1f}T calibrated)",
        f"{'stage':<12} {'GFLOP':>8} {'MB':>8} {'AI':>6} "
        f"{'roof_ms':>8} {'meas_ms':>8} {'eff':>6} {'prac':>6}",
    ]
    for s in stages:
        roof = s.roofline_time(chip)
        prac = s.practical_time(chip)
        meas = measured_s.get(s.name)
        eff = f"{roof / meas:6.1%}" if meas else "   n/a"
        peff = f"{prac / meas:6.1%}" if meas else "   n/a"
        meas_ms = f"{meas*1e3:8.2f}" if meas else "     n/a"
        lines.append(
            f"{s.name:<12} {s.flops/1e9:8.2f} {s.bytes_accessed/1e6:8.1f} "
            f"{s.arithmetic_intensity():6.1f} {roof*1e3:8.2f} {meas_ms} {eff} "
            f"{peff}"
        )
    return "\n".join(lines)
