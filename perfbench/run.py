"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository, on a machine with the
cards the cell asks for.  The last line of standard output is the result
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with a
trace ``breakdown``, and last ``compared``: each number the check compared,
with its limit); standard error ends with the same numbers.  It exits 1,
and prints no result, without a card, in a directory without the program,
or when the process holds JAX or the JAX package after the window.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this directory, is where imports start: a
# module here must not shadow one of the standard library's
sys.path[0] = str(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "touchgs_tpu")


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own nvcc builds live in ``touchgs_torch/csrc/build``)."""
    cache = root / "perfbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "touchgs_torch").is_dir():
        print(f"no program (touchgs_torch/) beside {ROOT / 'perfbench'}",
              file=sys.stderr)
        return 1
    cache_dirs(ROOT)
    import torch

    from perfbench import harness

    chips = harness.Bench(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} wants {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 1
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"the process holds {bad} after the window", file=sys.stderr)
        return 1
    for k, v in result["compared"].items():
        print(f"{k} {v['value']:.6g} limit {v['limit']:.6g}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
