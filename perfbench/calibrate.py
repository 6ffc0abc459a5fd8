"""The readings that a cell's limits are set from, at the cell's own size on
the card: for each seed, the program's numbers against the reference (the
lower readings), the control (the reference in TF32 in the program's
place) and the reference with each planted fault (``check.FAULTS``,
``check.REFINE_FAULTS``), each against the float32 reference, and each
judged by ``check.judge`` under the cell's limits (``verdicts``: true where
it passes, which for a control or a fault has to read false).  A state left
unchanged reads 1 on ``change_gap`` by construction and needs no run.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 30] [--program-only]

One JSON line a seed on standard output.  The run drives the cell's window
(``--seconds``, as a run of the cell does), since a job's growth and the
step after it come there, and no profiler.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def sign_flips(g_prog: dict, g_ref: dict, live) -> dict:
    """Per group over the live rows: the share of gradient elements whose
    sign differs between the program and the reference, and the share of
    those under a millionth of the group's largest."""
    out = {}
    for k, r in g_ref.items():
        a, b = g_prog[k][live].double(), r[live].double()
        flip = (torch.sign(a) != torch.sign(b))
        tiny = b.abs() < 1e-6 * float(b.abs().max())
        out[k] = [float(flip.double().mean()),
                  float((flip & tiny).double().sum() / max(int(flip.sum()), 1))]
    return out


def grown_look(job, dev) -> dict:
    """The step after the growth: per group, the change's gap over the
    rows whose Adam moments are zero at its start (born or rewritten by
    the refine before it, so they move by their gradient's sign) and over
    the others, the counts of each, and the gradient's sign flips."""
    from perfbench import check
    from perfbench.reference import train as ref

    k = job.grown
    refr = check.grown_run(job, dev)
    start, out = k["in"], k["out"]
    live = start["params"]["alive"]
    nu = start["nu"]["means"].reshape(len(live), -1)
    fresh = live & (nu == 0).all(-1)
    groups = ref.GROUPS
    res = dict(rows=dict(fresh=int(fresh.sum()),
                         older=int((live & ~fresh).sum())))
    for name, rows in (("fresh", fresh), ("older", live & ~fresh)):
        c_run = {g: out["params"][g].double() - start["params"][g].double()
                 for g in groups}
        c_ref = {g: refr["params"][g].double() - start["params"][g].double()
                 for g in groups}
        res[name] = ref.leaf_gaps(ref.norms(c_run, groups, rows),
                                  ref.norms(c_ref, groups, rows), groups)
    g_prog = check.first_gradient(out["mu"], start["mu"],
                                  job.cfg["train"]["adam"]["b1"])
    res["signs"] = sign_flips(g_prog, refr["grad1"], live)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--program-only", action="store_true")
    args = ap.parse_args(argv)
    from perfbench import check, harness

    if not torch.cuda.is_available():
        print("calibrate reads the card's runs: no CUDA device",
              file=sys.stderr)
        return 1
    bench = harness.Bench(ROOT)
    w = bench.cell(args.workload)
    cfg, tr = bench.config(w["config"]), bench.traffic(w["traffic"])
    limits = bench.limits(args.workload)
    driver = bench.driver(tr["driver"])
    dev = torch.device("cuda")

    def verdict(values: dict) -> bool:
        return check.judge({k: v for k, v in values.items() if k in limits},
                           {k: lim for k, lim in limits.items()
                            if k in values})[0]

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        job = driver.setup(cfg, tr, seed, dev)
        job.window(args.seconds)
        job.free()
        prog = check.program_readings(job, dev)
        row = dict(seed=seed, program=prog,
                   verdicts=dict(program=check.judge(prog, limits)[0]))
        if not args.program_only:
            refr = check.reference_run(job, dev)
            start = check.start_state(job)
            row["signs"] = sign_flips(check.run_of_program(job)["grad1"],
                                      refr["grad1"], start["params"]["alive"])
            ctl = check.readings(check.reference_run(job, dev, tf32_on=True),
                                 refr, start)
            if job.refine:
                ctl.update(check.refine_readings(
                    check.reference_refine(job, dev, tf32_on=True),
                    check.reference_refine(job, dev)))
            if job.grown:
                ctl.update(check.against_grown(
                    job, check.grown_run(job, dev, tf32_on=True), dev))
            if job.grown:
                row["grown_look"] = grown_look(job, dev)
            row["control_tf32"] = ctl
            row["verdicts"]["control_tf32"] = verdict(ctl)
            for f in check.FAULTS:
                fr = check.readings(check.reference_run(job, dev, fault=f),
                                    refr, start)
                if job.grown:
                    fr.update(check.against_grown(
                        job, check.grown_run(job, dev, fault=f), dev))
                row[f"fault_{f}"] = fr
                row["verdicts"][f"fault_{f}"] = verdict(fr)
            for f in check.REFINE_FAULTS if job.refine else ():
                fr = check.refine_readings(
                    check.reference_refine(job, dev, fault=f),
                    check.reference_refine(job, dev))
                row[f"fault_{f}"] = fr
                row["verdicts"][f"fault_{f}"] = verdict(fr)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del job
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
