"""Readings that a cell's limits are set from, not part of a benchmark run.

    python benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--control 1,2,3] [--faults half_batch:1,2,3] [--out file.jsonl]

For each seed the cell is set up as a run sets it up, its program runs
one unit (no measured window) and the numbers its answers give against
the float32 reference are printed (``program``).  ``--control`` seeds
also print the numbers of the reference computed in TF32 put in the
program's place (``control``); ``--faults NAME:seeds`` those of the
program with a planted fault (``benchmark/harness/faults.py``).  One JSON
line a reading.  Needs a CUDA card, unless ``--device cpu``.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch                                               # noqa: E402


def _ints(text):
    return [int(s) for s in text.split(",") if s]


def reading(cell, seed, device, control=False, fault=None, root=ROOT):
    from benchmark.harness import faults, spec
    from benchmark.harness import trace as tr
    c = spec.Cell(cell, root=root)
    t0 = time.perf_counter()
    driver = c.driver.Driver(c, seed, device, tr.Spans(False))
    out = {"workload": cell, "seed": seed}
    driver.build()
    if fault:
        with faults.FAULTS[fault]():
            driver.setup()
            driver.run_window(0.0)
        out["fault"] = fault
    else:
        driver.setup()
        driver.run_window(0.0)
    out["setup_and_unit_s"] = time.perf_counter() - t0
    out["notes"] = driver.notes()
    driver.release()
    t1 = time.perf_counter()
    out["program"] = {n: v for n, v, _ in driver.check()}
    out["reference_s"] = time.perf_counter() - t1
    if control:
        out["control"] = {n: v for n, v, _ in driver.control()}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control", type=_ints, default=[])
    ap.add_argument("--faults", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    jobs = [(s, s in args.control, None) for s in args.seeds]
    jobs += [(s, True, None) for s in args.control if s not in args.seeds]
    for f in args.faults:
        name, seeds = f.split(":")
        jobs += [(s, False, name) for s in _ints(seeds)]
    sink = open(args.out, "a") if args.out else None
    for seed, control, fault in jobs:
        line = json.dumps(reading(args.workload, seed, device, control,
                                  fault))
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
