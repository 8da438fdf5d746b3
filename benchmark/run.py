"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its per-layer metrics are
found by name from ``BENCHMARK.json`` (see ``benchmark/harness/spec.py``).
The run makes its weights and inputs on the card from the seed, builds
and warms up what the cell uses (set-up), calls the program for the
window, then judges the program's answers against the plain reference and
prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` the device's ``busy_s`` and ``window_s`` and a
``breakdown``, and last the ``checks``: each compared number beside its
limit (also the last lines of standard error).

It needs a CUDA card: without one, or with fewer than the cell asks for,
it exits 3 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse                                            # noqa: E402
import json                                                # noqa: E402
import os                                                  # noqa: E402
import subprocess                                          # noqa: E402
import sys                                                 # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every build and kernel cache at a fixed place inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)

import torch                                               # noqa: E402

#: top-level module names that the run's process must never hold
BANNED = ("jax", "jaxlib", "flax", "sloika_tpu")


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run(workload, seed, seconds, trace, device=None, t_start=T_START,
        root=ROOT):
    """Run one cell once; returns the result line's object.  ``device``
    None asks for the card and its count as the cell says."""
    from benchmark.harness import compare, spec
    from benchmark.harness import trace as tr
    from benchmark.harness.driver import sync

    cell = spec.Cell(workload, root=root)
    chips = cell.workload["chips"]
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise SystemExit("no CUDA card, or fewer than the {} this "
                             "cell asks for".format(chips))
        device = torch.device("cuda", 0)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    spans = tr.Spans(bool(trace))
    driver = cell.driver.Driver(cell, seed, device, spans)
    driver.build()
    with spans("setup"):
        driver.setup()
    sync(device)
    if trace:
        seconds = min(seconds, cell.traffic.get("trace_seconds", seconds))
        prof = tr.profiler()
        prof.start()
    t0 = time.perf_counter()
    with spans(tr.WINDOW):
        work, attempted, failed = driver.run_window(seconds)
        sync(device)
    t1 = time.perf_counter()
    window_s = t1 - t0
    if trace:
        prof.stop()
    banned = banned_modules()
    if banned:
        raise SystemExit("the run loaded {}".format(", ".join(banned)))
    on_card = device.type == "cuda"
    result_device = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": chips,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if on_card else 0),
        "power_limit_w": power_limit() if on_card else None}
    from benchmark.harness import port
    print("counters " + json.dumps(port.counters()), flush=True)
    metrics, breakdown = {}, None
    if trace:
        t = tr.Trace(prof, spans, window_s)
        del prof
        ctx = Context(cell, driver, t)
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device.update(busy_s=t.busy_s, window_s=window_s)
        breakdown = {"device_ops": t.device_ops(),
                     "idle_gaps": t.idle_gaps()}
    else:
        values = {"setup_s": t0 - t_start, driver.rate_metric:
                  work / window_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    print("window {:.6f} s, {} work units, setup {:.6f} s ({})".format(
        window_s, work, t0 - t_start, ", ".join(
            "{} {:.3f} s".format(k, v) for k, v in spans.seconds.items()
            if k != tr.WINDOW)), file=sys.stderr, flush=True)
    notes = driver.notes()
    if notes:
        print(notes, file=sys.stderr, flush=True)
    driver.release()
    if on_card:
        torch.cuda.empty_cache()
    correct, checks = compare.judge(driver.check())
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for name, c in checks.items():
        print("check {} {!r} limit {!r}".format(name, c["value"],
                                                 c["limit"]),
              file=sys.stderr, flush=True)
    return out


class Context:
    """What a per-layer metric's reader reads: the cell, the trace, and
    the window's work counted from the traffic."""

    def __init__(self, cell, driver, trace):
        from benchmark.harness import roofline
        self.cell, self.trace, self.work = cell, trace, driver.work
        self.layers = cell.config["layers"]
        self.window_s = trace.window_s
        self.flops_per_sample = roofline.flops_per_sample(self.layers)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run(args.workload, args.seed, args.seconds, args.trace)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
