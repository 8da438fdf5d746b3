"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, each configuration's file, each traffic mix's file
(``benchmark/traffic/<traffic>.json``), each per-layer metric's reader
(``benchmark/metrics/<metric>.py``) and each traffic driver
(``benchmark/harness/drivers/<driver>.py``).  Adding a cell, a mix, a
configuration or a metric adds files and entries; no file here changes."""
import importlib.util
import json
import os

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError("no {} named {!r}".format(what, name))


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name, root=ROOT, bench_dir=None):
        bench_dir = bench_dir or os.path.join(root, "benchmark")
        self.bench = benchmark(root)
        self.workload = _by_name(self.bench["workloads"], name, "workload")
        self.name = name
        cfg_entry = _by_name(self.bench["configs"], self.workload["config"],
                             "config")
        self.config = load_json(os.path.join(root, cfg_entry["file"]))
        self.traffic = load_json(os.path.join(
            bench_dir, "traffic", self.workload["traffic"] + ".json"))
        self.driver = _load_module(
            os.path.join(bench_dir, "harness", "drivers",
                         self.traffic["driver"] + ".py"),
            "bench_driver_" + self.traffic["driver"])
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if self._applies(m)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.bench["per_layer"]
                          if self._applies(m) and m["moves"] in e2e]
        self.readers = {
            m["name"]: _load_module(
                os.path.join(bench_dir, "metrics", m["name"] + ".py"),
                "bench_metric_" + m["name"].replace(".", "_"))
            for m in self.per_layer}

    def _applies(self, metric):
        return self.name in metric.get("workloads", [self.name])


def sub_seed(seed, tag):
    """A 32-bit seed for stream ``tag`` of a run seed of any size."""
    return int(np.random.SeedSequence([int(seed), int(tag)])
               .generate_state(1)[0])
