"""The four-rank training cell on the CPU, over four gloo ranks at a tiny
size, each run in a process of its own under a time limit: it comes out
correct, the TF32 control and each planted fault come out not correct, and
a rank that dies, or that holds a banned module once its window has
closed, ends the run non-zero with no result instead of hanging it.  Also the
collectives' reader on a hand-built trace.

The cell is not in ``BENCHMARK.json``: on four H100s its rate spread too
widely for the bound it would share (PERF.md §7).  The tests add it to a
copy of the tree by the entries that would add it there."""
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "train_nccl4.raw_0.98_rgrgr"
#: the cell's entries in BENCHMARK.json: its workload, the metrics that
#: list it, and its own per-layer metric
WORKLOAD = {"name": CELL, "config": "raw_0.98_rgrgr",
            "traffic": "train_nccl4", "chips": 4,
            "why": "4 ranks, one H100 each, global B 400 of 2,000-sample "
                   "chunks, 10 steps a CUDA graph: the NCCL gradient "
                   "all-reduce in the graph, GRU kernels, ADAMski"}
LISTED_IN = ("train_chunks_per_s", "idle_pct.train", "mfu.train",
             "gru_roofline.train", "idle_host_pct.train")
ALLREDUCE = {"name": "allreduce_pct.train", "unit": "%", "better": "lower",
             "source": "device_trace", "layer": "collectives",
             "moves": "train_chunks_per_s", "workloads": [CELL]}
#: seconds a run may take here before the test fails it
LIMIT_S = 240

RUN = '''
import contextlib, json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {root!r} + "/benchmark")
import torch
torch.set_num_threads(2)
import run as bench_run
from benchmark.harness import compare, faults, ranks, spec
from benchmark.harness import trace as tr
{setup}
with (faults.FAULTS[{fault!r}]() if {fault!r} else contextlib.nullcontext()):
    if {control!r}:
        c = spec.Cell({cell!r}, root={tiny!r})
        d = c.driver.Driver(c, 2 ** 31 + 13, torch.device("cpu"),
                            tr.Spans(False))
        d.setup()
        d.run_window(0.0)
        d.release()
        ok, checks = compare.judge(d.control())
        out = {{"correct": ok, "checks": checks}}
    else:
        out = bench_run.run({cell!r}, 2 ** 31 + 11, 0.2, {trace!r},
                            device=torch.device("cpu"),
                            t_start=time.perf_counter(), root={tiny!r})
print(json.dumps(out))
'''

#: rank 0 kills rank 2 once the ranks have started
KILL = '''
import threading
start = ranks.Group.__init__
def killing(self, *args, **kwargs):
    start(self, *args, **kwargs)
    threading.Timer(1.0, self.ctx.processes[1].kill).start()
ranks.Group.__init__ = killing
'''

#: a site hook that plants a banned module in each process that
#: multiprocessing spawns (ranks 1-3), not in rank 0's
PLANT = '''import sys, types
if "--multiprocessing-fork" in sys.argv:
    sys.modules["jaxlib"] = types.ModuleType("jaxlib")
'''


@pytest.fixture(scope="module")
def tree(tiny, tmp_path_factory):
    """The tiny tree with the cell's entries in its BENCHMARK.json."""
    dest = tmp_path_factory.mktemp("nccl4")
    shutil.copytree(tiny, dest, dirs_exist_ok=True)
    path = dest / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["workloads"].append(WORKLOAD)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in LISTED_IN:
            m["workloads"].append(CELL)
    bench["per_layer"].append(ALLREDUCE)
    path.write_text(json.dumps(bench))
    return str(dest)


def test_benchmark_collectives_cell_parts_are_found_by_name(tree):
    from benchmark.harness import spec
    c = spec.Cell(CELL, root=tree)
    assert c.workload["chips"] == 4 and c.traffic["ranks"] == 4
    assert {m["name"] for m in c.end_to_end} == {"train_chunks_per_s",
                                                 "setup_s"}
    assert set(c.readers) == set(LISTED_IN[1:]) | {"allreduce_pct.train"}


def _run(tiny, fault=None, trace=0, control=False, setup="", env=None):
    code = RUN.format(root=ROOT, tiny=tiny, cell=CELL, fault=fault,
                      trace=trace, control=control, setup=setup)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=LIMIT_S, cwd=tiny, env=env)


def _result(proc):
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_benchmark_collectives_cell_runs_correct_on_the_cpu(tree):
    out = _result(_run(tree))
    assert out["correct"], out["checks"]
    assert out["checks"]["replica_gap"] == {"value": 0.0, "limit": 0.0}
    assert out["device"]["count"] == 4
    assert out["failed"] == 0 and out["attempted"] >= 6
    assert set(out["metrics"]) == {"train_chunks_per_s", "setup_s"}


def test_benchmark_collectives_traced_run_on_the_cpu(tree):
    out = _result(_run(tree, trace=1))
    assert out["correct"], out["checks"]
    # no kernels and no NCCL on the CPU
    assert set(out["metrics"]) <= {"idle_pct.train", "mfu.train",
                                   "idle_host_pct.train"}
    assert "allreduce_pct.train" not in out["metrics"]


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged",
                                   "exchange_skipped", "rank_unaveraged"])
def test_benchmark_collectives_planted_fault_comes_out_not_correct(tree,
                                                                   fault):
    out = _result(_run(tree, fault=fault))
    assert not out["correct"], out["checks"]


def test_benchmark_collectives_control_comes_out_not_correct(tree):
    out = _result(_run(tree, control=True))
    assert not out["correct"], out["checks"]


def test_benchmark_collectives_a_dead_rank_ends_the_run(tree):
    proc = _run(tree, setup=KILL)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "rank 2" in proc.stderr


def test_benchmark_collectives_a_rank_holding_jax_ends_the_run(tree,
                                                               tmp_path):
    (tmp_path / "sitecustomize.py").write_text(PLANT)
    path = [str(tmp_path)] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p]
    proc = _run(tree, env=dict(os.environ, PYTHONPATH=os.pathsep.join(path)))
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
    assert "rank 3: the run loaded jaxlib" in proc.stderr


def _reader():
    import importlib.util
    path = os.path.join(ROOT, "benchmark", "metrics",
                        "allreduce_pct.train.py")
    s = importlib.util.spec_from_file_location("allreduce_reader", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_benchmark_collectives_reader_takes_the_union_in_the_window():
    # window [100, 1100] us; NCCL over [50, 150], [140, 300] (overlapping),
    # [900, 1200] (past the end): 200 + 200 us of 1,000
    t = SimpleNamespace(window=(100.0, 1100.0), window_s=0.001, device=[
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 50.0, 150.0),
        ("ncclKernel_AllReduce", 140.0, 300.0),
        ("gru_fwd_kernel", 300.0, 900.0),
        ("NCCLDevKernel", 900.0, 1200.0)])
    assert _reader().read(SimpleNamespace(trace=t)) == pytest.approx(40.0)
    t.device = t.device[2:3]
    assert _reader().read(SimpleNamespace(trace=t)) is None
