"""Whole runs of the harness on the CPU at tiny sizes: each cell comes out
correct, each planted fault comes out not correct, a machine without a
card gets no result, and the harness and the reference load neither JAX
nor the JAX package."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import faults

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["basecall_chunked.sloika_pretrained", "train.raw_0.98_rgrgr",
         "basecall_whole.sloika_pretrained"]
#: the faults each cell can have
FAULTS = [("basecall_chunked.sloika_pretrained", "answer_altered"),
          ("basecall_chunked.sloika_pretrained", "tail_batch_altered"),
          ("basecall_whole.sloika_pretrained", "answer_altered"),
          ("train.raw_0.98_rgrgr", "state_unchanged"),
          ("train.raw_0.98_rgrgr", "half_batch")]


def _run(tiny, cell, seed=2 ** 31 + 11, trace=0):
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        import run as bench_run
    finally:
        sys.path.pop(0)
    return bench_run.run(cell, seed, 0.2, trace, device=torch.device("cpu"),
                         t_start=time.perf_counter(), root=tiny)


@pytest.mark.parametrize("cell", CELLS)
def test_benchmark_cell_runs_correct_on_the_cpu(tiny, cell):
    out = _run(tiny, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("cell", CELLS[:2])
def test_benchmark_traced_run_reads_the_trace(tiny, cell):
    out = _run(tiny, cell, trace=1)
    assert out["correct"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(m.startswith(("idle_pct", "mfu"))
               for m in out["metrics"])       # no kernels on the CPU


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_benchmark_planted_fault_comes_out_not_correct(tiny, cell, fault):
    with faults.FAULTS[fault]():
        out = _run(tiny, cell)
    assert not out["correct"], out["checks"]


def test_benchmark_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "sloika_tpu"}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
"""


def _python(code):
    return subprocess.run([sys.executable, "-c", BLOCK % ROOT + code],
                          capture_output=True, text=True, timeout=300)


def test_benchmark_harness_imports_without_jax():
    proc = _python("""
import benchmark.harness.spec, benchmark.harness.trace
import benchmark.harness.roofline, benchmark.harness.compare
import benchmark.harness.generators, benchmark.harness.basecall
import benchmark.harness.faults, benchmark.harness.port
from benchmark.harness import spec
for cell in [w["name"] for w in spec.benchmark()["workloads"]]:
    spec.Cell(cell)
import sloika_tpu_torch.basecall, sloika_tpu_torch.training
import sloika_tpu_torch.remap
print("ok")
""")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_benchmark_reference_imports_nothing_of_the_program():
    proc = _python("""
import json
import benchmark.reference.model, benchmark.reference.viterbi
import benchmark.reference.train, benchmark.reference.steps
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")
    assert proc.returncode == 0, proc.stderr
    mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "sloika_tpu_torch" not in mods


@pytest.mark.parametrize("cell", CELLS)
def test_benchmark_control_comes_out_not_correct(tiny, cell):
    """The reference computed in TF32 (its rounding, off the card) put in
    the program's place fails one of the cell's limits."""
    from benchmark.harness import compare, spec
    from benchmark.harness import trace as tr
    c = spec.Cell(cell, root=tiny)
    driver = c.driver.Driver(c, 2 ** 31 + 13, torch.device("cpu"),
                             tr.Spans(False))
    driver.setup()
    driver.run_window(0.0)
    correct, checks = compare.judge(driver.control())
    assert not correct, checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_benchmark_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        import run as bench_run
    finally:
        sys.path.pop(0)
    out = bench_run.run(cell, 2 ** 31 + 17, 2.0, 0)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
