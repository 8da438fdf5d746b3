"""The readers of the host layer (``benchmark/harness/program_spans.py``
and the four ``metrics/*host*``/``*bytes*`` readers): the clock alignment
and the idle attribution on a hand-built trace with worked numbers, no
reading from a program without the tracer or a trace without a card, and
a traced run of each cell on the CPU, its tensor ops standing in for the
card's work, whose copy bytes equal the count from the traffic's shapes."""
import importlib.util
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import generators, program_spans, spec
from benchmark.harness import trace as tr

ROOT = spec.ROOT
THETA = 1_792_000_000_000_000_000     # the program's clock, ns, at trace 0
MAIN, WORKER = 11, 12


def _ns(us):
    return THETA + int(round(us * 1e3))


def _worked():
    """A window of 3,500 us with two calls of ``basecall.dac``: the device
    busy over [100, 300], [450, 950] and [2000, 3000]; the first call's
    pack, launch and unpack; a stale call from before the window and a
    worker-thread span that the attribution must leave out."""
    trace = SimpleNamespace(
        spans=[("bench.window", 0.0, 3500.0), ("basecall", 100.0, 1100.0),
               ("basecall", 2000.0, 3000.0)],
        device=[("k", 100.0, 300.0), ("k", 450.0, 950.0),
                ("k", 2000.0, 3000.0)],
        busy_intervals=[[100.0, 300.0], [450.0, 950.0], [2000.0, 3000.0]],
        window=(0.0, 3500.0), window_s=0.0035)
    spans = [
        ("basecall.dac", None, MAIN, _ns(-900), _ns(-500)),     # stale
        ("basecall.dac", None, MAIN, _ns(100), _ns(1097)),      # -3 at the end
        ("basecall.pack", 1, MAIN, _ns(200), _ns(400)),
        ("basecall.launch", 1, MAIN, _ns(400), _ns(500)),
        ("basecall.unpack", 1, MAIN, _ns(900), _ns(1000)),
        ("train.sample", 1, WORKER, _ns(950), _ns(2000)),
        ("basecall.dac", None, MAIN, _ns(2008), _ns(2998))]     # +8, -2
    return trace, spans


def test_alignment_worked_numbers():
    trace, spans = _worked()
    al = program_spans.align(trace, spans)
    assert al.offset_us == pytest.approx(THETA / 1e3, abs=0.5)
    assert al.us(_ns(1234)) == pytest.approx(1234.0, abs=1e-6)
    assert al.residual_us == pytest.approx(8.0, abs=1e-6)  # starts +0, +8
    assert al.bracket_us == pytest.approx(2.0, abs=1e-6)   # ends -3, -2
    assert al.calls == [1, 6] and al.tid == MAIN


def test_idle_attribution_worked_numbers():
    """Idle [0, 100], [300, 450], [950, 2000], [3000, 3500] (1,800 us):
    100 in pack and 50 in launch ([300, 450]), 50 in unpack and 97 in the
    entry itself ([950, 1097]), the rest (1,503) outside any program span,
    the worker's span left out."""
    trace, spans = _worked()
    by, _ = program_spans.idle_by_span(trace, spans)
    want = {None: 1503.0, "basecall.pack": 100.0, "basecall.launch": 50.0,
            "basecall.unpack": 50.0, "basecall.dac": 97.0}
    assert set(by) == set(want)
    for k, v in want.items():
        assert by[k] == pytest.approx(v, abs=1e-6), k
    ctx = SimpleNamespace(trace=trace, work={"samples": 1000.0})
    recorded = (spans, {"h2d_bytes": 2004, "d2h_bytes": 116})
    readers = _readers()
    orig = program_spans.recorded
    program_spans.recorded = lambda: recorded
    try:
        got = {n: r.read(ctx) for n, r in readers.items()}
    finally:
        program_spans.recorded = orig
    assert got["idle_host_pct.basecall"] == pytest.approx(
        100.0 * 150.0 / 3500.0)
    assert got["h2d_bytes_per_sample.basecall"] == pytest.approx(2.004)
    assert got["d2h_bytes_per_sample.basecall"] == pytest.approx(0.116)
    assert got["idle_host_pct.train"] == 0.0      # no train span open


def test_outermost_drops_the_programs_own_span_of_the_harness_name():
    trace = SimpleNamespace(spans=[("train", 100.0, 5000.0),
                                   ("train", 110.0, 4990.0)])
    spans = [("train", None, MAIN, _ns(112), _ns(4989))]
    al = program_spans.align(trace, spans)
    assert al.us(_ns(112)) == pytest.approx(100.0, abs=1e-6)
    assert al.residual_us == 0.0
    assert al.bracket_us == pytest.approx(12.0 + 11.0, abs=1e-6)


def _readers():
    out = {}
    for name in ("idle_host_pct.basecall", "idle_host_pct.train",
                 "h2d_bytes_per_sample.basecall",
                 "d2h_bytes_per_sample.basecall"):
        s = importlib.util.spec_from_file_location(
            "m_" + name.replace(".", "_"),
            os.path.join(ROOT, "benchmark", "metrics", name + ".py"))
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        out[name] = mod
    return out


def test_no_reading_without_the_tracer_or_a_card(monkeypatch):
    """A program without ``tracing`` (the parent of the change that adds
    it) and a trace with no device work give None, and raise nothing."""
    trace, spans = _worked()
    ctx = SimpleNamespace(trace=trace, work={"samples": 1000.0})
    monkeypatch.setitem(sys.modules, "sloika_tpu_torch.tracing", None)
    assert program_spans.recorded() is None
    assert all(r.read(ctx) is None for r in _readers().values())
    monkeypatch.undo()
    trace.device, trace.busy_intervals = [], []
    assert all(r.read(ctx) is None for r in _readers().values())


class CpuAsCard(tr.Trace):
    """A trace in which the CPU's tensor ops stand in for the card."""

    def __init__(self, prof, spans, window_s):
        super().__init__(prof, spans, window_s)
        self.device = [(e.name, e.time_range.start, e.time_range.end)
                       for e in prof.events() if e.name.startswith("aten::")]
        lo, hi = self.window
        self.busy_intervals = [[max(s, lo), min(e, hi)] for s, e in
                               tr._union([(s, e) for _, s, e in self.device])
                               if e > lo and s < hi]
        self.busy_s = sum(e - s for s, e in self.busy_intervals) / 1e6


def _frames(n):
    return 1 + (n - 1) // 5                  # winlen 11, stride 5, 'same'


def _hand_bytes(cell, traffic, seed):
    """(h2d, d2h) bytes a read sample of a call, from the traffic's read
    lengths and the outputs' dtypes (one group of 2^24 samples at most)."""
    lens = generators.read_lengths(traffic, seed)
    if cell.startswith("basecall_chunked"):
        C, V = traffic["chunk_size"], traffic["overlap"]
        core = C - 2 * V
        nwin = sum(max(1, -(-max(int(L) - 2 * V, 1) // core)) for L in lens)
        h2d = 2 * (lens.sum() + C) + 32 * nwin
        d2h = nwin * (4 + 2 + 12 + -(-2 * _frames(C) // 4))
    else:
        lens, B = np.sort(lens), traffic["batch_size"]
        h2d = d2h = 0
        for lo in range(0, len(lens), B):
            b = lens[lo:lo + B]
            h2d += 4 * int(b.max()) * len(b) + 8 * len(b)
            d2h += len(b) * (4 + 8 + 5 * _frames(int(b.max())))
    return h2d / lens.sum(), d2h / lens.sum()


@pytest.mark.parametrize("cell", ["basecall_chunked.sloika_pretrained",
                                  "basecall_whole.sloika_pretrained",
                                  "train.raw_0.98_rgrgr"])
def test_traced_cpu_run_reads_the_host_metrics(tiny, cell, monkeypatch):
    from sloika_tpu_torch import tracing
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        import run as bench_run
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(tr, "Trace", CpuAsCard)
    tracing.reset()
    seed = 2 ** 31 + 29
    out = bench_run.run(cell, seed, 0.2, 1, device=torch.device("cpu"),
                        t_start=time.perf_counter(), root=tiny)
    tracing.reset()
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"]
    kind = cell.split(".")[0].split("_")[0]
    assert 0.0 < m["idle_host_pct." + kind] <= m["idle_pct." + kind]
    if kind == "basecall":
        h2d, d2h = _hand_bytes(cell, spec.Cell(cell, root=tiny).traffic,
                               seed)
        assert m["h2d_bytes_per_sample.basecall"] == pytest.approx(h2d)
        assert m["d2h_bytes_per_sample.basecall"] == pytest.approx(d2h)
