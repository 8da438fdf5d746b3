"""The program's tracer (``sloika_tpu_torch.tracing``) on the CPU routes of
the entries the benchmark drives: ``Basecaller.basecall_dac_reads``,
``Basecaller.basecall_signals`` and ``training.train``.

Off (no profiler) it records nothing and opens no ``record_function``
range; under a ``torch.profiler`` it records each entry's spans, nested
under the entry on the calling thread, the prefetch worker's under the
``train`` span on the worker's own thread, on the profiler's clock; its
copy counters hold the bytes of the tensors copied, counted by hand.
This file imports no jax.
"""
import threading
import time

import numpy as np
import pytest
import torch

from sloika_tpu_torch import basecall, models, tracing, training
from sloika_tpu_torch.variables import nstate

KLEN, C, V, STRIDE = 3, 200, 20, 5
#: a read's DAC samples and (offset, scale, med, mad)
LENGTHS = (300, 520, 150)


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def layer():
    return models.network_factory("raw_1_00_rGr")(
        klen=KLEN, sd=0.5, winlen=3, stride=STRIDE, sizes=(8, 8, 8, 8))


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def _reads():
    rs = np.random.RandomState(3)
    return [(rs.randint(1500, 2500, size=n).astype(np.int16),
             (10.0, 0.15, 300.0, 30.0)) for n in LENGTHS]


def _dac(layer, reads):
    caller = basecall.Basecaller(layer, KLEN, batch_size=2, chunk_size=C,
                                 overlap=V, output="bases", chunked=True,
                                 device="cpu")
    return caller.basecall_dac_reads(reads)


def _whole(layer, signals):
    caller = basecall.Basecaller(layer, KLEN, batch_size=2, device="cpu")
    return caller.basecall_signals(signals)


def _signals():
    rs = np.random.RandomState(4)
    return [rs.normal(size=n).astype(np.float32) for n in LENGTHS]


def _data(nchunk=12, chunk_len=100):
    rs = np.random.RandomState(0)
    labels = rs.randint(0, nstate(KLEN), size=(nchunk, chunk_len // STRIDE))
    return {"chunks": rs.normal(size=(nchunk, chunk_len, 1)).astype(
                np.float32),
            "labels": labels.astype(np.int32),
            "bad": np.zeros(labels.shape, bool),
            "weights": np.ones(nchunk) / nchunk, "attrs": {"kmer": KLEN}}


def _train(layer, niteration=6, K=2):
    return training.train(layer, _data(), batch_size=4,
                          chunk_len_range=(1.0, 1.0), drop=2,
                          niteration=niteration, steps_per_dispatch=K,
                          seed=1, quiet=True, device="cpu")


def _frames(n):
    return 1 + (n - 1) // STRIDE       # winlen 3, 'same' padded


def _windows(L):
    core = C - 2 * V
    return max(1, -(-max(L - 2 * V, 1) // core))


def test_off_records_nothing_and_opens_no_range(layer, monkeypatch):
    opened = []
    monkeypatch.setattr(tracing, "record_function",
                        lambda name: opened.append(name))
    assert not torch._C._autograd._profiler_enabled()
    _dac(layer, _reads())
    _whole(layer, _signals())
    _train(layer)
    with tracing.span("x"):
        tracing.count("h2d_bytes", 10)
    assert tracing.spans() == []
    assert opened == []
    counts = tracing.counters()
    assert "h2d_bytes" not in counts and "d2h_bytes" not in counts
    assert counts["GruForward.launches"] == \
        training.kernel_wrappers()[0].launches


def _children(spans, entry):
    """The entry span's index, and its children's names in order."""
    top = [i for i, s in enumerate(spans) if s[0] == entry]
    assert len(top) == 1 and spans[top[0]][1] is None
    return top[0], [s[0] for s in spans if s[1] == top[0]]


def test_dac_route_spans_nest_under_the_entry(layer):
    with _profiler():
        _dac(layer, _reads())
    spans = tracing.spans()
    i, names = _children(spans, "basecall.dac")
    nwin = sum(_windows(L) for L in LENGTHS)
    nbatch = -(-nwin // 2)
    # one group: its buffer, then each batch's arrays
    assert names == (["basecall.pack", "basecall.h2d"]
                     + ["basecall.pack", "basecall.h2d", "basecall.launch",
                        "basecall.collect", "basecall.unpack"] * nbatch
                     + ["basecall.stitch"])
    me = threading.get_ident()
    assert all(s[2] == me for s in spans)
    assert all(s[3] <= s[4] for s in spans)
    for s in spans[1:]:
        assert spans[i][3] <= s[3] and s[4] <= spans[i][4]


def test_whole_route_spans_nest_under_the_entry(layer):
    with _profiler():
        _whole(layer, _signals())
    _, names = _children(tracing.spans(), "basecall.signals")
    nbatch = -(-len(LENGTHS) // 2)
    assert names == ["basecall.pack", "basecall.h2d", "basecall.launch",
                     "basecall.collect", "basecall.collapse"] * nbatch


def test_train_spans_and_the_workers_thread(layer):
    with _profiler():
        _train(layer, niteration=6, K=2)
    spans = tracing.spans()
    i, names = _children(spans, "train")
    me = threading.get_ident()
    main = [n for n, s in zip(names, [s for s in spans if s[1] == i])
            if s[2] == me]
    worker = [s for s in spans if s[1] == i and s[2] != me]
    assert main == ["train.wait_group", "train.eager"] * 3 + [
        "train.log_sync"]
    # three groups sampled and copied on the prefetch worker
    assert [s[0] for s in worker] == ["train.sample", "train.h2d"] * 3
    assert len({s[2] for s in worker}) == 1
    own = tracing.self_ns()
    whole = spans[i][4] - spans[i][3]
    mains = sum(s[4] - s[3] for s in spans if s[1] == i and s[2] == me)
    assert own["train"] == whole - mains


def test_a_span_brackets_its_profiler_event(layer):
    """Each span's [t0_ns, t1_ns] holds its ``record_function`` event,
    taken as ``trace_start_ns() + time_range * 1000``, to within 1 ms."""
    with _profiler() as prof:
        with tracing.span("bracket"):
            time.sleep(0.003)
        _dac(layer, _reads())
    start = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(
            (start + e.time_range.start * 1000,
             start + e.time_range.end * 1000))
    spans = tracing.spans()
    assert {s[0] for s in spans} <= set(events)
    seen = {}
    for name, _, _, t0, t1 in spans:
        e0, e1 = sorted(events[name])[seen.setdefault(name, 0)]
        seen[name] += 1
        assert t0 - 1e6 <= e0 and e1 <= t1 + 1e6
        assert abs(e0 - t0) < 1e6 and abs(t1 - e1) < 1e6


def test_dac_copy_bytes_counted_by_hand(layer):
    with _profiler():
        _dac(layer, _reads())
    counts = tracing.counters()
    nwin = sum(_windows(L) for L in LENGTHS)
    # int16 group buffer padded by C; starts, lengths (i64), norms (4 f32)
    assert counts["h2d_bytes"] == 2 * (sum(LENGTHS) + C) + 32 * nwin
    # score f32, first state i16, counts 3 i32, codes ceil(2 T' / 4) u8
    assert counts["d2h_bytes"] == nwin * (4 + 2 + 12
                                          + -(-2 * _frames(C) // 4))


def test_whole_copy_bytes_counted_by_hand(layer):
    with _profiler():
        _whole(layer, _signals())
    counts = tracing.counters()
    lens = sorted(LENGTHS)
    h2d = d2h = 0
    for lo in range(0, len(lens), 2):
        b = lens[lo:lo + 2]
        h2d += 4 * max(b) * len(b) + 8 * len(b)           # x f32, lengths
        # score f32, frames i64, path i32 and moves bool a frame
        d2h += len(b) * (4 + 8 + 5 * _frames(max(b)))
    assert (counts["h2d_bytes"], counts["d2h_bytes"]) == (h2d, d2h)


def test_train_copy_bytes_counted_by_hand(layer):
    with _profiler():
        _train(layer, niteration=6, K=2)
    counts = tracing.counters()
    data = _data()
    nlabel = nstate(KLEN)
    # the resident set (chunks f32, labels i64, label weights f32), then
    # each group's draws (idx (K, B) and starts (K,), i64)
    resident = data["chunks"].nbytes + data["labels"].size * 8 + 4 * nlabel
    assert counts["h2d_bytes"] == resident + 3 * (2 * 4 * 8 + 2 * 8)
    assert counts["d2h_bytes"] == 6 * 2 * 4        # (loss, accuracy) f32


def test_counters_carry_the_launch_counts():
    counts = tracing.counters()
    for w in training.kernel_wrappers():
        assert counts["{}.launches".format(type(w).__name__)] == w.launches
