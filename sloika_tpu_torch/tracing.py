"""Spans and counters of the program's host work, on the profiler's clock.

The tracer is on exactly while a ``torch.profiler`` is active on the
calling thread (``torch._C._autograd._profiler_enabled()``): in a traced
window of the benchmark, under ``train --profile`` and under
``profile_train``.  Off, a span costs that check and an empty context
and records nothing, and a counter adds nothing.  On, a span

* opens a ``record_function`` range of its name, so it shows in the
  profiler's Chrome trace beside the kernels;
* appends ``(name, parent index, thread id, t0_ns, t1_ns)`` to an
  in-memory list, its times from ``time.time_ns()``: the Unix-epoch clock
  that the profiler's own events are stamped on (``trace_start_ns() +
  time_range * 1000``).  The parent is the span open on the same thread,
  so nested spans give self time (:func:`self_ns`).

The profiler's state is the thread's own, so a worker thread would record
nothing: :func:`carry` wraps a function handed to a worker, which then
records while the tracer was on where it was handed over, under the span
open there (the prefetch worker's ``train.sample`` and ``train.h2d`` are
children of ``train``).  A carried span opens no ``record_function``
range: the profiler does not watch that thread.

Counters: ``h2d_bytes`` and ``d2h_bytes``, the ``nbytes`` of each tensor
the program copies to and from the device (:func:`to_device`,
:func:`to_host`, :func:`count`), counted the same on the CPU route, where
the copy is a no-op.  :func:`counters` also returns the kernel wrappers'
launch counts.

Read-out: :func:`spans`, :func:`counters`; :func:`reset` clears what was
recorded (the launch counts are the wrappers' own and stay).
"""
import threading
import time

import torch
from torch.autograd.profiler import record_function

_profiling = torch._C._autograd._profiler_enabled


class Tracer:
    """What the program recorded while the tracer was on: open and closed
    span records ``[name, parent record, thread id, t0_ns, t1_ns]``, the
    counters, and the threads that record because a function was carried
    to them."""

    def __init__(self):
        self.records = []
        self.counts = {}
        self.carried = set()
        self.local = threading.local()
        self.lock = threading.Lock()

    def on(self):
        return _profiling() or (bool(self.carried)
                                and threading.get_ident() in self.carried)

    def stack(self):
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_tracer = Tracer()


class _Span:
    __slots__ = ("record", "range")

    def __init__(self, name):
        self.record = [name, None, threading.get_ident(), 0, None]
        self.range = None

    def __enter__(self):
        rec, stack = self.record, _tracer.stack()
        rec[1] = stack[-1] if stack else None
        stack.append(rec)
        _tracer.records.append(rec)
        rec[3] = time.time_ns()
        if _profiling():
            self.range = record_function(rec[0])
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        self.record[4] = time.time_ns()
        _tracer.stack().pop()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name):
    """A context manager: a span of ``name`` while the tracer is on."""
    if _profiling() or _tracer.carried and _tracer.on():
        return _Span(name)
    return _OFF


def count(name, n):
    """Add ``n`` to counter ``name`` while the tracer is on."""
    if _profiling() or _tracer.carried and _tracer.on():
        with _tracer.lock:
            _tracer.counts[name] = _tracer.counts.get(name, 0) + int(n)


def to_device(t, device):
    """``t.to(device)``, its bytes counted in ``h2d_bytes``."""
    count("h2d_bytes", t.nbytes)
    return t.to(device)


def to_host(t):
    """``t.cpu()``, its bytes counted in ``d2h_bytes``."""
    count("d2h_bytes", t.nbytes)
    return t.cpu()


def carry(fn):
    """``fn`` to be run on another thread, traced there if the tracer is
    on here, its spans the children of the span open here."""
    if not _tracer.on():
        return fn
    stack = _tracer.stack()
    parent = stack[-1] if stack else None

    def carried(*args, **kwargs):
        tid = threading.get_ident()
        if _tracer.on():             # run where it was handed over
            return fn(*args, **kwargs)
        _tracer.carried.add(tid)
        _tracer.local.stack = [parent] if parent is not None else []
        try:
            return fn(*args, **kwargs)
        finally:
            _tracer.carried.discard(tid)
            _tracer.local.stack = []
    return carried


def spans():
    """``[(name, parent index or None, thread id, t0_ns, t1_ns)]`` in the
    order the spans opened; ``t1_ns`` is None for a span still open."""
    recs = list(_tracer.records)
    index = {id(r): i for i, r in enumerate(recs)}
    return [(r[0], None if r[1] is None else index.get(id(r[1])), r[2],
             r[3], r[4]) for r in recs]


def counters():
    """{name: n}: ``h2d_bytes`` and ``d2h_bytes`` (absent until counted)
    and each kernel wrapper's launch counts, as ``<Wrapper>.<counter>``."""
    from sloika_tpu_torch import training
    with _tracer.lock:
        out = dict(_tracer.counts)
    for (w, c), n in training._counts().items():
        out["{}.{}".format(type(w).__name__, c)] = n
    return out


def reset():
    """Forget the recorded spans and counters."""
    with _tracer.lock:
        _tracer.records.clear()
        _tracer.counts.clear()


def self_ns(recorded=None):
    """{name: ns}: each closed span's duration less the part of it that
    its children on the same thread cover, summed by name."""
    recorded = spans() if recorded is None else recorded
    out = {}
    for name, _, _, t0, t1 in recorded:
        if t1 is not None:
            out[name] = out.get(name, 0) + t1 - t0
    for name, parent, tid, t0, t1 in recorded:
        if parent is not None and t1 is not None:
            pname, _, ptid, _, pt1 = recorded[parent]
            if ptid == tid and pt1 is not None:
                out[pname] -= t1 - t0
    return out
