"""The program's own spans and counters (``sloika_tpu_torch.tracing``) on a
traced run's timeline, for the readers of the host layer's metrics.

The program stamps its spans in Unix-epoch nanoseconds; the trace gives the
device's busy intervals and the harness's spans in microseconds from the
start of the trace.  The two are joined by anchors: each of the program's
entry spans (``basecall.dac``, ``basecall.signals``, ``train``) opens just
inside the harness span that wraps its call (``basecall``, ``train``).  The
offset is the least of their start differences over the window's calls,
and the residual the spread of those differences.  The bracket is the
width the calls' ends leave the offset: each entry span also closes just
inside the harness span, so the true offset lies between the largest end
difference and the least start difference.

A program without the tracer, or a trace with no device work in it (a run
on the CPU: no card to be idle, no link to cross), gives no reading."""
import sys
from collections import namedtuple

#: the program's entry spans, and the harness span each opens inside
ENTRIES = {"basecall.dac": "basecall", "basecall.signals": "basecall",
           "train": "train"}


def recorded():
    """(spans, counters) of the program's tracer, or None where the program
    has none."""
    try:
        from sloika_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans(), tracing.counters()


def _outermost(intervals):
    """The intervals that no other interval holds (the program's own
    ``train`` span shows in the trace under the harness span's name)."""
    out = []
    for s, e in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        if out and s >= out[-1][0] and e <= out[-1][1]:
            continue
        out.append((s, e))
    return out


class Alignment(namedtuple("Alignment", "base_ns shift_us residual_us "
                                         "bracket_us calls tid")):
    """The program's clock put on the trace's: trace us = (t_ns - base_ns)
    / 1e3 - shift_us (in integers first: Unix microseconds in a float are
    a quarter of a microsecond apart); the window's entry spans ``calls``
    and the main thread ``tid``."""

    def us(self, t_ns):
        return (t_ns - self.base_ns) / 1e3 - self.shift_us

    @property
    def offset_us(self):
        return self.base_ns / 1e3 + self.shift_us


def align(trace, spans):
    """The :class:`Alignment` of the window's calls, the last spans
    recorded of the last entry, or None where they do not pair with the
    harness's spans."""
    tops = [sp[0] for sp in spans
            if sp[1] is None and sp[0] in ENTRIES and sp[4] is not None]
    if not tops:
        return None
    entry = tops[-1]
    calls = [i for i, sp in enumerate(spans)
             if sp[0] == entry and sp[1] is None and sp[4] is not None]
    harness = _outermost([(s, e) for n, s, e in trace.spans
                          if n == ENTRIES[entry]])
    if not harness or len(calls) < len(harness):
        return None
    calls = calls[-len(harness):]
    base = spans[calls[0]][3]
    starts = [(spans[i][3] - base) / 1e3 - h[0]
              for i, h in zip(calls, harness)]
    ends = [(spans[i][4] - base) / 1e3 - h[1]
            for i, h in zip(calls, harness)]
    shift = min(starts)
    return Alignment(base, shift, max(starts) - shift, shift - max(ends),
                     calls, spans[calls[0]][2])


def innermost(spans, al):
    """[(start_us, end_us, name)]: the stretches of the window's calls, on
    the trace's clock, each named by the innermost program span open on the
    main thread (one thread's spans nest, in the order they opened)."""
    lo, hi = spans[al.calls[0]][3], spans[al.calls[-1]][4]
    out, stack = [], []
    at = lo

    def upto(t):
        if stack and t > at:
            out.append((al.us(at), al.us(t), stack[-1][0]))
        return max(at, t)

    for name, _, t, t0, t1 in spans:
        if t != al.tid or t1 is None or t0 < lo or t1 > hi:
            continue
        while stack and stack[-1][1] <= t0:
            at = upto(stack[-1][1])
            stack.pop()
        at = upto(t0)
        stack.append((name, t1))
    while stack:
        at = upto(stack[-1][1])
        stack.pop()
    return out


def idle_by_span(trace, spans):
    """({span name: idle us}, :class:`Alignment`): the device's idle time
    in the traced window split by the innermost main-thread program span
    the host was in (None where no program span was open), or None where
    there is nothing to read."""
    if not trace.device or not trace.window:
        return None
    al = align(trace, spans)
    if al is None:
        return None
    lo, hi = trace.window
    edges = [lo] + [x for iv in trace.busy_intervals for x in iv] + [hi]
    idle = [(max(s, lo), min(e, hi)) for s, e in zip(edges[0::2],
                                                      edges[1::2])]
    idle = [(s, e) for s, e in idle if e > s]
    named = innermost(spans, al)
    out, j = {}, 0
    for s, e in idle:
        covered = 0.0
        while j < len(named) and named[j][1] <= s:
            j += 1
        k = j
        while k < len(named) and named[k][0] < e:
            a, b = max(s, named[k][0]), min(e, named[k][1])
            if b > a:
                out[named[k][2]] = out.get(named[k][2], 0.0) + (b - a)
                covered += b - a
            k += 1
        if e - s > covered:
            out[None] = out.get(None, 0.0) + (e - s - covered)
    return out, al


def idle_host_pct(ctx, names):
    """The share of the window in which the device was idle while the main
    thread was in one of the program spans ``names``, or None.  Prints the
    alignment to standard error."""
    got = recorded()
    if got is None:
        return None
    res = idle_by_span(ctx.trace, got[0])
    if res is None:
        return None
    by, al = res
    print("program spans: {} calls, clock offset {:.3f} us, residual "
          "{:.3f} us, bracket {:.3f} us; idle s by span {}".format(
              len(al.calls), al.offset_us, al.residual_us, al.bracket_us,
              {k: round(v / 1e6, 6) for k, v in sorted(
                  by.items(), key=lambda kv: -kv[1])}),
          file=sys.stderr, flush=True)
    return 100.0 * sum(by.get(n, 0.0) for n in names) / 1e6 / \
        ctx.trace.window_s


def bytes_per_sample(ctx, counter):
    """A copy counter of the window over its read samples, or None."""
    got = recorded()
    if got is None or not ctx.trace.device:
        return None
    n = got[1].get(counter)
    if n is None or not ctx.work.get("samples"):
        return None
    return n / ctx.work["samples"]
