"""The traced run's reading of the device: spans around the harness's calls
into the program, a ``torch.profiler`` trace of the window, the device's
busy time (the union of its kernel and copy intervals, a frozen copy of
``sloika_tpu_torch/profile_train.py:119-146``), kernel time by name, and
the breakdown the result line carries."""
import contextlib
import re
import time

import torch

WINDOW = "bench.window"


class Spans:
    """Harness spans: host seconds by name, and a ``record_function``
    range each when tracing."""

    def __init__(self, tracing):
        self.tracing = tracing
        self.names = {WINDOW}
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name):
        self.names.add(name)
        t0 = time.perf_counter()
        try:
            if self.tracing:
                with torch.profiler.record_function(name):
                    yield
            else:
                yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name):
    """A kernel's name without its return type, namespace or arguments."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return name.split("(")[0][:160]


class Trace:
    """The device's work in a traced window, in seconds."""

    def __init__(self, prof, spans, window_s):
        events = list(prof.events())
        self.window_s = window_s
        dev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("ProfilerStep")
               and e.name not in spans.names]
        self.device = [(e.name, e.time_range.start, e.time_range.end)
                       for e in dev]
        host = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.name in spans.names]
        self.spans = [(e.name, e.time_range.start, e.time_range.end)
                      for e in host]
        win = [(s, e) for n, s, e in self.spans if n == WINDOW]
        self.window = win[0] if win else None
        busy = _union([(s, e) for _, s, e in self.device])
        if self.window:
            lo, hi = self.window
            busy = [[max(s, lo), min(e, hi)] for s, e in busy
                    if e > lo and s < hi]
        self.busy_intervals = busy
        self.busy_s = sum(e - s for s, e in busy) / 1e6

    def kernel_seconds(self, *patterns):
        """Device seconds of the kernels whose names hold a pattern."""
        return sum(e - s for n, s, e in self.device
                   if any(p in n for p in patterns)) / 1e6

    def device_ops(self, top=10):
        by = {}
        for n, s, e in self.device:
            k = short_name(n)
            by[k] = by.get(k, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top=10):
        """The longest stretches of the window with nothing on the device,
        each named by the innermost harness span the host was in."""
        if not self.window:
            return []
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals for x in iv] + [hi]
        gaps = []
        for s, e in zip(edges[0::2], edges[1::2]):
            s, e = max(s, lo), min(e, hi)
            if e > s:
                gaps.append((s, e))
        named = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inner = [(se - ss, n) for n, ss, se in self.spans
                     if ss <= mid <= se]
            named.append([min(inner)[1] if inner else WINDOW,
                          (e - s) / 1e6])
        return sorted(named, key=lambda kv: -kv[1])[:top]
