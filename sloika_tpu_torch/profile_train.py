"""Where a training step's time goes on the card.

    python -m sloika_tpu_torch.profile_train [--events] [--trace out.json]

Trains raw_0.98_rgrgr at full width (seeded random weights) on synthetic
chunks of 2,000 samples at B = 100, as ``chip_smoke.py`` does (with
``--events``, baseline_lstm at full width on chunks of 500 events of 4
features, as its event-training phase does), and prints:

1. the steady-state step time with and without a ``torch.cuda.synchronize()``
   at each step's progress mark (steps 6-30 of 30);
2. a ``torch.profiler`` trace of 10 steady steps, each ended by a sync:
   the device's busy time a step (the union of its kernel and copy
   intervals), the span of those intervals, and the device time a step of
   each kernel, largest first;
3. the host's share of those steps, from the spans the training loop
   records while the profiler runs (:mod:`sloika_tpu_torch.tracing`): the
   self time a step of ``train.sample`` and ``train.h2d`` (on the prefetch
   worker) and ``train.wait_group`` (the loop waiting on it).

Needs a CUDA card.  ``--trace`` also writes the Chrome trace.  The script
uses only the package's entry points, so it also profiles another tree's
package when that tree comes first on the path::

    PYTHONPATH=<tree> python sloika_tpu_torch/profile_train.py --events
"""
import argparse
import time

import numpy as np
import torch

TRAIN_B, TRAIN_SAMPLES, STRIDE, KLEN = 100, 2000, 5, 5
STEPS, WARM, ACTIVE, TOP = 30, 5, 10, 20
#: the two training workloads: model, chunk length (samples or events) and
#: the labels' stride
WORKLOADS = {"raw": ("raw_0.98_rgrgr", TRAIN_SAMPLES, STRIDE),
             "events": ("baseline_lstm", 500, 1)}


def synthetic_chunks(n=1000, samples=TRAIN_SAMPLES, stride=STRIDE,
                     klen=KLEN, seed=11):
    """A labelled-chunk set as ``load_labelled_chunks`` returns it: n
    chunks of ``samples`` samples (a noisy step signal, one level a frame)
    with labels at ``stride`` over the states of ``klen``."""
    rs = np.random.RandomState(seed)
    frames = samples // stride
    levels = rs.normal(size=(n, frames))
    chunks = np.repeat(levels, stride, axis=1)
    chunks += rs.normal(scale=0.3, size=chunks.shape)
    labels = rs.randint(0, 4 ** klen + 1, size=(n, frames)).astype(np.int32)
    return {"chunks": chunks[:, :, None].astype(np.float32),
            "labels": labels, "bad": np.zeros(labels.shape, bool),
            "weights": np.full(n, 1.0 / n), "attrs": {"kmer": klen}}


def synthetic_event_chunks(n=1000, T=WORKLOADS["events"][1], klen=KLEN,
                           seed=23):
    """A labelled event-chunk set as ``load_labelled_chunks`` returns it:
    n chunks of T events of 4 studentised-looking features, a label at
    every event (stride 1)."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 4 ** klen + 1, size=(n, T)).astype(np.int32)
    return {"chunks": rs.normal(size=(n, T, 4)).astype(np.float32),
            "labels": labels, "bad": np.zeros(labels.shape, bool),
            "weights": np.full(n, 1.0 / n), "attrs": {"kmer": klen}}


class StepMarks:
    """A training log that records the host time at each progress mark (a
    step's, or a group's of ``steps_per_dispatch`` steps), after a device
    sync if ``sync``, and steps a profiler if given."""

    def __init__(self, sync, prof=None):
        self.sync, self.prof, self.marks = sync, prof, []

    def write(self, message):
        if message and not message.strip(".C"):
            if self.sync:
                torch.cuda.synchronize()
            self.marks.append(time.perf_counter())
            if self.prof is not None:
                self.prof.step()


def _train(workload, data, steps, log, dev):
    from sloika_tpu_torch import models, training
    layer = models.network_factory(WORKLOADS[workload][0])(klen=KLEN,
                                                           sd=0.5, seed=0)
    return training.train(layer, data, batch_size=TRAIN_B,
                          chunk_len_range=(1.0, 1.0), drop=20,
                          niteration=steps, seed=1, log=log, device=dev)


def step_ms(workload, data, steps, warm, sync, dev):
    """Mean ms a steady-state step (steps warm+1 .. steps)."""
    marks = StepMarks(sync)
    _train(workload, data, steps, marks, dev)
    torch.cuda.synchronize()
    end = time.perf_counter()
    return 1e3 * (end - marks.marks[warm - 1]) / (steps - warm)


def device_breakdown(events, nsteps):
    """(busy ms, span ms, [(ms, calls, name)]) a step, from the profiler's
    device events (kernels and copies; the device-side ranges of user
    annotations such as ``ProfilerStep#N`` are left out)."""
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith("ProfilerStep")]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    by_name = {}
    for e in dev_events:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    table = sorted(((us / 1e3 / nsteps, n / nsteps, name)
                    for name, (us, n) in by_name.items()), reverse=True)
    return busy / 1e3 / nsteps, span / 1e3 / nsteps, table


def profile(workload, data, warm, active, dev, trace=None):
    """The profiler's events over ``active`` steady steps, and the self
    ns of the training loop's spans recorded meanwhile."""
    from torch.profiler import ProfilerActivity, schedule
    from sloika_tpu_torch import tracing
    tracing.reset()
    prof = torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=warm, warmup=2, active=active, repeat=1))
    # a sync at each step's end keeps each step's kernels in its window
    marks = StepMarks(sync=True, prof=prof)
    with prof:
        _train(workload, data, warm + 2 + active + 1, marks, dev)
        torch.cuda.synchronize()
    if trace:
        prof.export_chrome_trace(trace)
    return prof.events(), tracing.self_ns()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--events", action="store_true",
                        help="train baseline_lstm on event chunks")
    parser.add_argument("--trace", default=None,
                        help="write the profiler's Chrome trace here")
    args = parser.parse_args(argv)
    workload = "events" if args.events else "raw"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: profile_train needs a GPU")
    from sloika_tpu_torch import config
    config.disable_tf32()
    dev = torch.device("cuda")
    data = synthetic_event_chunks() if args.events else synthetic_chunks()
    for sync in (False, True, False):
        ms = step_ms(workload, data, STEPS, WARM, sync, dev)
        print("{}: {:.3f} ms a step, {:.1f} chunks/s".format(
            "sync" if sync else "nosync", ms, 1e3 * TRAIN_B / ms),
            flush=True)
    events, own = profile(workload, data, WARM, ACTIVE, dev, args.trace)
    busy, span, table = device_breakdown(events, ACTIVE)
    print("profiled {} steps: device busy {:.3f} ms a step, span {:.3f} ms "
          "a step, busy share of span {:.3f}; {:.0f} device events a step"
          .format(ACTIVE, busy, span, busy / span if span else 0.0,
                  sum(n for _, n, _ in table)))
    for ms, n, name in table[:TOP]:
        print("  {:8.3f} ms/step {:6.1f} calls/step  {}".format(
            ms, n, name[:100]))
    print("host, self time a profiled step: " + ", ".join(
        "{} {:.3f} ms".format(name, own.get(name, 0) / 1e6 / ACTIVE)
        for name in ("train.sample", "train.h2d", "train.wait_group")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
