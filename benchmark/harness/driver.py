"""What every traffic driver does: set up from the seed, run the program
for a window, then judge the program's answers against the plain
reference.  A driver is ``benchmark/harness/drivers/<name>.py`` with a
class ``Driver``; a traffic file names it under ``driver``."""
import time

import numpy as np
import torch

from benchmark.harness.spec import sub_seed


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    """Base of the drivers.  Subclasses define :meth:`setup`, :meth:`call`
    (one unit of the closed loop, returning its answers), :meth:`program`
    and :meth:`reference` (the answers compared, from the program's run and
    from the reference at a precision) and :meth:`numbers`."""

    def __init__(self, cell, seed, device, spans):
        self.cell, self.seed, self.device, self.spans = (cell, seed, device,
                                                         spans)
        self.config, self.traffic = cell.config, cell.traffic
        self.layers = self.config["layers"]
        self.rate_metric = self.traffic["rate_metric"]
        #: traffic-derived work of the window, for the per-layer readers
        self.work = {}

    def build(self):
        """Compile the cell's own kernels, all at once, into the program's
        build directory inside the checkout (a library already built from
        the same sources is kept)."""
        if self.device.type == "cuda":
            from sloika_tpu_torch import cuda_build
            with self.spans("build"):
                cuda_build.build_all(self.traffic["kernels"])

    # -- the window ------------------------------------------------------

    def run_window(self, seconds):
        """Call the program in a closed loop until ``seconds`` have passed;
        every call's answers are kept.  Returns (work units, attempted,
        failed)."""
        self.answers = []
        t0 = time.perf_counter()
        while True:
            with self.spans(self.span_name):
                self.answers.append(self.call())
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        return self.tally(len(self.answers))

    def notes(self):
        """A line on the window's answers for standard error, or ""."""
        return ""

    def release(self):
        """Drop the program's state before the reference runs."""
        for name in ("caller", "layer", "opt_state"):
            if hasattr(self, name):
                delattr(self, name)

    # -- the comparison --------------------------------------------------

    def sample(self, n, total, longest):
        """``n`` of units 0..``total``-1: one drawn from the seed in each of
        ``n`` equal stretches of consecutive units, the stretch that holds
        ``longest`` taking it.  So any fault confined to two stretches'
        length of consecutive units (a batch, a group's tail) is sampled."""
        rs = np.random.RandomState(sub_seed(self.seed, 9))
        edges = np.linspace(0, total, n + 1).astype(np.int64)
        out = [int(rs.randint(lo, hi)) for lo, hi in zip(edges[:-1],
                                                         edges[1:])]
        out[int(np.searchsorted(edges, longest, side="right")) - 1] = longest
        return out

    def answers_of(self, precision):
        """The reference's answers at ``precision``, computed once."""
        memo = self.__dict__.setdefault("_reference", {})
        if precision not in memo:
            memo[precision] = self.reference(precision)
        return memo[precision]

    def check(self):
        """[(name, value, limit)] of the program's answers against the
        reference's in float32."""
        return self.numbers(self.program(), self.answers_of("float32"))

    def control(self):
        """[(name, value, limit)] of the reference in TF32 put in the
        program's place."""
        return self.numbers(self.answers_of("tf32"),
                            self.answers_of("float32"))

    def limits(self, values):
        lim = self.traffic["limits"]
        return [(k, float(v), float(lim[k])) for k, v in values]
