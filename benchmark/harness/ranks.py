"""The ranks of a cell that spans cards: rank 0 is the harness's own
process, on its device; ranks 1 to n-1 are processes that
``torch.multiprocessing`` starts (spawn), rank r on card r (or the CPU),
each building the same cell's driver from the seed and making the same
calls into the program as rank 0.  They meet in the port's own group
(``sloika_tpu_torch.parallel.mesh.maybe_init_distributed``: NCCL across
cards, gloo on the CPU) at a free port of localhost, with a timeout on its
collectives.  The host's cores are shared out: each rank takes an equal
share of them for its intra-op threads, and no more than rank 0 had.

A failed rank stops the rest, so that a fault ends the run non-zero and
never hangs: rank 0 watches its ranks and, when one ends badly or the
group outlives its deadline (set-up's allowance, then the window's),
names it on standard error, stops every rank and exits; a rank whose
parent has gone exits too.  A rank that holds a banned module (``jax``,
the JAX package, ...) once its window has closed names it and ends
badly, as rank 0's own process does in ``benchmark/run.py``.
"""
import contextlib
import os
import socket
import sys
import threading
import time

import torch

from benchmark.harness import faults

#: the launcher's variables the port's group reads
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
       "MASTER_ADDR", "MASTER_PORT")
#: seconds between the watchdogs' looks
POLL_S = 0.2
#: seconds a collective may wait for a peer before it fails
GROUP_TIMEOUT_S = 120
#: seconds from the ranks' start to the window: their start, inputs,
#: group and set-up's steps (the kernels are built by rank 0 before)
SETUP_S = 300
#: the window's deadline: this many times the seconds asked for, plus
#: END_S for its whole groups of steps and the ranks' leaving
WINDOW_FACTOR = 4
END_S = 120


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _environ(rank, n, port):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def threads_per_rank(n):
    """Intra-op threads a rank: an equal share of the cores this process
    may run on, and no more than it has now."""
    cores = len(os.sched_getaffinity(0))
    return max(1, min(torch.get_num_threads(), cores // n))


def join_group(device):
    """Join the group the environment describes, its collectives timing
    out after :data:`GROUP_TIMEOUT_S`."""
    from sloika_tpu_torch.parallel import mesh
    mesh.TIMEOUT_S = GROUP_TIMEOUT_S
    mesh.maybe_init_distributed(device.type)


def _die(message):
    sys.stderr.write(message + "\n")
    sys.stderr.flush()
    os._exit(3)


def _watch_parent():
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(POLL_S)
        _die("rank {}: the harness's process has gone".format(
            os.environ.get("RANK")))

    threading.Thread(target=watch, daemon=True).start()


def _rank(index, root, name, seed, device_type, n, port, fault_names,
          threads):
    """Rank ``index + 1``: the cell's driver through set-up and the
    window, under the faults planted in rank 0."""
    rank = index + 1
    _environ(rank, n, port)
    _watch_parent()
    torch.set_num_threads(threads)
    from benchmark.harness import spec
    from benchmark.harness import trace as tr
    from benchmark.run import banned_modules
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    cell = spec.Cell(name, root=root)
    with contextlib.ExitStack() as stack:
        for f in fault_names:
            stack.enter_context(faults.FAULTS[f]())
        driver = cell.driver.Driver(cell, seed, device, tr.Spans(False))
        driver.rank = rank
        driver.setup()
        driver.run_window(None)
        driver.release()
    banned = banned_modules()
    if banned:
        _die("rank {}: the run loaded {}".format(rank, ", ".join(banned)))
    from sloika_tpu_torch.parallel import mesh
    mesh.shutdown()


class Group:
    """Rank 0's hold on the ranks it starts (rank 0 joins their group by
    :func:`join_group`): :meth:`window` gives them the window's deadline,
    :meth:`close` leaves the group and waits for them."""

    def __init__(self, cell, seed, device, n):
        import torch.multiprocessing as mp
        port = _free_port()
        _environ(0, n, port)
        threads = threads_per_rank(n)
        torch.set_num_threads(threads)
        self.ctx = mp.start_processes(
            _rank, args=(cell.root, cell.name, seed, device.type, n, port,
                         list(faults.ACTIVE), threads),
            nprocs=n - 1, join=False, daemon=True, start_method="spawn")
        self.deadline = time.monotonic() + SETUP_S
        self.closing = threading.Event()
        self.watchdog = threading.Thread(target=self._watch, daemon=True)
        self.watchdog.start()

    def window(self, seconds):
        """The window of ``seconds`` starts: its deadline replaces
        set-up's."""
        self.deadline = time.monotonic() + WINDOW_FACTOR * seconds + END_S

    def _failed(self, indices):
        from sloika_tpu_torch.parallel.spawn import _ending
        return "\n".join("rank {} {}".format(i + 1, _ending(self.ctx, i))
                         for i in indices)

    def _stop(self):
        from sloika_tpu_torch.parallel.spawn import _stop
        _stop(self.ctx.processes)

    def _watch(self):
        while not self.closing.wait(POLL_S):
            bad = [i for i, p in enumerate(self.ctx.processes)
                   if p.exitcode not in (None, 0)]
            late = time.monotonic() > self.deadline
            if not bad and not late:
                continue
            self._stop()
            if bad:
                _die(self._failed(bad))
            _die("the ranks outlived their deadline; stopped")

    def abort(self):
        """Stop every rank now (rank 0 failed)."""
        self.closing.set()
        self._stop()

    def close(self):
        """Leave the group and wait for the ranks to end (they end after
        the window, leaving it too); a rank that does not end in time, or
        ends badly, ends the run."""
        from sloika_tpu_torch.parallel import mesh
        mesh.shutdown()
        self.closing.set()
        self.watchdog.join()
        for p in self.ctx.processes:
            p.join(max(0.0, self.deadline - time.monotonic()))
        codes = [p.exitcode for p in self.ctx.processes]
        if any(c != 0 for c in codes):
            self._stop()
            _die(self._failed(i for i, c in enumerate(codes) if c != 0))
        for k in ENV:
            os.environ.pop(k, None)
