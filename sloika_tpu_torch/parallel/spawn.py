"""Start N ranks without a launcher: what one ``--devices N`` or
``--ndevice N`` command does where the JAX package's one process drives N
devices.

Each rank is a process started with the ``spawn`` method (safe after the
parent touched a card), given ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` and a file store in a fresh temporary directory, and
runs ``entry(argv)``, which joins the group
(:func:`.mesh.maybe_init_distributed`).  The parent joins every rank, with a
time limit if given; a rank that raises, exits non-zero or outlives the
limit makes :func:`run` return non-zero, naming each failed rank (the
first to fail first), after the other ranks are stopped.
"""
import os
import pickle
import shutil
import sys
import tempfile
import time

import torch.multiprocessing as mp

from sloika_tpu_torch.parallel import mesh

#: seconds the other ranks get to end after one failed
FAIL_GRACE_S = 5.0


def _rank(index, entry, argv, nprocs, store):
    os.environ.update(RANK=str(index), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(index), LOCAL_WORLD_SIZE=str(nprocs))
    os.environ[mesh.STORE_ENV] = store
    try:
        code = entry(argv)
    finally:
        mesh.shutdown()
    if code:
        sys.exit(code)


def _stop(processes):
    for p in processes:
        if p.is_alive():
            p.terminate()
    for p in processes:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


def _ending(ctx, i):
    """How rank i ended: its traceback, or its exit code."""
    path = ctx.error_files[i]
    if os.path.exists(path) and os.path.getsize(path):
        with open(path, "rb") as fh:
            return "raised:\n" + pickle.load(fh)
    return "exited with code {}".format(ctx.processes[i].exitcode)


def run(entry, argv, nprocs, timeout=None):
    """Run ``entry(argv)`` on ``nprocs`` ranks and wait for them.

    :param entry: a module-level function (it is pickled by name), taking
        ``argv`` and returning an exit code or None
    :param timeout: seconds to wait for every rank; None waits until they
        end (a rank blocked in a collective raises after
        :data:`.mesh.TIMEOUT_S`)
    :returns: 0 when every rank returned a false code; else non-zero, with
        each failed rank named on stderr
    """
    if argv is None:
        argv = sys.argv[1:]
    tmp = tempfile.mkdtemp(prefix="sloika_ranks_")
    try:
        ctx = mp.start_processes(
            _rank, args=(entry, list(argv), nprocs,
                         os.path.join(tmp, "store")),
            nprocs=nprocs, join=False, start_method="spawn")
        procs = ctx.processes
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes):
                return 0
            first = next((i for i, c in enumerate(codes)
                          if c not in (None, 0)), None)
            if first is not None:
                # the others fail in turn (their collectives lose a peer) or
                # finish: a moment for them, so that each failure is named
                grace = time.monotonic() + FAIL_GRACE_S
                while (time.monotonic() < grace
                       and any(p.is_alive() for p in procs)):
                    time.sleep(0.05)
                _stop(procs)
                for i in [first] + [i for i, p in enumerate(procs)
                                    if i != first and p.exitcode != 0]:
                    sys.stderr.write("rank {} {}\n".format(
                        i, _ending(ctx, i)))
                return codes[first] if codes[first] > 0 else 1
            if deadline is not None and time.monotonic() > deadline:
                late = [i for i, p in enumerate(procs) if p.is_alive()]
                _stop(procs)
                sys.stderr.write("rank(s) {} did not finish within {:.0f} s; "
                                 "stopped\n".format(late, timeout))
                return 124
            time.sleep(0.05)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
