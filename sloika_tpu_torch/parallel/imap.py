"""Host-side parallel mapping with fault masking (copied from
``sloika_tpu/parallel/imap.py:18-75``, which imports nothing of JAX; the
port keeps its own copy).

The reference's process pool (``iterators.py:293-351`` ``imap_mp``) and its
``try_except_pass`` decorator: the device work is batched centrally, so the
host needs threads only for I/O-bound per-read loading.  ``threads=1`` runs
inline, for deterministic debugging.
"""
import sys
import traceback
from concurrent.futures import ThreadPoolExecutor


def try_except_pass(func, recover=None, recover_fail=False):
    """Wrap ``func`` to catch all exceptions, report them to stderr and
    return None, optionally running a ``recover`` callback."""
    def wrapped(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except Exception:
            sys.stderr.write("{}\n".format(traceback.format_exc()))
            if recover is not None:
                try:
                    recover(*args, **kwargs)
                except Exception:
                    sys.stderr.write("Unrecoverable error.\n")
                    if recover_fail:
                        raise
            return None
    return wrapped


def imap_mp(function, args, fix_args=None, fix_kwargs=None, threads=1,
            unordered=False, pass_exception=False, init=None, initargs=()):
    """Map ``function`` over ``args`` with optional thread parallelism.

    :param function: worker called as ``function(arg, *fix_args,
        **fix_kwargs)``
    :param fix_args: positional arguments after the mapped one
    :param fix_kwargs: keyword arguments for every call
    :param threads: 1 = inline (deterministic); >1 = thread pool
    :param unordered: yield results as they complete (thread pool only)
    :param pass_exception: mask exceptions to None instead of raising
    :param init, initargs: one-off initialiser (called once, in the caller —
        worker state is shared, unlike the reference's per-process globals)
    """
    fix_args = tuple(fix_args or ())
    fix_kwargs = dict(fix_kwargs or {})
    if init is not None:
        init(*initargs)

    def call(arg):
        return function(arg, *fix_args, **fix_kwargs)

    if pass_exception:
        call = try_except_pass(call)

    if threads <= 1:
        for arg in args:
            yield call(arg)
        return

    with ThreadPoolExecutor(max_workers=threads) as pool:
        if unordered:
            futures = [pool.submit(call, a) for a in args]
            from concurrent.futures import as_completed
            for fut in as_completed(futures):
                yield fut.result()
        else:
            yield from pool.map(call, args)
