"""Host-side iterator helpers (copied from ``sloika_tpu/iterators.py``,
which imports nothing of JAX; the port keeps its own copy).

Of the reference's itertools grab-bag (``sloika/iterators.py``) these are
the helpers the JAX package keeps: ``empty_iterator``, ``take``,
``window``, ``centered_truncated_window``, ``blocker`` and ``pairwise``.
"""
from collections import deque
from itertools import islice, tee


def empty_iterator(it):
    """Test whether ``it`` yields anything, without losing its items.

    :returns: (is_empty, replacement_iterator) — use the returned iterator
        in place of the consumed one (reference iterators.py:19-32).
    """
    it = iter(it)
    try:
        first = next(it)
    except StopIteration:
        return True, iter(())
    from itertools import chain
    return False, chain([first], it)


def take(n, iterable):
    """First ``n`` items of ``iterable`` as a list (reference
    iterators.py:35-37)."""
    return list(islice(iterable, n))


def window(iterable, size):
    """Sliding windows of ``size`` consecutive items as tuples
    (reference iterators.py:245-259; used by bio.py k-mer iteration).

    Yields one tuple per full window; shorter-than-``size`` inputs yield
    nothing.
    """
    if size <= 0:
        raise ValueError("window size must be positive, got {}".format(size))
    buf = deque(maxlen=size)
    for item in iterable:
        buf.append(item)
        if len(buf) == size:
            yield tuple(buf)


def centered_truncated_window(iterable, size):
    """Sliding windows truncated at the edges so output length equals
    input length (reference iterators.py:262-283).

    Each element gets the window centred on it, clipped to the sequence;
    with even ``size`` the extra context falls on the right:
    ``[1,2,3,4,5], size=3 -> (1,2), (1,2,3), (2,3,4), (3,4,5), (4,5)``.
    """
    if size <= 0:
        raise ValueError("window size must be positive, got {}".format(size))
    items = list(iterable)
    n = len(items)
    left = (size - 1) // 2          # context to the left of the centre
    right = size - left             # centre + context to the right
    for i in range(n):
        yield tuple(items[max(0, i - left):min(n, i + right)])


def blocker(iterable, n):
    """Consecutive blocks of up to ``n`` items as lists; the final block
    may be short (reference iterators.py:125-131)."""
    it = iter(iterable)
    while True:
        block = list(islice(it, n))
        if not block:
            return
        yield block


def pairwise(iterable):
    """Overlapping pairs: s -> (s0, s1), (s1, s2), ... (reference
    iterators.py:99-104)."""
    a, b = tee(iterable)
    next(b, None)
    return zip(a, b)
