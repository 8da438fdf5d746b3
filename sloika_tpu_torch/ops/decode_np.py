"""Host (numpy) helpers of the legacy decoder, copied from
``sloika_tpu/ops/decode_np.py`` (that package's module imports nothing of
jax, but the port keeps its own copy): the posterior's preparation and the
kmer predecessor tables.  A transducer decodes on the device
(``ops/viterbi_kernel.py``, its plain twin ``ops/decode.py``).

Kmers are in lexicographic order.  A "step" moves one base (the new kmer's
prefix is the old kmer's suffix), a "skip" two.
"""
import numpy as np


def prepare_post(post, min_prob=1e-5, drop_bad=False):
    """Squeeze the batch axis of a (T, 1, nstate) posterior, drop the frames
    whose argmax is the bad state (column 0) and that column, renormalise,
    and floor at ``min_prob`` (sloika_tpu/ops/decode_np.py:33)."""
    post = np.squeeze(post, axis=1)
    if drop_bad:
        maxcall = np.argmax(post, axis=1)
        post = post[maxcall > 0, 1:]
        weight = np.sum(post, axis=1, keepdims=True)
        post = post / weight
    return min_prob + (1.0 - min_prob) * post


def predecessor_table(nkmer, nbase, order):
    """``P[j]``: every kmer state that reaches state ``j`` by shifting in
    ``order`` fresh bases, ordered by the predecessor's leading bases so a
    max over the row keeps the lowest index on a tie
    (sloika_tpu/ops/decode_np.py:52).

    :returns: int32 array of shape ``(nkmer, nbase**order)``
    """
    width = nbase ** order
    if nkmer % width:
        raise ValueError("{} kmers are not a multiple of {}".format(
            nkmer, width))
    lead = np.arange(width, dtype=np.int64) * (nkmer // width)
    kept_prefix = np.arange(nkmer, dtype=np.int64) // width
    return (kept_prefix[:, None] + lead[None, :]).astype(np.int32)
