"""Raw-signal preparation shared by basecalling and chunkify, copied from
``sloika_tpu/data/batching.py`` (whose module imports jax)."""
import numpy as np

from sloika_tpu_torch import maths
from sloika_tpu_torch.config import sloika_dtype
from sloika_tpu_torch.variables import DEFAULT_ALPHABET

AVAILABLE_NORMALISATIONS = frozenset(['none', 'per-read', 'per-chunk'])


def kmer_array_to_states(kmer_array, kmer_len, alphabet=DEFAULT_ALPHABET,
                         index_from=0):
    """Centre ``kmer_len``-mer of each (longer) kmer in ``kmer_array`` as a
    lexicographic state index (copied from sloika_tpu/data/batching.py:20).
    """
    kmer_array = np.ascontiguousarray(kmer_array)
    if kmer_array.dtype.kind == 'U':
        # a unicode array viewed as raw bytes is UTF-32: re-encode so the
        # byte lookup below sees one byte per letter
        kmer_array = kmer_array.astype('S')
    itemsize = kmer_array.dtype.itemsize
    old_len = len(kmer_array.flat[0])
    if kmer_len > old_len:
        raise ValueError("kmer_len {} exceeds the kmers' length {}".format(
            kmer_len, old_len))
    offset = (old_len - kmer_len + 1) // 2

    if isinstance(alphabet, str):
        alphabet = alphabet.encode('utf-8')
    lut = np.full(256, -1, dtype=np.int64)
    for i, b in enumerate(alphabet):
        lut[b] = i
    nbase = len(alphabet)

    flat = kmer_array.reshape(-1)
    a = np.frombuffer(flat.tobytes(), dtype=np.uint8).reshape(len(flat),
                                                              itemsize)
    codes = lut[a[:, offset:offset + kmer_len]]
    if np.any(codes < 0):
        raise ValueError("kmer array contains letters outside alphabet")
    powers = nbase ** np.arange(kmer_len - 1, -1, -1, dtype=np.int64)
    states = (codes * powers).sum(axis=1) + index_from
    return states.reshape(kmer_array.shape).astype(np.int32)


def trim_open_pore(signal, max_op_fraction=0.3, window_size=100):
    """(start, end) of the read within a raw signal, found by thresholding
    the local MAD: open-pore stretches vary little (copied from
    sloika_tpu/data/batching.py:111, its ``var_method='mad'``,
    ``return_range=True`` form)."""
    ml = len(signal) // window_size
    ub = ml * window_size
    local_var = maths.mad(signal[:ub].reshape((ml, window_size)), axis=1)
    probably_read = local_var > np.percentile(local_var, 100 * max_op_fraction)
    ix = np.arange(local_var.shape[0])[probably_read]
    return ix.min() * window_size, (ix.max() + 1) * window_size


def normalise_raw_signal(signal):
    """Per-read (median, MAD) normalisation (copied from
    sloika_tpu/data/batching.py:136)."""
    return ((signal - np.median(signal)) / maths.mad(signal)).astype(
        sloika_dtype)
