"""Sequence helpers of the remap path, copied from ``sloika_tpu/bio.py``."""
import numpy as np


def seq_to_kmers(seq, length):
    """Overlapping kmers of a sequence: 'ATATG',3 -> ['ATA','TAT','ATG']
    (sloika_tpu/bio.py:98)."""
    return [seq[x:x + length] for x in range(0, len(seq) - length + 1)]


def kmer_state_array(seq, length, alphabet=b'ACGT'):
    """Lexicographic state index of each kmer of a sequence, by base-``nbase``
    positional encoding (sloika_tpu/bio.py:103).

    :param seq: bytes (or str) sequence over ``alphabet``
    :returns: int32 array of length ``len(seq) - length + 1``
    """
    if isinstance(seq, str):
        seq = seq.encode('utf-8')
    if isinstance(alphabet, str):
        alphabet = alphabet.encode('utf-8')
    nbase = len(alphabet)
    lut = np.full(256, -1, dtype=np.int64)
    for i, b in enumerate(alphabet):
        lut[b] = i
    codes = lut[np.frombuffer(seq, dtype=np.uint8)]
    if np.any(codes < 0):
        raise ValueError("sequence contains letters outside alphabet")
    n = len(codes) - length + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int32)
    out = np.zeros(n, dtype=np.int64)
    for j in range(length):
        out = out * nbase + codes[j:j + n]
    return out.astype(np.int32)
