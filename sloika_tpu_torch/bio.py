"""Sequence helpers of the basecall, remap and scoring paths, copied from
``sloika_tpu/bio.py``."""
from itertools import product

import numpy as np

_COMPLEMENT = {'A': 'T', 'T': 'A', 'C': 'G', 'G': 'C', 'X': 'X', 'N': 'N',
               'a': 't', 't': 'a', 'c': 'g', 'g': 'c', 'x': 'x', 'n': 'n',
               '-': '-'}


def all_kmers(length, alphabet='ACGT'):
    """All kmers of ``length``, sorted by the ordering of ``alphabet``; a
    bytes alphabet yields bytes kmers (sloika_tpu/bio.py:21)."""
    if isinstance(alphabet, bytes):
        letters = alphabet.decode('utf-8')
        return [''.join(x).encode('utf-8')
                for x in product(letters, repeat=length)]
    return [''.join(x) for x in product(alphabet, repeat=length)]


def reverse_complement(seq, compdict=_COMPLEMENT):
    """Reverse complement of a base string (sloika_tpu/bio.py:88)."""
    return ''.join(compdict[b] for b in seq)[::-1]


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


def _overlap_move(k1, k2, allow_identical):
    """Smallest forward shift under which ``k2`` extends ``k1``: 0 for an
    identical stay (when allowed), len(k1) for no overlap
    (sloika_tpu/bio.py:133)."""
    if allow_identical and k1 == k2:
        return 0
    return next((m for m in range(1, len(k1)) if k1[m:] == k2[:-m]), len(k1))


def kmers_to_sequence(kmers, always_move=False):
    """Collapse a kmer path into a sequence by maximal overlap
    (sloika_tpu/bio.py:143-178: ``max_overlap`` then ``reduce_kmers``; the
    moves are consistent with their kmers by construction).

    :param always_move: transducer semantics: a kmer may not overlap itself
        entirely (no stays in the path)
    """
    moves = [_overlap_move(k1, k2, not always_move)
             for k1, k2 in zip(kmers, kmers[1:])]
    tails = [k if m >= len(k) else k[-m:]
             for k, m in zip(kmers[1:], moves) if m > 0]
    return kmers[0] + kmers[0][:0].join(tails)
