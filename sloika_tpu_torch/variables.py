"""Alphabet and state-space accounting, copied from
``sloika_tpu/variables.py``: models emit posteriors over all kmers of length
``kmer`` plus one extra state (the stay/blank state of a transducer, or the
"bad" state)."""

DEFAULT_ALPHABET = b"ACGT"
DEFAULT_NBASE = len(DEFAULT_ALPHABET)


def nkmer(kmer, nbase=DEFAULT_NBASE):
    """Number of possible kmers of a given length (sloika_tpu/variables.py:13)."""
    return nbase ** kmer


def nstate(kmer, transducer=True, bad_state=True, nbase=DEFAULT_NBASE):
    """Number of states in a model's output distribution
    (sloika_tpu/variables.py:18); the transducer and bad states are never
    both counted."""
    return nkmer(kmer, nbase=nbase) + (transducer or bad_state)
