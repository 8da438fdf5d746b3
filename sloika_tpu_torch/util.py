"""Host-side helpers of the remap path, copied from ``sloika_tpu/util.py``
(geometric priors, array trimming, progress dots, FASTA loading)."""
import os
import sys

import numpy as np


def geometric_prior(n, m, rev=False):
    """Log probabilities of a geometric start-position distribution
    (sloika_tpu/util.py:17).

    :param n: length of output vector
    :param m: mean of the distribution
    :param rev: reverse the distribution (prior over final position)
    """
    p = 1.0 / (1.0 + m)
    prior = np.repeat(np.log(p), n)
    prior[1:] += np.arange(1, n) * np.log1p(-p)
    if rev:
        prior = prior[::-1]
    return prior


def progress_report(i, fh=sys.stderr):
    """A dotty way of showing progress (sloika_tpu/util.py:41)."""
    i += 1
    fh.write('.')
    if i % 50 == 0:
        fh.write('{:8d}\n'.format(i))
    return i


def trim_array(x, from_start, from_end):
    """Drop ``from_start``/``from_end`` entries from either end of an array
    (sloika_tpu/util.py:50)."""
    if from_start < 0 or from_end < 0:
        raise ValueError("trim lengths must be non-negative")
    from_end = None if from_end == 0 else -from_end
    return x[from_start:from_end]


def parse_fasta(fh):
    """Minimal FASTA parser yielding (id, sequence) pairs
    (sloika_tpu/util.py:58)."""
    name, parts = None, []
    for line in fh:
        line = line.strip()
        if not line:
            continue
        if line.startswith('>'):
            if name is not None:
                yield name, ''.join(parts)
            name = line[1:].split()[0]
            parts = []
        else:
            parts.append(line)
    if name is not None:
        yield name, ''.join(parts)


def fasta_file_to_dict(fasta_file_name):
    """Load FASTA records as {id: bytes-sequence}, skipping records with N
    (sloika_tpu/util.py:76)."""
    references = {}
    with open(fasta_file_name, 'r') as fh:
        for rid, refseq in parse_fasta(fh):
            if 'N' not in refseq and len(refseq) > 0:
                references[rid] = refseq.encode('utf-8')
    return references


def ensure_dir_for(path):
    """Create parent directories of ``path`` if missing
    (sloika_tpu/util.py:86)."""
    d = os.path.dirname(path)
    if d and not os.path.exists(d):
        os.makedirs(os.path.normpath(d), exist_ok=True)
