"""Alignment-based accuracy evaluation of basecalls (cf.
``sloika_tpu/align.py``, the reference's misc/align.py).

Calls are aligned to reference sequences by the port's banded affine
aligner (:mod:`sloika_tpu_torch.native`), both orientations tried, and
scored per read (match, mismatch, insertion, deletion, coverage, identity,
accuracy, the CIscore's information content); :func:`summary` writes the
report (mean and KDE-mode accuracy, quantiles, proportion over 90%, total
CIscore).  scipy (the KDE) and matplotlib (the histogram) are imported only
by the functions that use them.
"""
import sys

import numpy as np

from sloika_tpu_torch import bio, native

QUANTILES = [5, 25, 50, 75, 95]


#: Calls shorter than this can never be mapped by the reference's evaluator
#: (its bwa mem invocation uses ``-k14``, misc/align.py:22,46), so they are
#: treated as unmapped here too and excluded from accuracy statistics.
MIN_MAPPABLE_LENGTH = 14


def accuracy_metrics(query_name, query, ref_name, ref, min_coverage=0.6,
                     both_strands=True, min_length=MIN_MAPPABLE_LENGTH):
    """Align one basecall against one reference; per-read metric row
    (reference samacc semantics, align.py:70-133) or None if unalignable/
    low coverage/too short to map (bwa-unmapped analogue).  Copied from
    sloika_tpu/align.py:26."""
    if len(query) < min_length:
        return None
    # auto_widen verifies each banded alignment at double width so a long
    # indel in a bad basecall cannot silently deflate the reported accuracy
    # (band-failure policy, native.align_semiglobal)
    fwd = native.align_semiglobal(query, ref, auto_widen=True)
    aln, strand = fwd, '+'
    if both_strands:
        rc = native.align_semiglobal(query, bio.reverse_complement(
            ref.decode() if isinstance(ref, bytes) else ref),
            auto_widen=True)
        if rc is not None and (fwd is None or rc.score > fwd.score):
            aln, strand = rc, '-'
    if aln is None:
        return None

    qlen = len(query)
    coverage = float(aln.qend - aln.qstart) / max(qlen, 1)
    if coverage < min_coverage:
        return None

    nmism = aln.mismatch + aln.insertion + aln.deletion
    correct = aln.match
    readlen = aln.match + aln.mismatch + aln.insertion
    perr = min(0.75, float(nmism) / max(readlen, 1))
    pmatch = 1.0 - perr
    entropy = pmatch * np.log2(pmatch) if pmatch > 0 else 0.0
    if nmism > 0:
        entropy += perr * np.log2(perr / 3.0)

    total = aln.match + aln.mismatch + aln.insertion + aln.deletion
    # reverse-strand hits are found by aligning against the RC'd reference;
    # report forward-strand coordinates like the reference's SAM-based
    # samacc (misc/align.py:99-101)
    if strand == '-':
        rstart, rend = len(ref) - aln.rend, len(ref) - aln.rstart
    else:
        rstart, rend = aln.rstart, aln.rend
    return {
        'reference': ref_name,
        'query': query_name,
        'strand': strand,
        'reference_start': rstart,
        'reference_end': rend,
        'match': aln.match,
        'mismatch': aln.mismatch,
        'insertion': aln.insertion,
        'deletion': aln.deletion,
        'coverage': coverage,
        'id': float(correct) / max(aln.match + aln.mismatch, 1),
        'accuracy': float(correct) / max(total, 1),
        # aligned columns (match+mismatch) x per-column information,
        # reference samacc bins[0] semantics (misc/align.py:128-131)
        'information': (aln.match + aln.mismatch) * (2.0 + entropy),
    }


def local_alignment_counts(query, ref, match=2, mismatch=-2, gap_open=-4,
                           gap_extend=-2):
    """Exact affine-gap LOCAL alignment (Smith-Waterman/Gotoh, no direct
    Ix<->Iy transitions — the native kernel's gap grammar) with alignment
    counts.  Row-vectorised numpy: the in-row deletion recursion
    ``Iy[j] = max(M[j-1]+go+ge, Iy[j-1]+ge)`` is solved in closed form with
    a prefix max, so the DP is O(n) numpy row operations.

    The reference evaluates accuracy with bwa mem — a *local* aligner that
    soft-clips low-quality call ends — while the production evaluator here
    is semiglobal with free reference end gaps (`native.align_semiglobal`);
    this function measures the difference (copied from
    sloika_tpu/align.py:88).

    :returns: (score, nmatch, nmismatch, nins, ndel, qstart, qend,
        rstart, rend) — q/r spans of the local alignment (end exclusive)
        or None for empty sequences
    """
    if isinstance(query, str):
        query = query.encode()
    if isinstance(ref, str):
        ref = ref.encode()
    n, m = len(query), len(ref)
    if n == 0 or m == 0:
        return None
    q = np.frombuffer(query, np.uint8)
    r = np.frombuffer(ref, np.uint8)
    NEG = np.int32(-(1 << 29))
    oe = gap_open + gap_extend
    cols = np.arange(m + 1, dtype=np.int64)

    # rows hold M/Ix/Iy for the current i; tb codes for traceback:
    # tbM: 0 = local start, 1 = from M, 2 = from Ix, 3 = from Iy (diag)
    # tbX/tbY: 0 = gap open (from M), 1 = gap extension
    Mp = np.full(m + 1, NEG, np.int64)
    Xp = np.full(m + 1, NEG, np.int64)
    Yp = np.full(m + 1, NEG, np.int64)
    tbM = np.zeros((n + 1, m + 1), np.int8)
    tbX = np.zeros((n + 1, m + 1), np.int8)
    tbY = np.zeros((n + 1, m + 1), np.int8)
    best, bi, bj = 0, 0, 0
    for i in range(1, n + 1):
        s = np.where(r == q[i - 1], match, mismatch).astype(np.int64)
        # M[i, j] = s + max(0, M/Ix/Iy[i-1, j-1])
        diag = np.stack([np.zeros(m, np.int64), Mp[:-1], Xp[:-1], Yp[:-1]])
        frm = np.argmax(diag, axis=0)         # first max wins: start beats
        M = np.full(m + 1, NEG, np.int64)     # equal-scoring continuations
        M[1:] = diag[frm, np.arange(m)] + s
        tbM[i, 1:] = frm
        # Ix[i, j] = max(M[i-1, j] + oe, Ix[i-1, j] + ge)
        opn, ext = Mp + oe, Xp + gap_extend
        X = np.maximum(opn, ext)
        tbX[i] = (ext > opn).astype(np.int8)
        # Iy[i, j] = max_k<=j-1 (M[i, k] + oe + (j-1-k) ge): prefix max
        t = M + oe - gap_extend * cols
        p = np.maximum.accumulate(t)
        Y = np.full(m + 1, NEG, np.int64)
        Y[1:] = p[:-1] + gap_extend * (cols[1:] - 1)
        # open exactly when the prefix max is achieved at k = j-1
        tbY[i, 1:] = (t[:-1] < p[:-1]).astype(np.int8)
        j = int(np.argmax(M))
        if M[j] > best:
            best, bi, bj = int(M[j]), i, j
        Mp, Xp, Yp = M, X, Y

    if best <= 0:
        return None
    nmatch = nmism = nins = ndel = 0
    i, j, state = bi, bj, 0                   # 0 = M, 1 = Ix, 2 = Iy
    qend, rend = bi, bj
    while True:
        if state == 0:
            if q[i - 1] == r[j - 1]:
                nmatch += 1
            else:
                nmism += 1
            code = tbM[i, j]
            i -= 1
            j -= 1
            if code == 0:
                break
            state = code - 1
        elif state == 1:
            nins += 1
            state = 0 if tbX[i, j] == 0 else 1
            i -= 1
        else:
            ndel += 1
            state = 0 if tbY[i, j] == 0 else 2
            j -= 1
    return (best, nmatch, nmism, nins, ndel, i, qend, j, rend)


def local_accuracy_metrics(query_name, query, ref_name, ref,
                           both_strands=True, min_length=MIN_MAPPABLE_LENGTH):
    """Per-read metric row under bwa-like LOCAL alignment semantics
    (soft-clipped call ends excluded from the error counts), for
    cross-validating the production semiglobal evaluator
    (sloika_tpu/align.py:182)."""
    if len(query) < min_length:
        return None
    fwd = local_alignment_counts(query, ref)
    aln, strand = fwd, '+'
    if both_strands:
        rc = local_alignment_counts(query, bio.reverse_complement(
            ref.decode() if isinstance(ref, bytes) else ref))
        if rc is not None and (fwd is None or rc[0] > fwd[0]):
            aln, strand = rc, '-'
    if aln is None:
        return None
    score, nmatch, nmism, nins, ndel, qstart, qend, rstart, rend = aln
    total = nmatch + nmism + nins + ndel
    return {
        'reference': ref_name,
        'query': query_name,
        'strand': strand,
        'match': nmatch, 'mismatch': nmism,
        'insertion': nins, 'deletion': ndel,
        'coverage': float(qend - qstart) / max(len(query), 1),
        'id': float(nmatch) / max(nmatch + nmism, 1),
        'accuracy': float(nmatch) / max(total, 1),
        'score': score,
    }


def evaluate_basecalls(calls, references, min_coverage=0.6, genome=False):
    """Metric rows for {name: sequence} basecalls against references.

    Three reference layouts (mirroring the reference's bwa-vs-genome
    flexibility, misc/align.py:46-67):

    * per-read records keyed by read name (preferred);
    * a single record used for every read;
    * ``genome=True`` (or a multi-record FASTA where *no* call name matches
      a record — i.e. the FASTA is a genome, not a per-read set): each call
      is aligned against every contig and the best-scoring contig wins.

    In per-read mode calls without a matching record are skipped (fault
    masking), not force-aligned against unrelated references
    (sloika_tpu/align.py:213).
    """
    single = list(references.values())[0] if len(references) == 1 else None
    auto_genome = (single is None
                   and not any(n in references for n in calls))
    rows = []
    for name, seq in calls.items():
        if genome or auto_genome:
            row = _best_contig_metrics(name, seq, references,
                                       min_coverage=min_coverage)
        else:
            ref = references.get(name, single)
            if ref is None:
                continue
            row = accuracy_metrics(name, seq, name if single is None else
                                   list(references)[0], ref,
                                   min_coverage=min_coverage)
        if row is not None:
            rows.append(row)
    return rows


def _best_contig_metrics(name, seq, references, min_coverage=0.6):
    """Genome mode: align ``seq`` against every contig, return the metric
    row of the best-scoring one (highest information content = match count
    weighted by per-base bits — the bwa best-hit analogue)."""
    best = None
    for ref_name, ref in references.items():
        row = accuracy_metrics(name, seq, ref_name, ref,
                               min_coverage=min_coverage)
        if row is not None and (best is None or
                                row['information'] > best['information']):
            best = row
    return best


def summary(acc_dat, data_set_name):
    """Summary report string (reference align.py:156-207;
    sloika_tpu/align.py:262)."""
    if len(acc_dat) == 0:
        return ("*** Summary report for {} ***\n"
                "No sequences mapped\n").format(data_set_name)

    acc = np.array([r['accuracy'] for r in acc_dat])
    ciscore = np.array([r['information'] for r in acc_dat])
    mean = acc.mean()
    mode = _kde_mode(acc)

    qstring1 = ''.join('{:<11}'.format('Q' + str(q))
                       for q in QUANTILES).strip()
    qstring2 = '    '.join('{:.5f}'.format(v)
                           for v in np.percentile(acc, QUANTILES))
    a90 = (acc > 0.9).mean()
    n_gt_90 = int((acc > 0.9).sum())
    nmapped = len({r['query'] for r in acc_dat})

    return """*** Summary report for {} ***
Number of mapped reads:  {}
Mean accuracy:  {:.5f}
Mode accuracy:  {:.5f}
Accuracy quantiles:
  {}
  {}
Proportion with accuracy >90%:  {:.5f}
Number with accuracy >90%:  {}
CIscore (Mbits): {:.5f}
""".format(data_set_name, nmapped, mean, mode, qstring1, qstring2, a90,
           n_gt_90, float(np.sum(ciscore)) / 1e6)


def _kde_mode(acc):
    """Mode of the accuracy distribution via Gaussian KDE
    (align.py:173-185)."""
    if len(acc) <= 1 or np.ptp(acc) < 1e-12:
        return float(acc[0])
    try:
        from scipy.stats import gaussian_kde
        from scipy.optimize import minimize_scalar
        da = gaussian_kde(acc)
        res = minimize_scalar(lambda x: -da(x)[0], bounds=(0, 1),
                              method='Bounded')
        if res.success:
            return float(np.atleast_1d(res.x)[0])
    except Exception as e:
        sys.stderr.write("Mode computation failed: {!r}\n".format(e))
    return float(np.median(acc))


def acc_plot(acc, mode, fill=True, title=''):
    """Accuracy histogram over the 0.65-1.0 operating band with the KDE
    mode marked (reference align.py:136-154).

    :returns: (figure, axes)
    """
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    f = plt.figure()
    ax = f.add_subplot(111)
    ax.hist(acc, bins=np.arange(0.65, 1.0, 0.01), fill=fill)
    ax.set_xlim(0.65, 1)
    _, ymax = ax.get_ylim()
    ax.plot([mode, mode], [0, ymax], 'r--')
    ax.set_xlabel('Accuracy')
    ax.set_ylabel('Frequency')
    ax.set_title(title)
    return f, ax


def save_acc_plot(path, rows, fill=True, title=''):
    """Write the accuracy histogram for metric rows to ``path``."""
    acc = np.array([r['accuracy'] for r in rows])
    if len(acc) == 0:
        return False
    f, _ = acc_plot(acc, _kde_mode(acc), fill=fill, title=title)
    f.savefig(path, bbox_inches='tight')
    import matplotlib.pyplot as plt
    plt.close(f)
    return True


def write_samacc(path, rows):
    """Write per-read metric rows as the reference's .samacc space-separated
    table (sloika_tpu/align.py:346)."""
    if not rows:
        return
    fields = list(rows[0].keys())
    with open(path, 'w') as fh:
        fh.write(' '.join(fields) + '\n')
        for row in rows:
            fh.write(' '.join(str(row[f]) for f in fields) + '\n')
