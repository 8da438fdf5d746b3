"""The comparisons that decide ``correct``: how far the program's answers
lie from the plain reference's, as numbers that each have a limit."""
import numpy as np


def score_gap(got, want):
    """The widest relative gap between the program's scores and the
    reference's."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                         1e-30)))


def edit_distance(a, b):
    """Levenshtein distance between two code sequences: the bit-parallel
    recurrence of Myers (1999) in Hyyro's form, one column of ``b`` a step
    over ``a``'s bits, after the common prefix and suffix are set aside."""
    a, b = np.asarray(a).tolist(), np.asarray(b).tolist()
    lo = 0
    while lo < min(len(a), len(b)) and a[lo] == b[lo]:
        lo += 1
    hi = 0
    while hi < min(len(a), len(b)) - lo and a[-1 - hi] == b[-1 - hi]:
        hi += 1
    a, b = a[lo:len(a) - hi], b[lo:len(b) - hi]
    m = len(a)
    if m == 0 or not b:
        return max(m, len(b))
    full = (1 << m) - 1
    top = 1 << (m - 1)
    peq = {}
    for i, c in enumerate(a):
        peq[c] = peq.get(c, 0) | (1 << i)
    pv, mv, dist = full, 0, m
    for c in b:
        eq = peq.get(c, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & full)
        mh = pv & xh
        if ph & top:
            dist += 1
        elif mh & top:
            dist -= 1
        ph = ((ph << 1) | 1) & full
        mh = (mh << 1) & full
        pv = mh | (~(xv | ph) & full)
        mv = ph & xv
    return dist


def base_error(got, want):
    """The program's calls' edit distance from the reference's, summed over
    the compared reads, over the reference's bases summed."""
    edits = sum(edit_distance(g, w) for g, w in zip(got, want))
    return edits / max(sum(len(w) for w in want), 1)


def leaf_norm_gap(got, want, scale=None):
    """The widest gap between the norm of a leaf of ``got`` and of the
    same leaf of ``want``, each over the larger of that leaf's norm in
    ``want`` and the median leaf's ({name: tensor}; leaves not in ``got``
    are left out)."""
    wn = {k: float(v.double().norm()) for k, v in want.items()}
    med = float(np.median(list(wn.values())))
    gaps = [abs(float(got[k].double().norm()) - wn[k]) / max(wn[k], med,
                                                             1e-30)
            for k in got]
    return max(gaps)


def judge(checks):
    """(correct, checks in the result line's form) of [(name, value,
    limit)]: each value at or under its limit."""
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in checks)
    return ok, {n: {"value": v, "limit": lim} for n, v, lim in checks}
