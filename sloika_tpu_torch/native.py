"""ctypes bindings of the port's host C++ aligner (``csrc/sloika_native.cpp``;
cf. ``sloika_tpu/native.py``).

:func:`align_semiglobal` is the banded affine aligner that scores basecalls
in :mod:`sloika_tpu_torch.align`.  The library is built with ``g++`` at
first use into ``_build/libsloika_native.so`` (git-ignored), and rebuilt
when the source is newer.  Without a compiler the aligner's numpy form
runs, as in the JAX package; :func:`available` says which.
"""
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "sloika_native.cpp")
_LIB = os.path.join(_HERE, "_build", "libsloika_native.so")

_lib = None


def _build():
    """Compile the library into a temporary file and move it into place, so
    processes building at once never load a half-written one."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_LIB))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        _SRC, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    """The loaded library, or False where it cannot be built (once a
    process; cf. ``sloika_tpu/native.py:28``)."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB) or \
            os.path.getmtime(_SRC) > os.path.getmtime(_LIB):
        try:
            _build()
        except (OSError, subprocess.CalledProcessError) as e:
            sys.stderr.write("sloika_tpu_torch.native: build failed ({}); "
                             "using numpy fallbacks\n".format(e))
            _lib = False
            return _lib
    lib = ctypes.CDLL(_LIB)
    lib.align_semiglobal.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.align_semiglobal.restype = ctypes.c_int
    _lib = lib
    return _lib


def available():
    """True where the C++ library is built and loaded (else the numpy
    fallbacks run)."""
    return bool(_load())


class Alignment(object):
    """Result of a semi-global alignment (sloika_tpu/native.py:71)."""

    __slots__ = ("score", "match", "mismatch", "insertion", "deletion",
                 "qstart", "qend", "rstart", "rend")

    def __init__(self, out):
        (self.score, self.match, self.mismatch, self.insertion,
         self.deletion, self.qstart, self.qend, self.rstart,
         self.rend) = (int(v) for v in out)

    @property
    def alnlen(self):
        return self.match + self.mismatch + self.insertion + self.deletion

    @property
    def accuracy(self):
        return self.match / max(self.alnlen, 1)

    @property
    def identity(self):
        return self.match / max(self.match + self.mismatch, 1)


def default_band(qlen, rlen):
    """Default band half-width, the C++ kernel's own default
    (csrc/sloika_native.cpp, ``align_semiglobal``)."""
    return max(128, max(qlen, rlen) // 10 + abs(qlen - rlen))


def widen_cap(qlen, rlen):
    """Half-width cap of the auto-widen loop: the full width (exact), bounded
    so the traceback (~6 b (qlen+1) bytes) stays under ~1.6 GB
    (sloika_tpu/native.py:106)."""
    return min(max(qlen, rlen), max(256, (1 << 28) // (qlen + 1)))


def align_semiglobal(query, ref, match=2, mismatch=-2, gap_open=-4,
                     gap_extend=-2, band=None, auto_widen=False):
    """Banded affine-gap alignment; the query aligns globally, the reference
    has free end gaps.  Returns :class:`Alignment` or None on failure
    (sloika_tpu/native.py:114-165).

    ``auto_widen`` (the accuracy evaluator's band policy): a band centred on
    the length-scaled diagonal can clip the true optimum where the
    alignment wanders, so the result is re-aligned at doubled widths until
    its score has held over two doublings, up to :func:`widen_cap`; a result
    still moving at the cap is returned as it is.  The numpy fallback is
    unbanded and is not re-run.
    """
    if isinstance(query, str):
        query = query.encode("ascii")
    if isinstance(ref, str):
        ref = ref.encode("ascii")
    aln = _align_banded(query, ref, match, mismatch, gap_open, gap_extend,
                        band if band else 0)
    if not auto_widen or not _load():
        return aln
    b = band if band else default_band(len(query), len(ref))
    cap = widen_cap(len(query), len(ref))
    stable = 0
    while b < cap and stable < 2:
        b = min(2 * b, cap)
        wider = _align_banded(query, ref, match, mismatch, gap_open,
                              gap_extend, b)
        same = (wider is None and aln is None) or (
            wider is not None and aln is not None
            and wider.score == aln.score)
        stable = stable + 1 if same else 0
        aln = wider
    return aln


def _align_banded(query, ref, match, mismatch, gap_open, gap_extend, band):
    lib = _load()
    if not lib:
        return _align_numpy(query, ref, match, mismatch, gap_open, gap_extend)
    out = (ctypes.c_int64 * 9)()
    rc = lib.align_semiglobal(query, len(query), ref, len(ref),
                              match, mismatch, gap_open, gap_extend,
                              band, out)
    if rc != 0:
        return None
    return Alignment(list(out))


def _align_numpy(query, ref, match, mismatch, gap_open, gap_extend):
    """The numpy fallback (sloika_tpu/native.py:179): unbanded, with LINEAR
    gaps (gap_open + gap_extend a base), so its scores and indel counts can
    differ from the C++ kernel's; refused past 4 Mi cells."""
    q = np.frombuffer(query, dtype=np.uint8)
    r = np.frombuffer(ref, dtype=np.uint8)
    n, m = len(q), len(r)
    if n * m > 4 << 20:
        raise RuntimeError(
            "native aligner unavailable and sequences too large ({} x {}) "
            "for the numpy fallback".format(n, m))
    gap = gap_open + gap_extend
    score = np.zeros((n + 1, m + 1), dtype=np.int32)
    ptr = np.zeros((n + 1, m + 1), dtype=np.uint8)
    score[1:, 0] = np.arange(1, n + 1) * gap
    ptr[1:, 0] = 2
    for i in range(1, n + 1):
        sub = score[i - 1, :-1] + np.where(r == q[i - 1], match, mismatch)
        up = score[i - 1, 1:] + gap
        best = np.maximum(sub, up)
        p = np.where(sub >= up, 1, 2)
        # left moves need a sequential pass
        row = score[i]
        row[1:] = best
        for j in range(1, m + 1):
            left = row[j - 1] + gap
            if left > row[j]:
                row[j] = left
                p[j - 1] = 3
        ptr[i, 1:] = p
    j = int(np.argmax(score[n]))
    i = n
    out = [int(score[n, j]), 0, 0, 0, 0, 0, n, 0, j]
    while i > 0:
        op = ptr[i, j]
        if op == 1:
            out[1 if q[i - 1] == r[j - 1] else 2] += 1
            i, j = i - 1, j - 1
        elif op == 2:
            out[3] += 1
            i -= 1
        else:
            out[4] += 1
            j -= 1
    out[7] = j
    return Alignment(out)
