"""Minimal text SAM parsing, copied from ``sloika_tpu/data/sam.py``.

In place of the pysam dependency of the reference's evaluation utilities
(misc/align.py:91-133, misc/get_refs_from_sam.py:40-68): the record fields
those tools read (flag, reference, position, CIGAR-derived spans, tags).
"""
import re

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")

# ops that consume query / reference
_CONSUMES_QUERY = set("MIS=X")
_CONSUMES_REF = set("MDN=X")


class SamRecord(object):
    __slots__ = ("qname", "flag", "rname", "pos", "mapq", "cigar", "seq",
                 "tags")

    def __init__(self, fields):
        self.qname = fields[0]
        self.flag = int(fields[1])
        self.rname = fields[2]
        self.pos = int(fields[3]) - 1          # 0-based
        self.mapq = int(fields[4])
        self.cigar = _CIGAR_RE.findall(fields[5]) if fields[5] != "*" else []
        self.seq = fields[9]
        self.tags = {}
        for f in fields[11:]:
            name, typ, val = f.split(":", 2)
            if typ == "i":
                val = int(val)
            elif typ == "f":
                val = float(val)
            self.tags[name] = val

    # -- derived quantities (pysam-compatible names) ----------------------

    @property
    def query_length(self):
        n = sum(int(c) for c, op in self.cigar if op in "MIS=X")
        return n if n else len(self.seq)

    @property
    def query_alignment_start(self):
        if self.cigar and self.cigar[0][1] in "SH":
            return int(self.cigar[0][0])
        return 0

    @property
    def query_alignment_end(self):
        end = self.query_length
        if self.cigar and self.cigar[-1][1] in "SH":
            end -= int(self.cigar[-1][0])
        return end

    @property
    def query_alignment_length(self):
        return self.query_alignment_end - self.query_alignment_start

    @property
    def reference_start(self):
        return self.pos

    @property
    def reference_end(self):
        return self.pos + sum(int(c) for c, op in self.cigar
                              if op in _CONSUMES_REF)

    def cigar_bins(self):
        """Counts per CIGAR op code (M=0, I=1, D=2, ... as in pysam)."""
        order = "MIDNSHP=X"
        bins = [0] * 9
        for c, op in self.cigar:
            bins[order.index(op)] += int(c)
        return bins


def read_sam(path_or_fh):
    """Yield a :class:`SamRecord` for each alignment line of a SAM file or
    stream; header lines (``@``) and short lines are skipped."""
    fh = open(path_or_fh) if isinstance(path_or_fh, str) else path_or_fh
    try:
        for line in fh:
            if not line.strip():
                continue
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                continue
            yield SamRecord(fields)
    finally:
        if isinstance(path_or_fh, str):
            fh.close()
