"""TSV strand-list reading, copied from ``sloika_tpu/data/fileio.py``
(tab-separated files with a header row, gz/bz2 decompressed transparently)."""
import numpy as np


def _open(fname, mode='rt'):
    """(sloika_tpu/data/fileio.py:15)"""
    if fname.endswith('.gz'):
        import gzip
        return gzip.open(fname, mode)
    if fname.endswith('.bz2'):
        import bz2
        return bz2.open(fname, mode)
    return open(fname, mode)


def file_has_fields(fname, fields=None):
    """Check that a tsv file's header contains the given fields
    (sloika_tpu/data/fileio.py:30)."""
    if fields is None:
        return True
    if isinstance(fields, str):
        fields = [fields]
    if len(fields) == 0:
        return True
    with _open(fname) as fh:
        header = fh.readline().strip().split('\t')
    return all(f in header for f in fields)


def readtsv(fname, fields=None, **kwargs):
    """Read a tsv file into a structured array, checking required fields
    (sloika_tpu/data/fileio.py:43)."""
    if not file_has_fields(fname, fields):
        raise KeyError('File {} does not contain requested required fields {}'
                       .format(fname, fields))
    for k in ['names', 'delimiter', 'dtype']:
        kwargs.pop(k, None)
    with _open(fname) as fh:
        table = np.genfromtxt(fh, names=True, delimiter='\t', dtype=None,
                              encoding=None, **kwargs)
    return table.reshape(-1)
