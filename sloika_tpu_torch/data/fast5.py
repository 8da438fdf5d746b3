"""The parts of the single-read fast5 reader that the port uses, copied from
``sloika_tpu/data/fast5.py``.  That module imports h5py at the top; here
h5py is imported inside :func:`read_raw_signal`, so the port imports on a
machine without it."""
import glob
import os

import numpy as np


def filename_short(path):
    """Read name: the file name without directory and extension
    (sloika_tpu/data/fast5.py:44)."""
    return os.path.splitext(os.path.basename(path))[0]


def read_raw_signal(path):
    """Raw signal of the file's first read scaled to pA, as float32
    (``Fast5.get_read(raw=True)``, sloika_tpu/data/fast5.py:62)."""
    import h5py
    with h5py.File(path, "r") as h5:
        reads = h5["Raw/Reads"]
        sig = reads[sorted(reads.keys())[0]]["Signal"][:]
        meta = dict(h5["UniqueGlobalKey/channel_id"].attrs)
    sig = (sig + meta["offset"]) * meta["range"] / meta["digitisation"]
    return sig.astype(np.float32)


def iterate_fast5(path, strand_list=None, limit=None):
    """fast5 file paths under a directory, optionally restricted to the
    'filename' column of a strand list (sloika_tpu/data/fast5.py:193)."""
    if os.path.isfile(path):
        files = [path]
    else:
        files = sorted(glob.glob(os.path.join(path, "*.fast5")))
    if strand_list is not None:
        from sloika_tpu_torch.data import fileio
        tsv = fileio.readtsv(strand_list)
        col = "filename" if "filename" in tsv.dtype.names \
            else tsv.dtype.names[0]
        wanted = {os.path.basename(f.decode() if isinstance(f, bytes)
                                   else str(f)) for f in tsv[col]}
        files = [f for f in files if os.path.basename(f) in wanted]
    return files[:limit] if limit is not None else files
