"""The parts of the single-read fast5 reader that the port uses, copied from
``sloika_tpu/data/fast5.py``.  That module imports h5py at the top; here
h5py is imported inside :func:`read_raw_signal` and
:func:`read_section_events`, so the port imports on a machine without it."""
import glob
import os
import re

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


def _latest(h5, base, contains=None):
    """Latest ``Analyses/<base>_NNN`` group name of an open file, or None
    (``Fast5._latest``, sloika_tpu/data/fast5.py:86-106).

    :param contains: relative path that must exist inside the group
    """
    if "Analyses" not in h5:
        return None
    pat = re.compile(re.escape(base) + r"_(\d+)$")
    best, best_n = None, -1
    for name in h5["Analyses"]:
        m = pat.match(name)
        if m is None or int(m.group(1)) <= best_n:
            continue
        path = "Analyses/" + name
        if contains is not None and \
                "{}/{}".format(path, contains) not in h5:
            continue
        best, best_n = path, int(m.group(1))
    return best


def read_section_events(path, section="template"):
    """Event table of a read section, from the latest Basecall_1D analysis,
    else the latest Basecall_2D (``Fast5.get_section_events``,
    sloika_tpu/data/fast5.py:108-122).  Events have at least
    mean/stdv/start/length."""
    import h5py
    with h5py.File(path, "r") as h5:
        for base in ("Basecall_1D", "Basecall_2D"):
            grp = _latest(h5, base)
            if grp is None:
                continue
            events = "{}/BaseCalled_{}/Events".format(grp, section)
            if events in h5:
                return h5[events][:]
    raise ValueError("No events for section {!r} in {}".format(section, path))


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
