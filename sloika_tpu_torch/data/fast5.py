"""The parts of the single-read fast5 reader that the port uses, copied from
``sloika_tpu/data/fast5.py``.  That module imports h5py at the top; here
h5py is imported inside the readers (:func:`read_raw_signal`,
:func:`read_section_events`, :func:`read_reference_fasta`,
:func:`get_any_mapping_data`, :func:`sample_rate`,
:func:`raw_start_sample`), so the port imports on a machine without it."""
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


def sample_rate(path):
    """The channel's sampling rate (``Fast5.sample_rate``,
    sloika_tpu/data/fast5.py:48)."""
    import h5py
    with h5py.File(path, "r") as h5:
        return float(h5["UniqueGlobalKey/channel_id"].attrs["sampling_rate"])


def raw_start_sample(path):
    """The first read's start time in samples (``Fast5.raw_start_sample``,
    sloika_tpu/data/fast5.py:81)."""
    import h5py
    with h5py.File(path, "r") as h5:
        reads = h5["Raw/Reads"]
        return int(reads[sorted(reads.keys())[0]].attrs["start_time"])


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


def _to_str(x):
    """(sloika_tpu/data/fast5.py:181)"""
    return x.decode("utf-8") if isinstance(x, bytes) else str(x)


def get_any_mapping_data(path, section="template"):
    """Mapping table (events aligned to a reference) and its attributes,
    from the latest AlignToRef analysis that holds one
    (``Fast5.get_any_mapping_data``, sloika_tpu/data/fast5.py:127-168).
    A table without a ``move`` column gets one, the ``seq_pos`` steps;
    ``seq_pos`` indexes the per-read reference, so ``ref_start`` and
    ``ref_stop`` are read-local.

    :returns: (mapping_table, attrs) with attrs keys direction, ref_start,
        ref_stop, genome_start, genome_end, reference
    """
    import h5py
    ev_rel = "CurrentSpaceMapped_{}/Events".format(section)
    with h5py.File(path, "r") as h5:
        grp = _latest(h5, "AlignToRef", contains=ev_rel)
        if grp is None:
            raise ValueError("No mapping data in {}".format(path))
        ev = h5["{}/{}".format(grp, ev_rel)][:]
        summ = "{}/Summary/current_space_map_{}".format(grp, section)
        a = dict(h5[summ].attrs) if summ in h5 else {}
    if ev.dtype.names and 'move' not in ev.dtype.names:
        import numpy.lib.recfunctions as nprf
        move = np.ediff1d(ev['seq_pos'], to_begin=1)
        if len(move) > 1 and np.all(move[1:] <= 0):
            raise ValueError(
                "mapping table seq_pos is non-increasing in {} — "
                "unsupported coordinate layout".format(path))
        ev = nprf.append_fields(ev, 'move', move, usemask=False)
    reference = read_reference_fasta(path, section=section)
    attrs = {
        "direction": _to_str(a.get("direction", "+")),
        "ref_start": 0,
        "ref_stop": len(reference),
        "genome_start": int(a.get("genome_start", 0)),
        "genome_end": int(a.get("genome_end", 0)),
        "reference": reference,
    }
    return ev, attrs


def read_reference_fasta(path, section="template"):
    """The read's reference sequence (bytes), from the latest Alignment
    analysis that holds one (``Fast5.get_reference_fasta``,
    sloika_tpu/data/fast5.py:170)."""
    import h5py
    rel = "Aligned_{}/Fasta".format(section)
    with h5py.File(path, "r") as h5:
        grp = _latest(h5, "Alignment", contains=rel)
        if grp is None:
            raise ValueError("No reference fasta in {}".format(path))
        fasta = h5["{}/{}".format(grp, rel)][()]
    if isinstance(fasta, bytes):
        fasta = fasta.decode("utf-8")
    return "".join(l.strip() for l in str(fasta).split("\n")[1:]).encode(
        "utf-8")


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
