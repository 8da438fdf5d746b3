"""Raw-signal preparation and event chunking shared by basecalling and
chunkify, copied from ``sloika_tpu/data/batching.py`` (whose module imports
jax)."""
import numpy as np

from sloika_tpu_torch import maths, util
from sloika_tpu_torch.config import sloika_dtype
from sloika_tpu_torch.variables import DEFAULT_ALPHABET

AVAILABLE_NORMALISATIONS = frozenset(['none', 'per-read', 'per-chunk'])


def kmer_array_to_states(kmer_array, kmer_len, alphabet=DEFAULT_ALPHABET,
                         index_from=0):
    """Centre ``kmer_len``-mer of each (longer) kmer in ``kmer_array`` as a
    lexicographic state index (copied from sloika_tpu/data/batching.py:20).
    """
    kmer_array = np.ascontiguousarray(kmer_array)
    if kmer_array.dtype.kind == 'U':
        # a unicode array viewed as raw bytes is UTF-32: re-encode so the
        # byte lookup below sees one byte per letter
        kmer_array = kmer_array.astype('S')
    itemsize = kmer_array.dtype.itemsize
    old_len = len(kmer_array.flat[0])
    if kmer_len > old_len:
        raise ValueError("kmer_len {} exceeds the kmers' length {}".format(
            kmer_len, old_len))
    offset = (old_len - kmer_len + 1) // 2

    if isinstance(alphabet, str):
        alphabet = alphabet.encode('utf-8')
    lut = np.full(256, -1, dtype=np.int64)
    for i, b in enumerate(alphabet):
        lut[b] = i
    nbase = len(alphabet)

    flat = kmer_array.reshape(-1)
    a = np.frombuffer(flat.tobytes(), dtype=np.uint8).reshape(len(flat),
                                                              itemsize)
    codes = lut[a[:, offset:offset + kmer_len]]
    if np.any(codes < 0):
        raise ValueError("kmer array contains letters outside alphabet")
    powers = nbase ** np.arange(kmer_len - 1, -1, -1, dtype=np.int64)
    states = (codes * powers).sum(axis=1) + index_from
    return states.reshape(kmer_array.shape).astype(np.int32)


def trim_ends_and_filter(ev, trim, min_length, chunk_len):
    """Trim events from both ends; None if the read is then too short
    (copied from sloika_tpu/data/batching.py:56)."""
    if len(ev) < sum(trim) + chunk_len or len(ev) < min_length:
        return None
    return util.trim_array(ev, *trim)


def chunkify(ev, chunk_len, kmer_len, use_scaled, normalisation,
             alphabet=DEFAULT_ALPHABET):
    """Chunk a mapped event table into fixed windows with labels (copied
    from sloika_tpu/data/batching.py:63).

    :param ev: record array with mean/stdv/length(/scaled_*) features plus
        mapping fields kmer, seq_pos, good_emission
    :returns: (chunks (N, chunk_len, 4) f32, labels (N, chunk_len) i32 with
        0 = stay, bad (N, chunk_len) bool)
    """
    from sloika_tpu_torch.data import features
    if len(ev) < chunk_len:
        raise ValueError("{} events are fewer than a chunk of {}".format(
            len(ev), chunk_len))
    ml = len(ev) // chunk_len
    ub = ml * chunk_len
    tag = 'scaled_' if use_scaled else ''

    if normalisation == 'per-chunk':
        mats = []
        for ci in range(ml):
            lo = ci * chunk_len
            hi = lo + chunk_len
            # one event of padding so the delta-mean feature is defined
            hi_pad = min(hi + 1, len(ev))
            feat = features.from_events(ev[lo:hi_pad], tag=tag,
                                        normalise=True)
            mats.append(feat[:chunk_len])
        new_inMat = np.concatenate(mats)
    else:
        if normalisation not in ('none', 'per-read'):
            raise ValueError("unknown normalisation {!r}".format(
                normalisation))
        new_inMat = features.from_events(
            ev, tag=tag, normalise=normalisation == 'per-read')
        new_inMat = new_inMat[0:ub]

    new_inMat = new_inMat.reshape((ml, chunk_len, -1))
    ev = ev[0:ub]

    new_labels = kmer_array_to_states(ev['kmer'], kmer_len, alphabet=alphabet,
                                      index_from=1)
    new_labels = new_labels.reshape(ml, chunk_len)
    change = ev['seq_pos'].reshape(ml, chunk_len)
    change = np.apply_along_axis(np.ediff1d, 1, change, to_begin=1)
    new_labels[change == 0] = 0  # stays get the blank label

    new_bad = np.logical_not(ev['good_emission']).reshape(ml, chunk_len)

    return (np.ascontiguousarray(new_inMat),
            np.ascontiguousarray(new_labels),
            np.ascontiguousarray(new_bad))


def trim_open_pore(signal, max_op_fraction=0.3, window_size=100):
    """(start, end) of the read within a raw signal, found by thresholding
    the local MAD: open-pore stretches vary little (copied from
    sloika_tpu/data/batching.py:111, its ``var_method='mad'``,
    ``return_range=True`` form)."""
    ml = len(signal) // window_size
    ub = ml * window_size
    local_var = maths.mad(signal[:ub].reshape((ml, window_size)), axis=1)
    probably_read = local_var > np.percentile(local_var, 100 * max_op_fraction)
    ix = np.arange(local_var.shape[0])[probably_read]
    return ix.min() * window_size, (ix.max() + 1) * window_size


def normalise_raw_signal(signal):
    """Per-read (median, MAD) normalisation (copied from
    sloika_tpu/data/batching.py:136)."""
    return ((signal - np.median(signal)) / maths.mad(signal)).astype(
        sloika_dtype)
