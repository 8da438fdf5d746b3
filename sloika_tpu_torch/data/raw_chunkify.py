"""Raw-signal chunking and labelling of remapped reads, copied from
``sloika_tpu/data/raw_chunkify.py`` (numpy; that module imports jax through
``data/batching.py``).  Only what ``raw_remap`` and ``raw_identity`` call
is copied."""
import numpy as np

from sloika_tpu_torch import maths
from sloika_tpu_torch.data.batching import (AVAILABLE_NORMALISATIONS,
                                            kmer_array_to_states)
from sloika_tpu_torch.variables import DEFAULT_ALPHABET


def convert_mapping_times_to_samples(mapping_table, start_sample,
                                     sample_rate):
    """Replace time coordinates (seconds) with raw-signal sample indices
    (copied from sloika_tpu/data/raw_chunkify.py:14).  Raises where the
    mapped blocks are not contiguous."""
    new_field_types = {'start': '<i8', 'length': '<i8'}
    # dtype[name].str (not .descr) strips h5py's metadata wrappers
    new_dtype = [(name, new_field_types.get(name,
                                            mapping_table.dtype[name].str))
                 for name in mapping_table.dtype.names]

    if not np.allclose(mapping_table['start'][:-1]
                       + mapping_table['length'][:-1],
                       mapping_table['start'][1:]):
        raise ValueError("mapping table blocks are not contiguous in time")

    starts = np.around(mapping_table['start'] * sample_rate
                       - start_sample).astype(int)
    lengths = np.around(mapping_table['length'] * sample_rate).astype(int)
    if not np.all(starts[:-1] + lengths[:-1] == starts[1:]):
        raise ValueError("mapping table blocks are not contiguous in "
                         "samples")

    new_mapping_table = mapping_table.copy().astype(new_dtype)
    new_mapping_table['start'] = starts
    new_mapping_table['length'] = lengths
    return new_mapping_table


def trim_signal_and_mapping(signal, mapping_table, start_sample, end_sample):
    """Trim samples and mapped blocks outside [start_sample, end_sample)
    (sloika_tpu/data/raw_chunkify.py:35)."""
    sig_trim = signal[start_sample:end_sample]
    end_sample = start_sample + len(sig_trim)

    ix = np.arange(len(mapping_table))
    lb = int(ix[mapping_table['start'] > start_sample].min()) - 1
    ub = int(ix[mapping_table['start'] < end_sample].max()) + 1
    new_mapping_table = mapping_table[lb:ub].copy()

    new_mapping_table['start'] -= start_sample
    new_mapping_table['start'][0] = 0
    new_mapping_table['length'][0] = new_mapping_table['start'][1]
    new_mapping_table['length'][-1] = (len(sig_trim)
                                       - new_mapping_table['start'][-1])
    return sig_trim, new_mapping_table


def mapping_table_is_registered(mapped_signal, mapping_table):
    """Signal and mapping table cover the same contiguous sample range
    (sloika_tpu/data/raw_chunkify.py:52)."""
    return all([
        mapping_table['start'][0] == 0,
        mapping_table['start'][-1] + mapping_table['length'][-1]
        == len(mapped_signal),
        (mapping_table['start'] >= 0).all(),
        (mapping_table['start'] < len(mapped_signal)).all(),
        (mapping_table['start'][:-1] + mapping_table['length'][:-1]
         == mapping_table['start'][1:]).all(),
    ])


def interpolate_pos(mapping_table, att):
    """time -> reference position, by interpolating the mapping
    (sloika_tpu/data/raw_chunkify.py:64)."""
    def interp(t, k=5):
        EPS = 10 ** -10  # avoid round-to-even
        ev_mid = mapping_table['start'] + 0.5 * mapping_table['length']
        map_k = len(mapping_table['kmer'][0])
        if att['direction'] == "+":
            map_ref_pos = (mapping_table['seq_pos'] + 0.5 * map_k
                           - att['ref_start'])
        else:
            map_ref_pos = (att['ref_stop'] - mapping_table['seq_pos']
                           + 0.5 * map_k)
        pos_interp = np.interp(t, ev_mid, map_ref_pos)
        return np.around(pos_interp - 0.5 * k + EPS).astype(np.int64)
    return interp


def interpolate_labels(mapping_table, att, alphabet=DEFAULT_ALPHABET):
    """time -> kmer label, by interpolating the mapping
    (sloika_tpu/data/raw_chunkify.py:79)."""
    if isinstance(alphabet, str):
        alphabet = alphabet.encode('utf-8')
    lut = np.full(256, -1, dtype=np.int64)
    for i, b in enumerate(alphabet):
        lut[b] = i
    nbase = len(alphabet)
    ref = att['reference']
    if isinstance(ref, str):
        ref = ref.encode('utf-8')
    ref_codes = lut[np.frombuffer(ref, dtype=np.uint8)]

    def interp(t, k=5):
        pos = interpolate_pos(mapping_table, att)(t, k)
        if len(pos) and (pos.min() < 0 or pos.max() + k > len(ref_codes)):
            raise ValueError(
                "interpolated positions [{}, {}] fall outside the {}-base "
                "reference".format(int(pos.min()), int(pos.max()) + k,
                                   len(ref_codes)))
        idx = pos[:, None] + np.arange(k)[None, :]
        codes = ref_codes[idx]
        if np.any(codes < 0):
            raise ValueError("reference contains letters outside the "
                             "alphabet at interpolated positions")
        powers = nbase ** np.arange(k - 1, -1, -1, dtype=np.int64)
        return ((codes * powers).sum(axis=1) + 1).astype(np.int64)
    return interp


def replace_repeats_with_zero(arr):
    """Replace repeated elements in a 1d array with 0
    (sloika_tpu/data/raw_chunkify.py:121)."""
    arr[np.ediff1d(arr, to_begin=1) == 0] = 0
    return arr


def fill_zeros_with_prev(arr):
    """Fill non-leading zero values with the previous non-zero value
    (sloika_tpu/data/raw_chunkify.py:127)."""
    ix = np.arange(len(arr)) * (arr != 0)
    return arr[np.maximum.accumulate(ix)]


def index_of_previous_non_zero(input_array):
    """output[i] = index of the last non-zero element in input[:i+1]
    (sloika_tpu/data/raw_chunkify.py:133)."""
    ix = np.arange(len(input_array)) * (input_array > 0)
    return np.maximum.accumulate(ix)


def raw_chunkify(signal, mapping_table, chunk_len, kmer_len, normalisation,
                 downsample_factor, interpolation, mapping_attrs=None,
                 alphabet=DEFAULT_ALPHABET):
    """Labelled chunks from a raw signal and its mapping table
    (sloika_tpu/data/raw_chunkify.py:139).

    :returns: (chunks (N, chunk_len, 1), labels (N, chunk_len //
        downsample_factor) i32, bad (N, chunk_len) bool)
    """
    if len(signal) < chunk_len:
        raise ValueError("signal of {} samples is shorter than a chunk"
                         .format(len(signal)))
    if normalisation not in AVAILABLE_NORMALISATIONS:
        raise ValueError("unknown normalisation {!r}".format(normalisation))
    if not mapping_table_is_registered(signal, mapping_table):
        raise ValueError("signal and mapping table are not registered")

    ml = len(signal) // chunk_len
    ub = ml * chunk_len
    signal, mapping_table = trim_signal_and_mapping(signal, mapping_table, 0,
                                                    ub)
    if not mapping_table_is_registered(signal, mapping_table):
        raise ValueError("trimmed signal and mapping table are not "
                         "registered")
    new_inMat = signal.reshape((ml, chunk_len, 1)).astype(np.float32)

    if normalisation == "per-chunk":
        chunk_medians = np.median(new_inMat, axis=1, keepdims=True)
        chunk_mads = maths.mad(new_inMat, axis=1, keepdims=True)
        new_inMat = (new_inMat - chunk_medians) / chunk_mads
    elif normalisation == "per-read":
        new_inMat = (new_inMat - np.median(new_inMat)) / maths.mad(new_inMat)

    if interpolation:
        block_midpoints = np.arange(0, ub, downsample_factor)
        pos = interpolate_pos(mapping_table, mapping_attrs)(block_midpoints,
                                                            kmer_len)
        sig_labels = interpolate_labels(mapping_table, mapping_attrs,
                                        alphabet)(block_midpoints, kmer_len)
        sig_labels[np.ediff1d(pos, to_begin=1) == 0] = 0
        sig_labels = sig_labels.reshape((ml, -1)).astype('i4')
    else:
        all_labels = kmer_array_to_states(mapping_table['kmer'], kmer_len,
                                          alphabet=alphabet, index_from=1)
        labels = all_labels[mapping_table['move'] > 0]
        all_starts = mapping_table['start'][
            index_of_previous_non_zero(mapping_table['move'])]
        starts = all_starts[mapping_table['move'] > 0]

        idx = np.zeros(ub, dtype=np.int64)
        idx[starts] = np.arange(len(labels)) + 1
        idx = fill_zeros_with_prev(idx)
        idx = idx.reshape((ml, chunk_len))[:, ::downsample_factor]
        idx = np.apply_along_axis(replace_repeats_with_zero, 1, idx)

        sig_labels = np.concatenate([[0], labels])[idx].astype('i4')

    # bad state isn't defined for raw models
    sig_bad = np.zeros((ml, chunk_len), dtype=bool)
    return new_inMat, sig_labels, sig_bad
