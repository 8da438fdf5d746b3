"""Labelled-chunk HDF5 batch files (cf. ``sloika_tpu/data/hdf5.py``, whose
module imports h5py at the top; here it is imported inside the reader and
the writer, so the port imports on a machine without h5py)."""
import numpy as np

from sloika_tpu_torch import util


def create_labelled_chunks_hdf5(output, blanks, attributes, chunk_list,
                                label_list, bad_list):
    """Write chunk/label/bad lists into a labelled-chunks HDF5 file (copied
    from ``sloika_tpu/data/hdf5.py:14``): gzip'd datasets ``bad`` (i1),
    ``chunks`` (f4), ``labels`` (i4), ``weights`` (f4) and root attributes.
    Chunks whose blank fraction reaches ``blanks`` get zero weight."""
    import h5py
    if not len(chunk_list) == len(label_list) == len(bad_list) > 0:
        raise ValueError("need one or more chunk, label and bad arrays each")
    util.ensure_dir_for(output)

    all_chunks = np.concatenate(chunk_list)
    all_labels = np.concatenate(label_list)
    all_bad = np.concatenate(bad_list)

    nblank = np.sum(all_labels == 0, axis=1)
    max_blanks = int(all_labels.shape[1] * blanks)
    all_weights = nblank < max_blanks

    with h5py.File(output, 'w') as h5:
        h5.create_dataset('bad', data=all_bad.astype('i1'), compression="gzip")
        h5.create_dataset('chunks', data=all_chunks.astype('f4'),
                          compression="gzip")
        h5.create_dataset('labels', data=all_labels.astype('i4'),
                          compression="gzip")
        h5.create_dataset('weights', data=all_weights.astype('f4'),
                          compression="gzip")
        for key, value in attributes.items():
            h5['/'].attrs[key] = value


def load_labelled_chunks(path, reweight='weights'):
    """Load a labelled-chunks file into memory (copied from
    ``sloika_tpu/data/hdf5.py:46-72``).

    :returns: dict with chunks (N, T, F) f32, labels (N, T') i32,
        bad (N, T') bool, weights (N,) f64 normalised to sum 1, attrs dict
    """
    import h5py
    with h5py.File(path, 'r') as h5:
        chunks = h5['chunks'][:]
        labels = h5['labels'][:]
        bad = h5['bad'][:].astype(bool)
        if reweight is not None and reweight in h5:
            weights = h5[reweight][:]
        else:
            weights = np.ones(len(chunks))
        attrs = dict(h5['/'].attrs)
    weights = weights.astype('float64')
    total = np.sum(weights)
    if not total > 0:
        # every chunk zero-weighted (e.g. an aggressive blank-percentile
        # filter): fail loudly here rather than poisoning the training
        # sampler with NaN selection probabilities
        raise ValueError(
            "all chunk weights in {} are zero — nothing to train on "
            "(blank-percentile filter too aggressive?)".format(path))
    weights /= total
    return {"chunks": chunks, "labels": labels, "bad": bad,
            "weights": weights, "attrs": attrs}
