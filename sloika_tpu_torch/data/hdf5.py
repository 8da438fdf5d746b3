"""Labelled-chunk HDF5 batch files (cf. ``sloika_tpu/data/hdf5.py``, whose
module imports h5py at the top; here it is imported inside the loader, so
the port imports on a machine without h5py)."""
import numpy as np


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
