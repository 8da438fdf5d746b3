"""Event -> feature-matrix conversion, copied from
``sloika_tpu/data/features.py`` (that module imports the JAX package's
config): four features per event (mean, stdv, length, |delta mean|),
optional studentisation, optional nanonet-style uncentred delta."""
import numpy as np

from sloika_tpu_torch.config import sloika_dtype
from sloika_tpu_torch.maths import studentise


def from_events(ev, tag='scaled_', normalise=True, nanonet=False):
    """Feature matrix from an event record array
    (sloika_tpu/data/features.py:13-35).

    :param ev: record array with fields '<tag>mean', '<tag>stdv', 'length'
    :param tag: field prefix selecting prescaled statistics
    :param normalise: studentise features column-wise
    :param nanonet: replace |delta mean| with uncentred, std-normalised delta
    """
    nev = len(ev)
    features = np.zeros((nev, 4), dtype=sloika_dtype)
    features[:, 0] = ev[tag + 'mean']
    features[:, 1] = ev[tag + 'stdv']
    features[:, 2] = ev['length']
    features[:, 3] = np.fabs(np.ediff1d(ev[tag + 'mean'], to_end=0))

    if normalise:
        features = studentise(features, axis=0)

    if nanonet:
        features[:, 3] = np.ediff1d(ev[tag + 'mean'], to_end=0)
        features[:, 3] /= np.std(features[:, 3])

    return np.ascontiguousarray(features, dtype=sloika_dtype)
