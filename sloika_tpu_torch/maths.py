"""Robust statistics helpers (host-side numpy), copied from
``sloika_tpu/maths.py`` and trimmed to what the port calls."""
import numpy as np

#: scales the MAD to the standard deviation of a normal distribution
MAD_FACTOR = 1.4826


def med_mad(data, factor=None, axis=None, keepdims=False):
    """Median and Median Absolute Deviation of ``data`` (copied from
    sloika_tpu/maths.py:12).

    :param factor: scale for the MAD; default is normal-consistency (1.4826)
    """
    if factor is None:
        factor = MAD_FACTOR
    dmed = np.median(data, axis=axis, keepdims=True)
    dmad = factor * np.median(abs(data - dmed), axis=axis, keepdims=True)
    if axis is None:
        dmed = dmed.flatten()[0]
        dmad = dmad.flatten()[0]
    elif not keepdims:
        dmed = dmed.squeeze(axis)
        dmad = dmad.squeeze(axis)
    return dmed, dmad


def mad(data, factor=None, axis=None, keepdims=False):
    """(Scaled) Median Absolute Deviation of ``data`` (copied from
    sloika_tpu/maths.py:30)."""
    _, dmad = med_mad(data, factor=factor, axis=axis, keepdims=keepdims)
    return dmad


def studentise(x, axis=None):
    """Studentise an array along an axis; constant slices are left unscaled
    (copied from sloika_tpu/maths.py:36)."""
    m = np.mean(x, axis=axis, keepdims=True)
    s = np.std(x, axis=axis, keepdims=True)
    s = np.where(s > 0.0, s, 1.0)
    return np.divide(x - m, s)
