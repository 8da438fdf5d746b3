"""1-D temporal convolution and max pooling over time-major tensors
(cf. ``sloika_tpu/ops/conv.py``).

A strided cross-correlation (no filter flip) with the reference weight
layout ``(out, in, winlen)``.  The zero padding is applied explicitly with
``F.pad``, because 'same' padding is asymmetric for an even ``winlen``.
The convolution itself is ``F.conv1d``: the JAX package leaves it to XLA,
outside its Pallas kernels.
"""
import torch.nn.functional as F

PADDING_MODES = frozenset(['same', 'half', 'valid', 'full', 'same_left'])


def calculate_padding(mode, winlen):
    """(start, end) zero-padding for a padding mode and window length.

        'same'       ((winlen-1)//2, winlen//2)
        'half'       (winlen//2, winlen//2)
        'valid'      (0, 0)
        'full'       (winlen-1, winlen-1)
        'same_left'  (winlen//2, (winlen-1)//2)
        int          (int, int)
        (int, int)   as given
    """
    if winlen <= 0:
        raise ValueError("winlen must be positive")
    if isinstance(mode, int):
        return (mode, mode)
    if isinstance(mode, (tuple, list)):
        if len(mode) != 2 or not all(isinstance(m, int) for m in mode):
            raise ValueError("Padding should be (int, int), got {!r}".format(
                mode))
        return tuple(mode)
    if mode not in PADDING_MODES:
        raise ValueError('Padding mode "{}" not supported'.format(mode))
    if mode == "same":
        return ((winlen - 1) // 2, winlen // 2)
    if mode == "half":
        return (winlen // 2, winlen // 2)
    if mode == "valid":
        return (0, 0)
    if mode == "full":
        return (winlen - 1, winlen - 1)
    return (winlen // 2, (winlen - 1) // 2)


def conv_1d(x, W, stride=1, padding=(0, 0)):
    """Temporal cross-correlation.

    :param x: input ``(time, batch, in_features)``
    :param W: filter ``(out_features, in_features, winlen)``
    :returns: ``(1 + (time + pad - winlen)//stride, batch, out_features)``
    """
    lhs = F.pad(x.permute(1, 2, 0), tuple(padding))   # (batch, feature, time)
    out = F.conv1d(lhs, W, stride=stride)
    return out.permute(2, 0, 1)                        # (time, batch, feature)


def pool_1d(x, pool_size, stride, padding=(0, 0)):
    """Temporal max pool with *zero* padding (cf. ``sloika_tpu/ops/conv.py:
    68-84``): the input is zero-padded first, so padded positions compete
    as 0.0, not as -inf (``F.max_pool1d``'s own padding).

    :param x: input ``(time, batch, features)``
    :returns: ``(1 + (time + pad - pool_size)//stride, batch, features)``
    """
    xp = F.pad(x, (0, 0, 0, 0) + tuple(padding))
    return xp.unfold(0, pool_size, stride).amax(dim=-1)
