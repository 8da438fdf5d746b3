"""Analytic forward-FLOP accounting of the port's layer graphs (cf.
``sloika_tpu/nn/flops.py``).

Counting rule: every element of a dense weight tensor takes part in one
multiply-accumulate for each frame it is applied to, so a layer's cost per
*output* frame is ``2 x (non-bias parameter count)``; a stride-``s`` layer
charges that to ``s`` input frames.  Elementwise work (activations, gates,
normalisation) is left out.  The parameter trees are the JAX package's
(``Layer.param_tree``), so both packages count the same.
"""
import numpy as np

from sloika_tpu_torch import nn

#: parameter-tree keys that are biases / peepholes (elementwise adds or
#: products, not contractions)
_BIAS_KEYS = frozenset({"b", "b2", "p", "b_u", "b_z", "b_r", "b_h"})


def _leaf_flops(params):
    """2 x MAC count per frame of a leaf layer's dense weights
    (sloika_tpu/nn/flops.py:20)."""
    if not isinstance(params, dict):
        return 0.0
    return 2.0 * sum(
        int(np.prod(v.shape)) for k, v in params.items()
        if k not in _BIAS_KEYS and hasattr(v, "shape") and len(v.shape) >= 2)


def downsample(layer):
    """Total temporal downsampling factor of a layer graph
    (sloika_tpu/nn/flops.py:29)."""
    if isinstance(layer, nn.Serial):
        s = 1
        for l in layer.layers:
            s *= downsample(l)
        return s
    if isinstance(layer, (nn.Convolution, nn.MaxPool)):
        return layer.stride
    if isinstance(layer, (nn.Reverse, nn.Residual)):
        return downsample(layer.layer)
    if isinstance(layer, nn.Parallel):
        return downsample(layer.layers[0])
    return 1


def flops_per_input_frame(layer, params=None):
    """Forward FLOPs per frame *entering* ``layer`` (for a raw model, per
    signal sample; the successors of a strided layer run at its output
    rate) (sloika_tpu/nn/flops.py:46).

    :param params: the layer's parameter tree; None reads the layer's own
        (``layer.param_tree()``)
    """
    if params is None:
        params = layer.param_tree()
    if isinstance(layer, nn.Serial):
        total, rate = 0.0, 1.0
        for l, p in zip(layer.layers, params["sublayers"]):
            total += rate * flops_per_input_frame(l, p)
            rate /= downsample(l)
        return total
    if isinstance(layer, (nn.Reverse, nn.Residual)):
        return flops_per_input_frame(layer.layer, params["sublayer"])
    if isinstance(layer, nn.Parallel):
        return sum(flops_per_input_frame(l, p)
                   for l, p in zip(layer.layers, params["sublayers"]))
    if isinstance(layer, (nn.Convolution, nn.MaxPool)):
        return _leaf_flops(params) / layer.stride
    return _leaf_flops(params)


def training_flops_per_input_frame(layer, params=None):
    """Forward + backward FLOPs per input frame of one training step: each
    dense contraction of the forward has two of the same shape in the
    backward (the activations' and the weights' cotangents); the
    optimiser's elementwise work is left out (sloika_tpu/nn/flops.py:68)."""
    return 3.0 * flops_per_input_frame(layer, params)
