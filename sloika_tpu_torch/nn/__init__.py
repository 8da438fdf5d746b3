"""The port's layer library (cf. ``sloika_tpu/nn``)."""
from sloika_tpu_torch.nn.core import (Layer, from_json, zeros_init,
                                      truncated_normal, affine, register)
from sloika_tpu_torch.nn.layers import Softmax, SoftmaxTheano, Convolution
from sloika_tpu_torch.nn.rnn import RNNBase, Gru
from sloika_tpu_torch.nn.combinators import Serial, Reverse

__all__ = [
    "Layer", "from_json", "zeros_init", "truncated_normal", "affine",
    "register", "Softmax", "SoftmaxTheano", "Convolution", "RNNBase", "Gru",
    "Serial", "Reverse",
]
