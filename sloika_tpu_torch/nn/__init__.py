"""The port's layer library (cf. ``sloika_tpu/nn``)."""
from sloika_tpu_torch.nn.core import (Layer, from_json, zeros_init,
                                      truncated_normal, affine, register)
from sloika_tpu_torch.nn.layers import (Softmax, SoftmaxTheano, Convolution,
                                        FeedForward, Window)
from sloika_tpu_torch.nn.rnn import RNNBase, Gru, Lstm
from sloika_tpu_torch.nn.combinators import Serial, Parallel, Reverse, birnn

__all__ = [
    "Layer", "from_json", "zeros_init", "truncated_normal", "affine",
    "register", "Softmax", "SoftmaxTheano", "Convolution", "FeedForward",
    "Window", "RNNBase", "Gru", "Lstm", "Serial", "Parallel", "Reverse",
    "birnn",
]
