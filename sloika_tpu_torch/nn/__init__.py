"""The port's layer library (cf. ``sloika_tpu/nn``)."""
from sloika_tpu_torch.nn.core import (Layer, from_json, zeros_init,
                                      truncated_normal, affine, register)
from sloika_tpu_torch.nn.layers import (Identity, FeedForward, Softmax,
                                        SoftmaxTheano, Studentise,
                                        NormaliseL1, Window, Convolution,
                                        MaxPool, LinearCRF)
from sloika_tpu_torch.nn.rnn import (RNNBase, Recurrent, Gru, Lstm, LstmCIFG,
                                     LstmO, Forget, Scrn, Mut1, Mut2, Mut3,
                                     Genmut)
from sloika_tpu_torch.nn.combinators import (Serial, Parallel, Reverse,
                                             Residual, birnn)
from sloika_tpu_torch.nn.decode_layer import Decode

__all__ = [
    "Layer", "from_json", "zeros_init", "truncated_normal", "affine",
    "register", "Identity", "FeedForward", "Softmax", "SoftmaxTheano",
    "Studentise", "NormaliseL1", "Window", "Convolution", "MaxPool",
    "LinearCRF",
    "RNNBase", "Recurrent", "Gru", "Lstm", "LstmCIFG", "LstmO", "Forget",
    "Scrn", "Mut1", "Mut2", "Mut3", "Genmut",
    "Serial", "Parallel", "Reverse", "Residual", "birnn", "Decode",
]
