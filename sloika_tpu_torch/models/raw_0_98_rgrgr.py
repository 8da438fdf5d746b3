"""Raw model: elu convolution (stride 5) + five alternating-direction GRUs
(cf. ``sloika_tpu/models/raw_0_98_rgrgr.py``, the flagship raw training
architecture: every width 96)."""
import numpy as np

from sloika_tpu_torch import activations, nn
from sloika_tpu_torch import variables as sv


def network(klen, sd, nbase=sv.DEFAULT_NBASE, nfeature=1, winlen=11,
            stride=5, seed=0, size=96):
    """The rgrgr layer graph, initialised from ``np.random.RandomState(seed)``
    with a truncated normal of sd ``sd``; ``size`` is the width of the
    convolution and of every GRU (96 in the JAX model)."""
    n = size
    init = nn.truncated_normal(sd, np.random.RandomState(seed))

    def gru():
        return nn.Gru(n, n, init=init, has_bias=True, fun=activations.tanh)

    return nn.Serial([
        nn.Convolution(nfeature, n, winlen, stride, init=init,
                       has_bias=True, fun=activations.elu),
        nn.Reverse(gru()),
        gru(),
        nn.Reverse(gru()),
        gru(),
        nn.Reverse(gru()),
        nn.Softmax(n, sv.nstate(klen, nbase=nbase), init=init,
                   has_bias=True),
    ])
