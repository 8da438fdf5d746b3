"""Raw model: tanh convolution + three alternating-direction GRUs
(cf. ``sloika_tpu/models/raw_1_00_rGr.py``, sizes 128/110/142/110)."""
import numpy as np

from sloika_tpu_torch import activations, nn
from sloika_tpu_torch import variables as sv


def network(klen, sd, nbase=sv.DEFAULT_NBASE, nfeature=1, winlen=11,
            stride=2, seed=0, sizes=(128, 110, 142, 110)):
    """The rGr layer graph, initialised from ``np.random.RandomState(seed)``
    with a truncated normal of sd ``sd``."""
    n, k, l, m = sizes
    init = nn.truncated_normal(sd, np.random.RandomState(seed))
    return nn.Serial([
        nn.Convolution(nfeature, n, winlen, stride, init=init,
                       has_bias=True, fun=activations.tanh),
        nn.Reverse(nn.Gru(n, k, init=init, has_bias=True)),
        nn.Gru(k, l, init=init, has_bias=True),
        nn.Reverse(nn.Gru(l, m, init=init, has_bias=True)),
        nn.Softmax(m, sv.nstate(klen, nbase=nbase), init=init,
                   has_bias=True),
    ])
