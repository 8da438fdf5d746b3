"""Standard event-domain Nanonet with peephole LSTM units
(cf. ``sloika_tpu/models/baseline_lstm.py:8-25``): a window over the event
features, two bidirectional LSTM layers with a feed-forward layer after
each, and a softmax over the kmer states."""
import numpy as np

from sloika_tpu_torch import nn
from sloika_tpu_torch import variables as sv


def network(klen, sd, nbase=sv.DEFAULT_NBASE, nfeature=4, winlen=3,
            stride=1, size=64, seed=0):
    """The baseline_lstm layer graph, initialised from
    ``np.random.RandomState(seed)`` with a truncated normal of sd ``sd``.
    As in the JAX model, the first feed-forward layer takes no initialiser
    (its weights start at zero)."""
    if stride != 1:
        raise ValueError("Model only supports stride of 1")
    init = nn.truncated_normal(sd, np.random.RandomState(seed))
    nstate = sv.nstate(klen, nbase=nbase)
    insize = nfeature * winlen

    def lstm(i, s):
        return nn.Lstm(i, s, init=init, has_bias=True, has_peep=True)

    return nn.Serial([
        nn.Window(nfeature, winlen),
        nn.birnn(lstm(insize, size), lstm(insize, size)),
        nn.FeedForward(2 * size, size, has_bias=True),
        nn.birnn(lstm(size, size), lstm(size, size)),
        nn.FeedForward(2 * size, size, init=init, has_bias=True),
        nn.Softmax(size, nstate, init=init, has_bias=True),
    ])
