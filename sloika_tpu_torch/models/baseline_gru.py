"""Standard event-domain Nanonet with GRU units
(cf. ``sloika_tpu/models/baseline_gru.py``): Window -> biGRU -> FF ->
biGRU -> FF -> Softmax."""
import numpy as np

import sloika_tpu_torch.module_tools as smt


def network(klen, sd, nbase=smt.DEFAULT_NBASE, nfeature=4, winlen=3,
            stride=1, size=64, seed=0):
    """The baseline_gru layer graph, initialised from
    ``np.random.RandomState(seed)`` with a truncated normal of sd ``sd``;
    as in the JAX model, the first feed-forward layer takes no
    initialiser."""
    if stride != 1:
        raise ValueError("Model only supports stride of 1")
    init = smt.truncated_normal(sd, np.random.RandomState(seed))
    nstate = smt.nstate(klen, nbase=nbase)
    insize = nfeature * winlen

    return smt.Serial([
        smt.Window(nfeature, winlen),
        smt.birnn(smt.Gru(insize, size, init=init, has_bias=True),
                  smt.Gru(insize, size, init=init, has_bias=True)),
        smt.FeedForward(2 * size, size, has_bias=True),
        smt.birnn(smt.Gru(size, size, init=init, has_bias=True),
                  smt.Gru(size, size, init=init, has_bias=True)),
        smt.FeedForward(2 * size, size, init=init, has_bias=True),
        smt.Softmax(size, nstate, init=init, has_bias=True),
    ])
