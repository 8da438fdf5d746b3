"""Raw-signal Nanonet: a strided tanh convolution, then the GRU stack of
baseline_gru (cf. ``sloika_tpu/models/baseline_raw_gru.py``)."""
import numpy as np

import sloika_tpu_torch.module_tools as smt


def network(klen, sd, nbase=smt.DEFAULT_NBASE, nfeature=1, winlen=11,
            stride=2, size=64, seed=0):
    """The baseline_raw_gru layer graph, initialised from
    ``np.random.RandomState(seed)`` with a truncated normal of sd ``sd``;
    as in the JAX model, the first feed-forward layer takes no
    initialiser."""
    init = smt.truncated_normal(sd, np.random.RandomState(seed))
    nstate = smt.nstate(klen, nbase=nbase)

    return smt.Serial([
        smt.Convolution(nfeature, size, winlen, stride, init=init,
                        has_bias=True, fun=smt.tanh),
        smt.birnn(smt.Gru(size, size, init=init, has_bias=True),
                  smt.Gru(size, size, init=init, has_bias=True)),
        smt.FeedForward(2 * size, size, has_bias=True),
        smt.birnn(smt.Gru(size, size, init=init, has_bias=True),
                  smt.Gru(size, size, init=init, has_bias=True)),
        smt.FeedForward(2 * size, size, init=init, has_bias=True),
        smt.Softmax(size, nstate, init=init, has_bias=True),
    ])
