"""Larger raw-signal Nanonet with a width for each stage
(cf. ``sloika_tpu/models/bigger_raw_gru.py``): a strided tanh convolution
of s0, biGRUs of s1, feed-forward layers of s2."""
import numpy as np

import sloika_tpu_torch.module_tools as smt


def network(klen, sd, nbase=smt.DEFAULT_NBASE, nfeature=1, winlen=11,
            stride=2, size=(32, 96, 128), seed=0):
    """The bigger_raw_gru layer graph, initialised from
    ``np.random.RandomState(seed)`` with a truncated normal of sd ``sd``;
    as in the JAX model, the first feed-forward layer takes no
    initialiser."""
    init = smt.truncated_normal(sd, np.random.RandomState(seed))
    nstate = smt.nstate(klen, nbase=nbase)
    s0, s1, s2 = size

    return smt.Serial([
        smt.Convolution(nfeature, s0, winlen, stride, init=init,
                        has_bias=True, fun=smt.tanh),
        smt.birnn(smt.Gru(s0, s1, init=init, has_bias=True),
                  smt.Gru(s0, s1, init=init, has_bias=True)),
        smt.FeedForward(2 * s1, s2, has_bias=True),
        smt.birnn(smt.Gru(s2, s1, init=init, has_bias=True),
                  smt.Gru(s2, s1, init=init, has_bias=True)),
        smt.FeedForward(2 * s1, s2, init=init, has_bias=True),
        smt.Softmax(s2, nstate, init=init, has_bias=True),
    ])
