"""bonito's CRF-LSTM basecaller, ``dna_r9.4.1_e8_hac@v3.3`` at its widths
(nanoporetech/bonito, ``bonito/crf/model.py::rnn_encoder`` with
``LinearCRFEncoder``): three swish convolutions (1 -> 4 and 4 -> 16 of
width 5, 16 -> features of width ``winlen`` and stride ``stride``), five
LSTMs of ``features`` that alternate direction, the first reversed, and
the CRF head (``nn.LinearCRF``: tanh, x ``scale``, ``blank_score`` in front
of each group of 4) over 4^state_len states.  The port has no such model
in the JAX package; its plain reference is
:mod:`sloika_tpu_torch.models.bonito_crf_reference`."""
import numpy as np

from sloika_tpu_torch import activations, nn
from sloika_tpu_torch import variables as sv


def network(klen=None, sd=0.5, nbase=sv.DEFAULT_NBASE, nfeature=1,
            winlen=19, stride=5, features=384, state_len=4, scale=5.0,
            blank_score=2.0, nlayer=5, seed=0):
    """The layer graph, initialised from ``np.random.RandomState(seed)``
    with a truncated normal of sd ``sd``.  bonito's LSTMs are
    ``torch.nn.LSTM``: the port's ``Lstm`` without peepholes, with one bias
    (``b_ih + b_hh``) and its own gate order
    (:func:`~sloika_tpu_torch.models.bonito_crf_reference.from_bonito_state_dict`
    maps bonito's weights).  ``klen`` is taken for the registry's
    signature and unused: the CRF's states are 4^``state_len``."""
    init = nn.truncated_normal(sd, np.random.RandomState(seed))

    def conv(i, o, w, s=1):
        return nn.Convolution(i, o, w, s, init=init, has_bias=True,
                              fun=activations.swish, padding_mode="half")

    def lstm():
        return nn.Lstm(features, features, init=init, has_bias=True,
                       has_peep=False)

    rnns = [nn.Reverse(lstm()) if i % 2 == 0 else lstm()
            for i in range(nlayer)]
    return nn.Serial([
        conv(nfeature, 4, 5),
        conv(4, 16, 5),
        conv(16, features, winlen, stride),
        *rnns,
        nn.LinearCRF(features, nbase=nbase, state_len=state_len,
                     scale=scale, blank_score=blank_score, init=init),
    ])
