"""Namespace for model-definition files of the port
(cf. ``sloika_tpu/module_tools.py``, the reference's star-import DSL)::

    import numpy as np
    import sloika_tpu_torch.module_tools as smt

    def network(klen, sd, nbase=smt.DEFAULT_NBASE, nfeature=1, winlen=11,
                stride=2, seed=0):
        init = smt.truncated_normal(sd, np.random.RandomState(seed))
        return smt.Serial([
            smt.Convolution(nfeature, 64, winlen, stride, init=init,
                            has_bias=True, fun=smt.tanh),
            smt.Reverse(smt.Gru(64, 64, init=init, has_bias=True)),
            smt.Softmax(64, smt.nstate(klen, nbase=nbase), init=init,
                        has_bias=True)])

A model file's ``network`` takes the JAX package's keywords and ``seed``:
the port's layers hold their weights, drawn at construction by
``truncated_normal(sd, rs)``, the port's numpy-seeded initialiser.
"""
from functools import partial  # noqa: F401  (kept for model-file compatibility)

from sloika_tpu_torch.config import sloika_dtype  # noqa: F401
from sloika_tpu_torch.activations import *  # noqa: F401,F403
from sloika_tpu_torch.nn import *  # noqa: F401,F403
from sloika_tpu_torch.nn.core import truncated_normal  # noqa: F401
from sloika_tpu_torch.variables import (DEFAULT_ALPHABET,  # noqa: F401
                                        DEFAULT_NBASE, nkmer, nstate)
