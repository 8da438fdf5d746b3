"""Softmax: ``softmax(x W^T + b)`` over the features, W (S, I) (sloika's
Theano ``sloika/layers.py``).  :func:`forward` gives its logits, ``x W^T +
b``; :func:`benchmark.reference.model.posterior` takes their softmax."""
import math

import torch


def param_shapes(spec, i):
    S, I = spec["size"], spec["insize"]
    return [("{}.W".format(i), (S, I), math.sqrt(S + I)),
            ("{}.b".format(i), (S,), 1.0)]


def flops(spec):
    return 2.0 * spec["size"] * spec["insize"]


def stride(spec):
    return 1


def out_lengths(spec, lengths):
    return lengths


def forward(spec, p, i, x, lengths, prec):
    W = p["{}.W".format(i)]
    return torch.matmul(prec.operand(x), prec.operand(W).t()) \
        + p["{}.b".format(i)]


def head_weights(spec, i, p, scheme):
    """The weights times the scheme's ``softmax_gain``, and, where its
    ``stay_logit`` is a number, the stay state's row (column 0 of the
    posterior) zero and its bias that number."""
    W, b = "{}.W".format(i), "{}.b".format(i)
    p[W].mul_(scheme["softmax_gain"])
    if scheme["stay_logit"] is not None:
        p[W][0] = 0.0
        p[b][0] = scheme["stay_logit"]
