"""bonito's CRF head (``LinearCRFEncoder``): scores ``tanh(x W^T + b) *
scale``, W (nbase^(state_len + 1), I), viewed as nbase^state_len groups of
nbase with ``blank_score`` put in front of each: a frame's (nstate, nbase +
1) transition scores, [s, 0] the stay into state s, [s, k] the step into s
from state (k - 1) nstate/nbase + s // nbase (seqdist's ``CTC_CRF.idx``;
``benchmark/reference/crf.py`` decodes them)."""
import math

import torch
import torch.nn.functional as F


def _out(spec):
    return spec["nbase"] ** (spec["state_len"] + 1)


def param_shapes(spec, i):
    out, I = _out(spec), spec["insize"]
    return [("{}.W".format(i), (out, I), math.sqrt(out + I)),
            ("{}.b".format(i), (out,), 1.0)]


def flops(spec):
    return 2.0 * _out(spec) * spec["insize"]


def stride(spec):
    return 1


def out_lengths(spec, lengths):
    return lengths


def forward(spec, p, i, x, lengths, prec):
    W = p["{}.W".format(i)]
    y = torch.matmul(prec.operand(x), prec.operand(W).t()) \
        + p["{}.b".format(i)]
    scores = torch.tanh(y) * spec["scale"]
    T, B, C = scores.shape
    groups = scores.reshape(T, B, C // spec["nbase"], spec["nbase"])
    return F.pad(groups, (1, 0), value=spec["blank_score"]).reshape(T, B, -1)


def head_weights(spec, i, p, scheme):
    """The weights times the scheme's ``crf_gain`` and the biases plus its
    ``crf_bias``: how far the step scores reach into tanh's range and
    where they sit against the blank's, and so how often the best path
    steps."""
    p["{}.W".format(i)].mul_(scheme["crf_gain"])
    p["{}.b".format(i)].add_(scheme["crf_bias"])
