"""Convolution: ``fun(conv1d(pad(x), W, stride) + b)``, W (out, in,
winlen), 'same' padding ((winlen - 1) // 2, winlen // 2), no filter flip
(sloika's Theano ``sloika/layers.py``); ``fun`` the spec's
``activation``, tanh by default.  Its FLOPs follow the counting rule of
``sloika_tpu_torch/nn/flops.py:20-78``."""
import math

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "tanh": torch.tanh,
    "elu": F.elu,
    "linear": lambda x: x,
}


def param_shapes(spec, i):
    S, I, w, st = spec["size"], spec["insize"], spec["winlen"], spec["stride"]
    return [("{}.W".format(i), (S, I, w),
             math.sqrt(I * w + S * w / float(st))),
            ("{}.b".format(i), (S,), 1.0)]


def flops(spec):
    return 2.0 * (spec["size"] * spec["insize"] * spec["winlen"]) \
        / spec["stride"]


def stride(spec):
    return spec["stride"]


def out_lengths(spec, lengths):
    w = spec["winlen"]
    return 1 + (lengths + w - 1 - w) // spec["stride"]


def forward(spec, p, i, x, lengths, prec):
    w = spec["winlen"]
    lhs = F.pad(x.permute(1, 2, 0), ((w - 1) // 2, w // 2))
    y = F.conv1d(prec.operand(lhs), prec.operand(p["{}.W".format(i)]),
                 stride=spec["stride"])
    y = y + p["{}.b".format(i)][None, :, None]
    return ACTIVATIONS[spec.get("activation", "tanh")](y).permute(2, 0, 1)
