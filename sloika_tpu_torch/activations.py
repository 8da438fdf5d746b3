"""Activation functions of the ported slice
(cf. ``sloika_tpu/activations.py``).

Functions are referenced by name in the JSON model format, so the names
match the JAX package's (and the reference's) exactly.
"""
import torch


def linear(x):
    return x


def elu(x):
    # expm1 only sees non-positive inputs: at a large positive x (the
    # unselected branch) it would overflow to inf, and inf * 0 in a gradient
    # gives NaN.  The inner where (not minimum(x, 0)) keeps d elu/dx(0) == 1.
    pos = x > 0
    return torch.where(pos, x, torch.expm1(torch.where(pos, 0.0, x)))


def tanh(x):
    return torch.tanh(x)


def sigmoid(x):
    return torch.sigmoid(x)


#: name -> function, for JSON (de)serialisation
BY_NAME = {f.__name__: f for f in (linear, elu, tanh, sigmoid)}


def by_name(name):
    """Look up an activation by its reference name."""
    if name not in BY_NAME:
        raise KeyError("activation {!r} is not ported; known: {}".format(
            name, sorted(BY_NAME)))
    return BY_NAME[name]
