"""Activation functions (cf. ``sloika_tpu/activations.py:20-125``).

Functions are referenced by name in the JSON model format and in the
reference's pickles, so the names match the JAX package's (and the
reference's) exactly.  Each function has the JAX function's value and its
gradient, at the kinks too: JAX splits the gradient of ``maximum`` and
``clip`` at a tie between the two sides, and differentiates ``abs`` at 0
as 1, so :func:`_max0`, :func:`_clip` and :func:`_abs` do the same.

Three families:
  * unbounded:             linear, relu, relu_smooth, softplus, elu, exp,
                           swish
  * bounded, monotone:     tanh, sigmoid, erf, L1mL2, fair, retu, tanh_pm,
                           sigmoid_pm, bounded_linear
  * bounded, redescending: sin, cauchy, geman_mcclure, welsh
"""
import torch


def _max0(x):
    """``max(x, 0)`` with JAX's gradient: 1/2 at 0."""
    return torch.maximum(x, x.new_zeros(()))


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi), with JAX's gradient (1/2 at the
    bounds; ``torch.clamp`` gives 1 there)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _abs(x):
    """``|x|`` with JAX's gradient: 1 at 0 (``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


#  Unbounded

def linear(x):
    return x


def relu(x):
    return _max0(x)


def relu_smooth(x):
    y = _clip(x, 0.0, 1.0)
    return torch.square(y) - 2.0 * y + x + _abs(x)


def softplus(x):
    """log(1 + exp(x)) as relu(x) + log1p(exp(-|x|)), the JAX package's
    formula (``torch.nn.functional.softplus`` switches to x above a
    threshold of 20 and differs from it)."""
    return relu(x) + torch.log1p(torch.exp(-_abs(x)))


def elu(x):
    # expm1 only sees non-positive inputs: at a large positive x (the
    # unselected branch) it would overflow to inf, and inf * 0 in a gradient
    # gives NaN.  The inner where (not minimum(x, 0)) keeps d elu/dx(0) == 1.
    pos = x > 0
    return torch.where(pos, x, torch.expm1(torch.where(pos, 0.0, x)))


def exp(x):
    return torch.exp(x)


def swish(x):
    """``x * sigmoid(x)`` (SiLU), bonito's convolutions' activation; the
    port's alone: the JAX package has no swish."""
    return x * torch.sigmoid(x)


#  Bounded and monotonic

def tanh(x):
    return torch.tanh(x)


def sigmoid(x):
    return torch.sigmoid(x)


def erf(x):
    return torch.erf(x)


def L1mL2(x):
    return x / torch.sqrt(1.0 + 0.5 * torch.square(x))


def fair(x):
    return x / (1.0 + _abs(x) / 1.3998)


def retu(x):
    """Rectify then tanh."""
    return torch.tanh(relu(x))


def tanh_pm(x):
    """Poor man's tanh: linear approximation clipped to the valid range."""
    return _clip(x, -1.0, 1.0)


def sigmoid_pm(x):
    """Poor man's sigmoid: linear approximation clipped to the valid range."""
    return _clip(0.5 + 0.25 * x, 0.0, 1.0)


def bounded_linear(x):
    return _clip(x, -1.0, 1.0)


#  Bounded and redescending

def sin(x):
    return torch.sin(x)


def cauchy(x):
    return x / (1.0 + torch.square(x / 2.3849))


def geman_mcclure(x):
    return x / torch.square(1.0 + torch.square(x))


def welsh(x):
    return x * torch.exp(-torch.square(x / 2.9846))


_ALL = [linear, relu, relu_smooth, softplus, elu, exp, swish,
        tanh, sigmoid, erf, L1mL2, fair, retu, tanh_pm, sigmoid_pm,
        bounded_linear, sin, cauchy, geman_mcclure, welsh]

#: name -> function, for JSON (de)serialisation
BY_NAME = {f.__name__: f for f in _ALL}


def by_name(name):
    """Look up an activation by its reference name."""
    if name not in BY_NAME:
        raise KeyError("unknown activation {!r}; known: {}".format(
            name, sorted(BY_NAME)))
    return BY_NAME[name]
