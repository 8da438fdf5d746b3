"""Core of the port's layer library (cf. ``sloika_tpu/nn/core.py``).

A :class:`Layer` is a ``torch.nn.Module`` that owns its parameters, stored
gate-major ``(ngate, size, fan_in)`` exactly as the JAX package stores its
parameter pytree and as the reference's JSON export lays them out.  Inputs
are time-major ``(time, batch, features)``.

Initialisers are seeded from numpy (``f(shape) -> ndarray``), so a model
made from a seed has the same weights on every device.
"""
import numpy as np
import torch

from sloika_tpu_torch import activations
from sloika_tpu_torch.config import sloika_dtype


def zeros_init(shape):
    """Default initialiser of the reference (layers.py:21-22)."""
    return np.zeros(shape, dtype=sloika_dtype)


def truncated_normal(sd, rs):
    """Normal initialiser truncated at +/- 2 sd, drawn from the numpy
    ``RandomState`` ``rs`` (cf. ``sloika_tpu.nn.core.truncated_normal``)."""
    def init(shape):
        x = rs.standard_normal(shape)
        bad = np.abs(x) > 2.0
        while bad.any():
            x[bad] = rs.standard_normal(int(bad.sum()))
            bad = np.abs(x) > 2.0
        return (sd * x).astype(sloika_dtype)
    return init


def affine(x, W, b=None):
    """``x @ W.T (+ b)`` over the trailing feature axis; ``W`` has the
    reference layout ``(out_features, in_features)``."""
    y = torch.matmul(x, W.t())
    if b is not None:
        y = y + b
    return y


_REGISTRY = {}


def register(json_type):
    """Class decorator registering a layer under its JSON ``type`` string."""
    def deco(cls):
        cls.json_type = json_type
        _REGISTRY[json_type] = cls
        return cls
    return deco


class Layer(torch.nn.Module):
    """Base of the port's layers; see the module docstring."""

    json_type = None

    def _param(self, array):
        """Register-ready float32 parameter from a numpy array."""
        return torch.nn.Parameter(torch.from_numpy(
            np.ascontiguousarray(array, dtype=sloika_dtype)))

    def apply_with_lengths(self, x, lengths):
        """Run on tail-padded variable-length sequences; ``lengths`` is an
        integer (batch,) tensor.  Returns ``(y, out_lengths)``; positions
        past a sequence's output length are unspecified."""
        return self(x), lengths

    # -- parameters and JSON ---------------------------------------------

    def param_tree(self):
        """This layer's parameters as a JAX-package-shaped tree of numpy
        arrays."""
        return {k: p.detach().cpu().numpy()
                for k, p in self.named_parameters(recurse=False)}

    def load_param_tree(self, tree):
        """Copy a JAX-package-shaped numpy tree into the parameters."""
        own = dict(self.named_parameters(recurse=False))
        if set(own) != set(tree):
            raise ValueError("{}: parameters {} given, {} expected".format(
                type(self).__name__, sorted(tree), sorted(own)))
        with torch.no_grad():
            for k, p in own.items():
                a = np.asarray(tree[k], dtype=sloika_dtype)
                if tuple(a.shape) != tuple(p.shape):
                    raise ValueError("{}.{}: shape {} given, {} expected"
                                     .format(type(self).__name__, k, a.shape,
                                             tuple(p.shape)))
                p.copy_(torch.tensor(a))

    def to_json(self, params=False):
        """JSON-compatible description, with the parameters when asked."""
        res = {"type": self.json_type, **self._json_config()}
        if params:
            res["params"] = {k: v.tolist()
                             for k, v in self.param_tree().items()}
        return res

    def _json_config(self):
        return {}


def from_json(obj):
    """Rebuild ``(layer, params_tree_or_None)`` from a JSON description; the
    layer holds the parameters when the description has them."""
    if obj["type"] not in _REGISTRY:
        raise KeyError("layer type {!r} is not ported; known: {}".format(
            obj["type"], sorted(_REGISTRY)))
    return _REGISTRY[obj["type"]]._from_json(obj)


def params_from_json(jparams):
    return {k: np.array(v, dtype=sloika_dtype) for k, v in jparams.items()}


def activation_name(fun):
    return fun.__name__


def activation_from_name(name):
    return activations.by_name(name)
