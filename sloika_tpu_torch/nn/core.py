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

from sloika_tpu_torch import activations, config
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
    reference layout ``(out_features, in_features)``.  Under
    ``config.compute_dtype`` bfloat16 the product takes x and W rounded to
    bfloat16 and is float32 (cf. ``sloika_tpu/nn/core.py:53-69``, a
    ``dot_general`` with ``preferred_element_type=float32``): never
    bfloat16."""
    if config.compute_dtype == torch.bfloat16:
        y = Bf16Product.apply(x, W)
    else:
        y = torch.matmul(x, W.t())
    if b is not None:
        y = y + b
    return y


class Bf16Product(torch.autograd.Function):
    """``x @ W.T`` of x and W rounded to bfloat16, in float32.

    A product of two bfloat16 values is exact in float32, so on the CPU the
    product of the rounded operands upcast to float32 is the plain form; on
    the GPU ``torch.mm(..., out_dtype=torch.float32)`` takes the bfloat16
    operands and keeps the float32 accumulator (``torch.matmul`` of two
    bfloat16 tensors would round it to bfloat16).  The gradients are those
    of the plain form, as JAX's: the float32 cotangent times the other
    rounded operand, rounded to bfloat16 (the transpose of the casts).
    """

    @staticmethod
    def forward(ctx, x, W):
        xb = x.to(torch.bfloat16).reshape(-1, x.shape[-1])
        Wb = W.to(torch.bfloat16)
        ctx.save_for_backward(xb, Wb)
        ctx.lead = x.shape[:-1]
        if xb.is_cuda:
            y = torch.mm(xb, Wb.t(), out_dtype=torch.float32)
        else:
            y = xb.float() @ Wb.float().t()
        return y.reshape(*ctx.lead, W.shape[0])

    @staticmethod
    def backward(ctx, g):
        xb, Wb = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1]).float()
        dx = dW = None
        if ctx.needs_input_grad[0]:
            dx = (g @ Wb.float()).to(torch.bfloat16).float().reshape(
                *ctx.lead, xb.shape[-1])
        if ctx.needs_input_grad[1]:
            dW = (g.t() @ xb.float()).to(torch.bfloat16).float()
        return dx, dW


def tree_items(tree, prefix=""):
    """``(path, leaf)`` pairs of a parameter tree (dicts and tuples) in the
    JAX package's flattening order: dict keys sorted, tuples by index;
    paths are ``/``-joined as in ``sloika_tpu.serialize.flatten_tree``."""
    if isinstance(tree, dict):
        keys = sorted(tree)
    elif isinstance(tree, (tuple, list)):
        keys = range(len(tree))
    else:
        return [(prefix, tree)]
    items = []
    for k in keys:
        path = "{}/{}".format(prefix, k) if prefix else str(k)
        items.extend(tree_items(tree[k], path))
    return items


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


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

    def param_tensors(self):
        """This layer's parameters (the ``torch.nn.Parameter`` objects) as a
        JAX-package-shaped tree."""
        return dict(self.named_parameters(recurse=False))

    def param_tree(self):
        """This layer's parameters as a JAX-package-shaped tree of numpy
        arrays."""
        return tree_map(lambda p: p.detach().cpu().numpy(),
                        self.param_tensors())

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
