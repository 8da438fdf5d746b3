"""Layer combinators: ``Serial``, ``Parallel``, ``Reverse``, ``Residual``
and ``birnn`` (cf. ``sloika_tpu/nn/combinators.py``).
Parameter trees nest as in the JAX package: ``{"sublayers": (...)}`` and
``{"sublayer": ...}``."""
import torch

from sloika_tpu_torch.nn.core import Layer, register, from_json
from sloika_tpu_torch.nn.rnn import RNNBase


class _Wrapper(Layer):
    """A layer around one sublayer, with the JAX package's
    ``{"sublayer": ...}`` parameter tree and JSON."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer
        self.insize, self.size = layer.insize, layer.size

    def param_tensors(self):
        return {"sublayer": self.layer.param_tensors()}

    def load_param_tree(self, tree):
        self.layer.load_param_tree(tree["sublayer"])

    def to_json(self, params=False):
        return {"type": self.json_type,
                "sublayer": self.layer.to_json(params)}

    @classmethod
    def _from_json(cls, obj):
        sub, sub_tree = from_json(obj["sublayer"])
        return cls(sub), None if sub_tree is None else {"sublayer": sub_tree}


@register("reverse")
class Reverse(_Wrapper):
    """Run a layer backwards in time (cf. ``sloika_tpu/nn/combinators.py:
    13-56``): a recurrent sublayer scans in reverse, with no flips; any
    other is applied to the time-flipped input and its output flipped
    back."""

    def forward(self, x):
        if isinstance(self.layer, RNNBase):
            return self.layer(x, reverse=True)
        return self.layer(x.flip(0)).flip(0)

    def apply_with_lengths(self, x, lengths):
        if not isinstance(self.layer, RNNBase):
            raise NotImplementedError("Reverse with variable lengths is only "
                                      "defined for RNN sublayers")
        mask = (torch.arange(x.shape[0], device=x.device)[:, None]
                < lengths[None, :])
        return self.layer(x, reverse=True, mask=mask), lengths


@register("residual")
class Residual(_Wrapper):
    """``x + layer(x)``; the sublayer keeps the width
    (cf. ``sloika_tpu/nn/combinators.py:115-156``)."""

    def __init__(self, layer):
        if layer.insize != layer.size:
            raise ValueError("Residual connections require input and output "
                             "sizes to be equal")
        super().__init__(layer)

    def forward(self, x):
        return x + self.layer(x)

    def apply_with_lengths(self, x, lengths):
        y, out_lengths = self.layer.apply_with_lengths(x, lengths)
        return x + y, out_lengths


class _Sublayers(Layer):
    """A list of sublayers with the JAX package's ``{"sublayers": (...)}``
    parameter tree and JSON."""

    def __init__(self, layers):
        super().__init__()
        if not layers:
            raise ValueError("A {} layer cannot be empty".format(
                type(self).__name__))
        self.layers = torch.nn.ModuleList(layers)

    def param_tensors(self):
        return {"sublayers": tuple(l.param_tensors() for l in self.layers)}

    def load_param_tree(self, tree):
        subs = tree["sublayers"]
        if len(subs) != len(self.layers):
            raise ValueError("{}: {} sublayer trees for {} layers".format(
                type(self).__name__, len(subs), len(self.layers)))
        for layer, t in zip(self.layers, subs):
            layer.load_param_tree(t)

    def to_json(self, params=False):
        return {"type": self.json_type,
                "sublayers": [l.to_json(params) for l in self.layers]}

    @classmethod
    def _from_json(cls, obj):
        pairs = [from_json(s) for s in obj["sublayers"]]
        layer = cls([p[0] for p in pairs])
        if any(p[1] is None for p in pairs):
            return layer, None
        return layer, {"sublayers": tuple(p[1] for p in pairs)}


@register("serial")
class Serial(_Sublayers):
    """Sequential composition."""

    def __init__(self, layers):
        super().__init__(layers)
        for a, b in zip(layers, layers[1:]):
            if a.size != b.insize:
                raise ValueError("Serial layer has inconsistent sizes")
        self.insize, self.size = layers[0].insize, layers[-1].size

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def apply_with_lengths(self, x, lengths):
        for layer in self.layers:
            x, lengths = layer.apply_with_lengths(x, lengths)
        return x, lengths


@register("parallel")
class Parallel(_Sublayers):
    """Run layers on the same input and concatenate their outputs on the
    feature axis (cf. ``sloika_tpu/nn/combinators.py:62-112``)."""

    def __init__(self, layers):
        super().__init__(layers)
        if any(l.insize != layers[0].insize for l in layers):
            raise ValueError("Parallel layer has inconsistent sizes")
        self.insize = layers[0].insize
        self.size = sum(l.size for l in layers)

    def forward(self, x):
        return torch.cat([l(x) for l in self.layers], dim=2)

    def apply_with_lengths(self, x, lengths):
        outs, out_lengths = [], lengths
        for l in self.layers:
            y, out_lengths = l.apply_with_lengths(x, lengths)
            outs.append(y)
        return torch.cat(outs, dim=2), out_lengths


def birnn(forward, backward):
    """Bidirectional RNN from two cells (cf. ``sloika_tpu/nn/combinators.py:
    208-210``)."""
    return Parallel([forward, Reverse(backward)])
