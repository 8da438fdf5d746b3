"""Layer combinators of the ported slice: ``Serial`` and ``Reverse``
(cf. ``sloika_tpu/nn/combinators.py``).  Parameter trees nest as in the
JAX package: ``{"sublayers": (...)}`` and ``{"sublayer": ...}``."""
import torch

from sloika_tpu_torch.nn.core import Layer, register, from_json
from sloika_tpu_torch.nn.rnn import RNNBase


@register("reverse")
class Reverse(Layer):
    """Run a recurrent layer backwards in time: it scans in reverse, with no
    flips.  (Only recurrent sublayers are ported.)"""

    def __init__(self, layer):
        super().__init__()
        if not isinstance(layer, RNNBase):
            raise NotImplementedError("Reverse is ported for recurrent "
                                      "sublayers only")
        self.layer = layer
        self.insize, self.size = layer.insize, layer.size

    def forward(self, x):
        return self.layer(x, reverse=True)

    def apply_with_lengths(self, x, lengths):
        mask = (torch.arange(x.shape[0], device=x.device)[:, None]
                < lengths[None, :])
        return self.layer(x, reverse=True, mask=mask), lengths

    def param_tree(self):
        return {"sublayer": self.layer.param_tree()}

    def load_param_tree(self, tree):
        self.layer.load_param_tree(tree["sublayer"])

    def to_json(self, params=False):
        return {"type": self.json_type,
                "sublayer": self.layer.to_json(params)}

    @classmethod
    def _from_json(cls, obj):
        sub, sub_tree = from_json(obj["sublayer"])
        return cls(sub), None if sub_tree is None else {"sublayer": sub_tree}


@register("serial")
class Serial(Layer):
    """Sequential composition."""

    def __init__(self, layers):
        super().__init__()
        if not layers:
            raise ValueError("A Serial layer cannot be empty")
        for a, b in zip(layers, layers[1:]):
            if a.size != b.insize:
                raise ValueError("Serial layer has inconsistent sizes")
        self.layers = torch.nn.ModuleList(layers)
        self.insize, self.size = layers[0].insize, layers[-1].size

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def apply_with_lengths(self, x, lengths):
        for layer in self.layers:
            x, lengths = layer.apply_with_lengths(x, lengths)
        return x, lengths

    def param_tree(self):
        return {"sublayers": tuple(l.param_tree() for l in self.layers)}

    def load_param_tree(self, tree):
        subs = tree["sublayers"]
        if len(subs) != len(self.layers):
            raise ValueError("Serial: {} sublayer trees for {} layers".format(
                len(subs), len(self.layers)))
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
