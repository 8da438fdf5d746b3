"""Non-recurrent layers of the ported slice (cf. ``sloika_tpu/nn/layers.py``):
``Convolution``, ``Softmax`` (JSON ``softmax_old``) and ``SoftmaxTheano``
(JSON ``softmax``).  Initialisation scaling matches the JAX package."""
import numpy as np
import torch

from sloika_tpu_torch import activations
from sloika_tpu_torch.nn.core import (Layer, register, zeros_init, affine,
                                      activation_name, activation_from_name,
                                      params_from_json)
from sloika_tpu_torch.ops import conv as convops


@register("softmax_old")
class Softmax(Layer):
    """Affine followed by a max-shifted softmax over the features."""

    def __init__(self, insize, size, init=zeros_init, has_bias=False):
        super().__init__()
        self.insize, self.size = insize, size
        self.has_bias = has_bias
        self.W = self._param(init((size, insize)) / np.sqrt(size + insize))
        self.b = self._param(init((size,)) if has_bias
                             else zeros_init((size,)))

    def logits(self, x):
        """The pre-activation ``x @ W.T + b`` (cf. JAX ``_preact``), for a
        loss that takes the fused log-softmax."""
        return affine(x, self.W, self.b)

    def forward(self, x):
        tmp = self.logits(x)
        m = torch.amax(tmp, dim=2, keepdim=True)
        out = torch.exp(tmp - m)
        return out / torch.sum(out, dim=2, keepdim=True)

    def _json_config(self):
        return {"size": self.size, "insize": self.insize,
                "bias": self.has_bias}

    @classmethod
    def _from_json(cls, obj):
        layer = cls(obj["insize"], obj["size"],
                    has_bias=obj.get("bias", False))
        return _with_params(layer, obj)


@register("softmax")
class SoftmaxTheano(Softmax):
    """Same math as :class:`Softmax`; a distinct JSON type for interchange
    with reference dumps."""


@register("convolution")
class Convolution(Layer):
    """1-D temporal convolution with stride and padding modes."""

    def __init__(self, insize, size, winlen, stride=1, init=zeros_init,
                 has_bias=False, fun=activations.tanh, padding_mode='same'):
        super().__init__()
        self.insize, self.size = insize, size
        self.winlen = winlen
        self.stride = stride
        self.fun = fun
        self.has_bias = has_bias
        self.padding_mode = padding_mode
        self.padding = convops.calculate_padding(padding_mode, winlen)
        fanin = insize * winlen
        fanout = (size * winlen) / float(stride)
        self.W = self._param(init((size, insize, winlen))
                             / np.sqrt(fanin + fanout))
        self.b = self._param(init((size,)) if has_bias
                             else zeros_init((size,)))

    def forward(self, x):
        return self.fun(convops.conv_1d(x, self.W, self.stride, self.padding)
                        + self.b)

    def apply_with_lengths(self, x, lengths):
        # zero tail padding reproduces each sequence's own zero extension,
        # so frames within the per-sequence output length are exact
        out_lengths = 1 + torch.div(lengths + sum(self.padding) - self.winlen,
                                    self.stride, rounding_mode="floor")
        return self(x), out_lengths

    def _json_config(self):
        return {"insize": self.insize, "size": self.size,
                "winlen": self.winlen, "stride": self.stride,
                "padding_mode": self.padding_mode,
                "padding": list(self.padding),
                "bias": self.has_bias,
                "activation": activation_name(self.fun)}

    @classmethod
    def _from_json(cls, obj):
        mode = obj.get("padding_mode", "same")
        layer = cls(obj["insize"], obj["size"], obj["winlen"],
                    stride=obj.get("stride", 1),
                    has_bias=obj.get("bias", False),
                    fun=activation_from_name(obj.get("activation", "tanh")),
                    padding_mode=tuple(mode) if isinstance(mode, list)
                    else mode)
        return _with_params(layer, obj)


def _with_params(layer, obj):
    """(layer, tree) with the JSON parameters loaded when present."""
    if "params" not in obj:
        return layer, None
    tree = params_from_json(obj["params"])
    layer.load_param_tree(tree)
    return layer, tree
