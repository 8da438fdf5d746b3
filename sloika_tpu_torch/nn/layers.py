"""Non-recurrent layers of the ported slice (cf. ``sloika_tpu/nn/layers.py``):
``Convolution``, ``FeedForward`` (JSON ``feed-forward``), ``Window``,
``Softmax`` (JSON ``softmax_old``) and ``SoftmaxTheano`` (JSON
``softmax``).  Initialisation scaling matches the JAX package."""
import numpy as np
import torch

from sloika_tpu_torch import activations
from sloika_tpu_torch.nn.core import (Layer, register, zeros_init, affine,
                                      activation_name, activation_from_name,
                                      params_from_json)
from sloika_tpu_torch.ops import conv as convops


class _Affine(Layer):
    """Shared parameters of ``FeedForward`` and ``Softmax``
    (cf. ``sloika_tpu/nn/layers.py:40-74``)."""

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

    def _json_config(self):
        return {"size": self.size, "insize": self.insize,
                "bias": self.has_bias}

    @classmethod
    def _from_json(cls, obj):
        layer = cls(obj["insize"], obj["size"],
                    has_bias=obj.get("bias", False))
        return _with_params(layer, obj)


@register("feed-forward")
class FeedForward(_Affine):
    """``out = f(x W^T + b)`` (cf. ``sloika_tpu/nn/layers.py:77-90``)."""

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 fun=activations.tanh):
        super().__init__(insize, size, init=init, has_bias=has_bias)
        self.fun = fun

    def forward(self, x):
        return self.fun(self.logits(x))

    def _json_config(self):
        return {"activation": activation_name(self.fun),
                **super()._json_config()}

    @classmethod
    def _from_json(cls, obj):
        layer = cls(obj["insize"], obj["size"],
                    has_bias=obj.get("bias", False),
                    fun=activation_from_name(obj.get("activation", "tanh")))
        return _with_params(layer, obj)


@register("softmax_old")
class Softmax(_Affine):
    """Affine followed by a max-shifted softmax over the features."""

    def forward(self, x):
        tmp = self.logits(x)
        m = torch.amax(tmp, dim=2, keepdim=True)
        out = torch.exp(tmp - m)
        return out / torch.sum(out, dim=2, keepdim=True)


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


@register("window")
class Window(Layer):
    """Sliding window of odd width ``w`` over time, zero-padded so the
    output length equals the input length; output features are the window
    contents ordered earliest to latest (cf. ``sloika_tpu/nn/layers.py:
    173-204``).  With tail-padded batches, a window at a sequence's last
    valid step reads the batch's zero padding, which equals the sequence's
    own zero extension, so the default ``apply_with_lengths`` is exact."""

    def __init__(self, insize, w):
        super().__init__()
        if w <= 0 or w % 2 != 1:
            raise ValueError("Window size must be positive and odd")
        self.insize, self.size = insize, w * insize
        self.w = w

    def forward(self, x):
        pad = self.w // 2
        xp = torch.nn.functional.pad(x, (0, 0, 0, 0, pad, pad))
        ntime = x.shape[0]
        return torch.cat([xp[i:i + ntime] for i in range(self.w)], dim=2)

    def _json_config(self):
        return {"w": self.w, "insize": self.insize}

    @classmethod
    def _from_json(cls, obj):
        w = obj.get("w", obj.get("params", {}).get("w", 3))
        return cls(obj["insize"], int(w)), {}


def _with_params(layer, obj):
    """(layer, tree) with the JSON parameters loaded when present."""
    if "params" not in obj:
        return layer, None
    tree = params_from_json(obj["params"])
    layer.load_param_tree(tree)
    return layer, tree
