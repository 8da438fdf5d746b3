"""Non-recurrent layers (cf. ``sloika_tpu/nn/layers.py``): ``Identity``,
``FeedForward`` (JSON ``feed-forward``), ``Softmax`` (JSON
``softmax_old``), ``SoftmaxTheano`` (JSON ``softmax``), ``Studentise``,
``NormaliseL1`` (JSON ``normaliseL1``), ``Window``, ``Convolution``,
``MaxPool`` (JSON ``max_pool``) and, the port's alone, bonito's CRF head
``LinearCRF`` (JSON ``linear_crf``).  Initialisation scaling matches the JAX
package."""
import numpy as np
import torch

from sloika_tpu_torch import activations
from sloika_tpu_torch.nn.core import (Layer, register, zeros_init, affine,
                                      activation_name, activation_from_name,
                                      params_from_json)
from sloika_tpu_torch.ops import conv as convops


@register("identity")
class Identity(Layer):
    """(cf. ``sloika_tpu/nn/layers.py:19-37``)"""

    def __init__(self, insize):
        super().__init__()
        self.insize = self.size = insize

    def forward(self, x):
        return x

    def _json_config(self):
        return {"insize": self.insize}

    @classmethod
    def _from_json(cls, obj):
        return cls(obj.get("insize", 0)), {}


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


@register("studentise")
class Studentise(Layer):
    """Normalise each feature over the (time, batch) axes
    (cf. ``sloika_tpu/nn/layers.py:116-144``).  Its statistics span the
    whole batch, so it has no meaning for a padded batch:
    :meth:`apply_with_lengths` raises, as in the JAX package, and the
    Basecaller runs such a model one unpadded read at a time."""

    def __init__(self, insize, epsilon=1e-4):
        super().__init__()
        self.insize = self.size = insize
        self.epsilon = epsilon

    def forward(self, x):
        m = torch.mean(x, dim=(0, 1), keepdim=True)
        v = torch.var(x, dim=(0, 1), keepdim=True, correction=0)
        return (x - m) / torch.sqrt(v + self.epsilon)

    def apply_with_lengths(self, x, lengths):
        raise NotImplementedError(
            "Studentise mixes statistics across the whole batch and is not "
            "defined for padded variable-length batches")

    def _json_config(self):
        return {"insize": self.insize}

    @classmethod
    def _from_json(cls, obj):
        return cls(obj.get("insize", 0)), {}


@register("normaliseL1")
class NormaliseL1(Layer):
    """Divide by the L1 norm over the features
    (cf. ``sloika_tpu/nn/layers.py:147-171``)."""

    def __init__(self, insize, epsilon=1e-4):
        super().__init__()
        self.insize = self.size = insize
        self.epsilon = epsilon

    def forward(self, x):
        return x / (self.epsilon + torch.sum(torch.abs(x), dim=2,
                                             keepdim=True))

    def _json_config(self):
        return {"insize": self.insize}

    @classmethod
    def _from_json(cls, obj):
        return cls(obj.get("insize", 0)), {}


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
                    padding_mode=_padding_mode_from_json(mode))
        return _with_params(layer, obj)


@register("max_pool")
class MaxPool(Layer):
    """1-D temporal max pooling over zero padding
    (cf. ``sloika_tpu/nn/layers.py:271-306``)."""

    def __init__(self, insize, pool_size, stride, fun=activations.linear,
                 padding_mode='same'):
        super().__init__()
        self.insize = self.size = insize
        self.pool_size = pool_size
        self.stride = stride
        self.fun = fun
        self.padding_mode = padding_mode
        self.padding = convops.calculate_padding(padding_mode, pool_size)

    def forward(self, x):
        return self.fun(convops.pool_1d(x, self.pool_size, self.stride,
                                        self.padding))

    def apply_with_lengths(self, x, lengths):
        out_lengths = 1 + torch.div(
            lengths + sum(self.padding) - self.pool_size, self.stride,
            rounding_mode="floor")
        return self(x), out_lengths

    def _json_config(self):
        return {"insize": self.insize, "pool_size": self.pool_size,
                "stride": self.stride, "padding_mode": self.padding_mode,
                "padding": list(self.padding),
                "activation": activation_name(self.fun)}

    @classmethod
    def _from_json(cls, obj):
        layer = cls(obj["insize"], obj["pool_size"], obj["stride"],
                    fun=activation_from_name(obj.get("activation",
                                                     "linear")),
                    padding_mode=_padding_mode_from_json(
                        obj.get("padding_mode", "same")))
        return layer, {}


@register("linear_crf")
class LinearCRF(Layer):
    """bonito's ``LinearCRFEncoder`` (``bonito/crf/model.py``), the head of
    its CRF basecallers: scores ``tanh(x W^T + b) * scale``, W
    (nbase^(state_len + 1), I), viewed as nbase^state_len groups of nbase,
    with ``blank_score`` put in front of each group.  A frame's (nstate,
    nbase + 1) scores are the CTC-CRF's transitions into each state s:
    [s, 0] the stay, [s, k] the step from state (k - 1) nstate/nbase +
    s // nbase (``ops/crf_decode.crf_idx``).  Its size is nstate x
    (nbase + 1), 1,280 at nbase 4 and state_len 4."""

    def __init__(self, insize, nbase=4, state_len=4, scale=5.0,
                 blank_score=2.0, init=zeros_init, has_bias=True):
        super().__init__()
        self.insize = insize
        self.nbase, self.state_len = nbase, state_len
        self.scale, self.blank_score = float(scale), float(blank_score)
        self.has_bias = has_bias
        self.nstate = nbase ** state_len
        self.size = self.nstate * (nbase + 1)
        out = nbase ** (state_len + 1)
        self.W = self._param(init((out, insize)) / np.sqrt(out + insize))
        self.b = self._param(init((out,)) if has_bias
                             else zeros_init((out,)))

    def forward(self, x):
        scores = torch.tanh(affine(x, self.W, self.b)) * self.scale
        T, B, _ = scores.shape
        scores = scores.reshape(T, B, self.nstate, self.nbase)
        blank = scores.new_full((T, B, self.nstate, 1), self.blank_score)
        return torch.cat([blank, scores], dim=3).reshape(T, B, self.size)

    def _json_config(self):
        return {"insize": self.insize, "nbase": self.nbase,
                "state_len": self.state_len, "scale": self.scale,
                "blank_score": self.blank_score, "bias": self.has_bias}

    @classmethod
    def _from_json(cls, obj):
        layer = cls(obj["insize"], nbase=obj.get("nbase", 4),
                    state_len=obj.get("state_len", 4),
                    scale=obj.get("scale", 5.0),
                    blank_score=obj.get("blank_score", 2.0),
                    has_bias=obj.get("bias", True))
        return _with_params(layer, obj)


def _padding_mode_from_json(mode):
    """JSON round-trips (int, int) padding modes as lists."""
    return tuple(mode) if isinstance(mode, list) else mode


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
