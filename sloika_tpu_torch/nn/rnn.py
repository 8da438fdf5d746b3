"""Recurrent layers of the ported slice (cf. ``sloika_tpu/nn/rnn.py``).

The input projection ``x @ iW.T + b`` is hoisted out of the recurrence as
one large matmul; the recurrence itself is
:data:`sloika_tpu_torch.nn.fused_gru.gru_forward` (the CUDA kernel on the
GPU, its plain masked scan on the CPU).  A masked step keeps the carried
state, so with tail padding a reverse scan starts at each sequence's true
end; the output at a masked position is unspecified.
"""
import numpy as np
import torch

from sloika_tpu_torch import activations
from sloika_tpu_torch.nn.core import (Layer, register, zeros_init, affine,
                                      activation_name, activation_from_name,
                                      params_from_json)
from sloika_tpu_torch.nn.fused_gru import gru_forward


class RNNBase(Layer):
    """Base of the recurrent layers: ``forward(x, reverse, mask)``."""

    def apply_with_lengths(self, x, lengths):
        T = x.shape[0]
        mask = torch.arange(T, device=x.device)[:, None] < lengths[None, :]
        return self(x, mask=mask), lengths


@register("GRU")
class Gru(RNNBase):
    """Gated Recurrent Unit with fused z/r weights and a separate candidate
    matrix ``sW2``.  Gate order (gate-major): ``iW = [z; r; h]``,
    ``sW = [z; r]``.  Only the standard tanh/sigmoid cell is ported."""

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 fun=activations.tanh, gatefun=activations.sigmoid):
        super().__init__()
        if fun is not activations.tanh or gatefun is not activations.sigmoid:
            raise NotImplementedError(
                "only the tanh/sigmoid GRU is ported (got {}/{})".format(
                    activation_name(fun), activation_name(gatefun)))
        self.insize, self.size = insize, size
        self.has_bias = has_bias
        self.fun, self.gatefun = fun, gatefun
        S, I = size, insize
        self.iW = self._param(init((3, S, I)) / np.sqrt(I + S))
        self.sW = self._param(init((2, S, S)) / np.sqrt(2.0 * S))
        self.sW2 = self._param(init((S, S)) / np.sqrt(2.0 * S))
        self.b = self._param(init((3, S)) if has_bias
                             else zeros_init((3, S)))

    def input_proj(self, x):
        S = self.size
        return affine(x, self.iW.reshape(3 * S, self.insize),
                      self.b.reshape(-1))

    def forward(self, x, reverse=False, mask=None):
        xp = self.input_proj(x).contiguous()
        S = self.size
        sWT = self.sW.reshape(2 * S, S).t().contiguous()
        sW2T = self.sW2.t().contiguous()
        return gru_forward(xp, sWT, sW2T, mask=mask, reverse=reverse)

    def _json_config(self):
        return {"activation": activation_name(self.fun),
                "size": self.size, "insize": self.insize,
                "bias": self.has_bias,
                "gate": activation_name(self.gatefun)}

    @classmethod
    def _from_json(cls, obj):
        kwargs = {"has_bias": obj.get("bias", False)}
        if "activation" in obj:
            kwargs["fun"] = activation_from_name(obj["activation"])
        if "gate" in obj:
            kwargs["gatefun"] = activation_from_name(obj["gate"])
        layer = cls(obj["insize"], obj["size"], **kwargs)
        if "params" not in obj:
            return layer, None
        tree = params_from_json(obj["params"])
        layer.load_param_tree(tree)
        return layer, tree
