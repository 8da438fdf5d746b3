"""Recurrent layers (cf. ``sloika_tpu/nn/rnn.py``).

The input projection ``x @ iW.T + b`` is hoisted out of the recurrence as
one large matmul.  The recurrence runs one of two routes:

* the kernels: a tanh/sigmoid :class:`Gru` runs
  :class:`~sloika_tpu_torch.nn.fused_gru.GruFunction` and a tanh/sigmoid
  :class:`Lstm` :class:`~sloika_tpu_torch.nn.fused_lstm.LstmFunction`,
  whose forward is the CUDA kernel on the GPU and its plain masked scan on
  the CPU, and whose backward is the matching backward kernels;
* the scan (:meth:`RNNBase.scan`): every other cell, and a GRU or LSTM
  with any other activation, runs its ``step`` in an eager loop over time,
  the JAX package's ``lax.scan`` (``sloika_tpu/nn/rnn.py:49-78``), and is
  differentiated by autograd.  None of these cells has a kernel in the JAX
  package either.  :data:`scan_route` counts its calls.

The route is decided by the activations, before any launch, as the JAX
package's ``_use_fused`` decides (:173-187, :248-260).  A masked step keeps
the carried state, so with tail padding a reverse scan starts at each
sequence's true end; the output at a masked position is unspecified.

Parameter trees, initialiser shapes and JSON are the JAX package's, name for
name, so either package's checkpoints and model JSON load in the other.
"""
import numpy as np
import torch

from sloika_tpu_torch import activations
from sloika_tpu_torch.nn.core import (Layer, register, zeros_init, affine,
                                      activation_name, activation_from_name,
                                      params_from_json)
from sloika_tpu_torch.nn.fused_gru import GruFunction
from sloika_tpu_torch.nn.fused_lstm import LstmFunction

#: added to the forget gate's bias at init (sloika_tpu/nn/rnn.py:38)
_FORGET_BIAS = 2.0


class ScanRoute:
    """Counts the calls of :meth:`RNNBase.scan`: one a layer a forward."""

    def __init__(self):
        self.calls = 0


scan_route = ScanRoute()


def _flat(W):
    """(ngate, size, fan) -> (ngate*size, fan) for a fused matmul."""
    return W.reshape(-1, W.shape[-1])


def _gates(v, n):
    """The n equal column blocks of v (B, n*S)."""
    return v.chunk(n, dim=1)


def _kernel_cell(layer):
    """True where the kernels compute the cell: the tanh/sigmoid GRU and
    LSTM (cf. ``_use_fused``, sloika_tpu/nn/rnn.py:173-187)."""
    return (layer.fun is activations.tanh
            and layer.gatefun is activations.sigmoid)


class RNNBase(Layer):
    """Base of the recurrent layers: ``forward(x, reverse, mask)``.

    A cell defines ``input_proj(x)`` (the input-dependent part of every
    step, for all steps at once), ``initial_state(nbatch, like)`` and
    ``step(xt, state) -> (new_state, output)``; :meth:`scan` runs them."""

    def forward(self, x, reverse=False, mask=None):
        return self.scan(x, reverse=reverse, mask=mask)

    def scan(self, x, reverse=False, mask=None):
        """The recurrence as an eager loop over time (the JAX package's
        ``lax.scan``, sloika_tpu/nn/rnn.py:49-78).

        :param mask: optional (T, B) bool; masked steps leave the carried
            state untouched (their output is the freshly computed one, as
            in JAX: unspecified)
        """
        scan_route.calls += 1
        xp = self.input_proj(x)
        T, B = xp.shape[:2]
        state = self.initial_state(B, xp)
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            new, outs[t] = self.step(xp[t], state)
            if mask is not None:
                m = mask[t][:, None]
                new = (tuple(torch.where(m, a, b) for a, b in zip(new, state))
                       if isinstance(new, tuple)
                       else torch.where(m, new, state))
            state = new
        if T == 0:
            return xp.new_zeros((0, B, self.size))
        return torch.stack(outs)

    def apply_with_lengths(self, x, lengths):
        T = x.shape[0]
        mask = torch.arange(T, device=x.device)[:, None] < lengths[None, :]
        return self(x, mask=mask), lengths

    def initial_state(self, nbatch, like):
        """Zero state (B, size) on ``like``'s device."""
        return like.new_zeros((nbatch, self.size))

    def _json_config(self):
        """(cf. ``sloika_tpu/nn/rnn.py:96-104``: "gate" where the cell has
        a gate function)"""
        res = {"activation": activation_name(self.fun),
               "size": self.size, "insize": self.insize,
               "bias": self.has_bias}
        if hasattr(self, "gatefun"):
            res["gate"] = activation_name(self.gatefun)
        return res

    @classmethod
    def _from_json(cls, obj):
        """(cf. ``sloika_tpu/nn/rnn.py:107-118``)"""
        kwargs = {"has_bias": obj.get("bias", False)}
        if "activation" in obj:
            kwargs["fun"] = activation_from_name(obj["activation"])
        if "gate" in obj:
            kwargs["gatefun"] = activation_from_name(obj["gate"])
        if "peep" in obj:
            kwargs["has_peep"] = obj["peep"]
        return _with_params(cls(obj["insize"], obj["size"], **kwargs), obj)


def _with_params(layer, obj):
    """(layer, tree) with the JSON parameters loaded when present."""
    if "params" not in obj:
        return layer, None
    tree = params_from_json(obj["params"])
    layer.load_param_tree(tree)
    return layer, tree


class _Fused(RNNBase):
    """A cell whose fused weights ``iW`` (G, S, I) and bias ``b`` (G, S)
    give the input projection."""

    def input_proj(self, x):
        return affine(x, _flat(self.iW), self.b.reshape(-1))


@register("recurrent")
class Recurrent(RNNBase):
    """Vanilla RNN: ``state' = f(x iW^T + state sW^T + b)``
    (cf. ``sloika_tpu/nn/rnn.py:121-155``)."""

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 fun=activations.tanh):
        super().__init__()
        self.insize, self.size = insize, size
        self.has_bias, self.fun = has_bias, fun
        S, I = size, insize
        self.iW = self._param(init((S, I)) / np.sqrt(I + S))
        self.sW = self._param(init((S, S)) / np.sqrt(2.0 * S))
        self.b = self._param(init((S,)) if has_bias else zeros_init((S,)))

    def input_proj(self, x):
        return affine(x, self.iW, self.b)

    def step(self, xt, state):
        new = self.fun(xt + affine(state, self.sW))
        return new, new


@register("GRU")
class Gru(_Fused):
    """Gated Recurrent Unit with fused z/r weights and a separate candidate
    matrix ``sW2`` (cf. ``sloika_tpu/nn/rnn.py:158-223``).  Gate order
    (gate-major): ``iW = [z; r; h]``, ``sW = [z; r]``.  The tanh/sigmoid
    cell runs the GRU kernels; any other takes the scan."""

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 fun=activations.tanh, gatefun=activations.sigmoid):
        super().__init__()
        self.insize, self.size = insize, size
        self.has_bias = has_bias
        self.fun, self.gatefun = fun, gatefun
        S, I = size, insize
        self.iW = self._param(init((3, S, I)) / np.sqrt(I + S))
        self.sW = self._param(init((2, S, S)) / np.sqrt(2.0 * S))
        self.sW2 = self._param(init((S, S)) / np.sqrt(2.0 * S))
        self.b = self._param(init((3, S)) if has_bias
                             else zeros_init((3, S)))

    def forward(self, x, reverse=False, mask=None):
        if not _kernel_cell(self):
            return self.scan(x, reverse=reverse, mask=mask)
        xp = self.input_proj(x).contiguous()
        S = self.size
        sWT = self.sW.reshape(2 * S, S).t().contiguous()
        sW2T = self.sW2.t().contiguous()
        if mask is None:
            mask = torch.ones(xp.shape[:2], dtype=torch.bool,
                              device=xp.device)
        return GruFunction.apply(xp, sWT, sW2T, mask.bool(), reverse)

    def step(self, xt, state):
        S = self.size
        vT = xt[:, :2 * S] + affine(state, _flat(self.sW))
        z, r = self.gatefun(vT[:, :S]), self.gatefun(vT[:, S:])
        hbar = self.fun(xt[:, 2 * S:] + affine(r * state, self.sW2))
        new = z * state + (1 - z) * hbar
        return new, new


class _Peephole(_Fused):
    """Shared parameters of the LSTM family: ``iW`` (G, S, I), ``sW``
    (G, S, S), ``b`` (G, S) with the forget bias on gate ``forget``, and
    peepholes ``p`` (npeep, S).  Without ``has_peep``, ``p`` stays a
    parameter of zeros that nothing differentiates, so checkpoints and
    optimiser state keep the JAX package's tree."""

    def __init__(self, insize, size, ngate, forget, npeep, init, has_bias,
                 has_peep, fun, gatefun):
        super().__init__()
        self.insize, self.size = insize, size
        self.has_bias, self.has_peep = has_bias, has_peep
        self.fun, self.gatefun = fun, gatefun
        S, I, G = size, insize, ngate
        self.iW = self._param(init((G, S, I)) / np.sqrt(I + S))
        self.sW = self._param(init((G, S, S)) / np.sqrt(2.0 * S))
        b = zeros_init((G, S))
        if has_bias:
            b = init((G, S))
            b[forget] += _FORGET_BIAS
        self.b = self._param(b)
        self.p = self._param(init((npeep, S)) / np.sqrt(S) if has_peep
                             else zeros_init((npeep, S)))

    def peepholes(self):
        """``p``, or without ``has_peep`` ``p`` cut from the graph, as
        ``jax.lax.stop_gradient`` cuts it (sloika_tpu/nn/rnn.py:360): the
        training step gives it JAX's zero gradient."""
        return self.p if self.has_peep else self.p.detach()

    def _json_config(self):
        return {**super()._json_config(), "peep": self.has_peep}


@register("LSTM")
class Lstm(_Peephole):
    """LSTM with peepholes, Currennt-style fused weights
    (cf. ``sloika_tpu/nn/rnn.py:226-313``).  Gate order (gate-major):
    0 candidate, 1 input, 2 forget, 3 output; the forget bias (+2.0)
    initialises gate 2.  The tanh/sigmoid cell runs the LSTM kernels; any
    other takes the scan."""

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 has_peep=False, fun=activations.tanh,
                 gatefun=activations.sigmoid):
        super().__init__(insize, size, 4, 2, 3, init, has_bias, has_peep,
                         fun, gatefun)

    def forward(self, x, reverse=False, mask=None):
        if not _kernel_cell(self):
            return self.scan(x, reverse=reverse, mask=mask)
        xp = self.input_proj(x).contiguous()
        S = self.size
        sWT = self.sW.reshape(4 * S, S).t().contiguous()
        if mask is None:
            mask = torch.ones(xp.shape[:2], dtype=torch.bool,
                              device=xp.device)
        # outside grad mode the peephole parameter is no input to a graph:
        # the forward then runs the kernel's inference variant
        p = self.p if torch.is_grad_enabled() else self.p.detach()
        return LstmFunction.apply(xp, sWT, p, mask.bool(), reverse,
                                  self.has_peep)

    def initial_state(self, nbatch, like):
        z = like.new_zeros((nbatch, self.size))
        return (z, z)  # (output, cell state)

    def step(self, xt, state):
        out_prev, cell = state
        p = self.peepholes()
        g0, g1, g2, g3 = _gates(xt + affine(out_prev, _flat(self.sW)), 4)
        new_cell = cell * self.gatefun(g2 + cell * p[1])
        new_cell = new_cell + self.fun(g0) * self.gatefun(g1 + cell * p[0])
        out = self.fun(new_cell) * self.gatefun(g3 + new_cell * p[2])
        return (out, new_cell), out


@register("LSTM-CIFG")
class LstmCIFG(_Peephole):
    """LSTM with coupled input-forget gates
    (cf. ``sloika_tpu/nn/rnn.py:316-369``).  Gate order: 0 candidate,
    1 forget, 2 output; the input gate is ``1 - forget``."""

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 has_peep=False, fun=activations.tanh,
                 gatefun=activations.sigmoid):
        super().__init__(insize, size, 3, 1, 2, init, has_bias, has_peep,
                         fun, gatefun)

    def initial_state(self, nbatch, like):
        z = like.new_zeros((nbatch, self.size))
        return (z, z)

    def step(self, xt, state):
        out_prev, cell = state
        p = self.peepholes()
        g0, g1, g2 = _gates(xt + affine(out_prev, _flat(self.sW)), 3)
        forget = self.gatefun(g1 + cell * p[0])
        new_cell = cell * forget + self.fun(g0) * (1 - forget)
        out = self.fun(new_cell) * self.gatefun(g2 + new_cell * p[1])
        return (out, new_cell), out


@register("LSTM-O")
class LstmO(_Peephole):
    """LSTM with peepholes but no output gate
    (cf. ``sloika_tpu/nn/rnn.py:372-421``).  Gate order: 0 candidate,
    1 input, 2 forget."""

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 has_peep=False, fun=activations.tanh,
                 gatefun=activations.sigmoid):
        super().__init__(insize, size, 3, 2, 3, init, has_bias, has_peep,
                         fun, gatefun)

    def step(self, xt, state):
        p = self.peepholes()
        g0, g1, g2 = _gates(xt + affine(state, _flat(self.sW)), 3)
        new = state * self.gatefun(g2 + state * p[2])
        new = new + self.fun(g0 + state * p[0]) * self.gatefun(
            g1 + state * p[1])
        return new, new


@register("forget gate")
class Forget(_Fused):
    """Minimal forget-gate RNN (cf. ``sloika_tpu/nn/rnn.py:424-464``).
    Gate order: 0 forget gate (the forget bias), 1 candidate."""

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 fun=activations.tanh, gatefun=activations.sigmoid):
        super().__init__()
        self.insize, self.size = insize, size
        self.has_bias = has_bias
        self.fun, self.gatefun = fun, gatefun
        S, I = size, insize
        self.iW = self._param(init((2, S, I)) / np.sqrt(I + S))
        self.sW = self._param(init((2, S, S)) / np.sqrt(2.0 * S))
        b = zeros_init((2, S))
        if has_bias:
            b = init((2, S))
            b[0] += _FORGET_BIAS
        self.b = self._param(b)

    def step(self, xt, state):
        vf, vc = _gates(xt + affine(state, _flat(self.sW)), 2)
        forget = self.gatefun(vf)
        new = state * forget + (1.0 - forget) * self.fun(vc)
        return new, new


@register("SCRN")
class Scrn(RNNBase):
    """Structurally Constrained RNN (cf. ``sloika_tpu/nn/rnn.py:467-531``)::

        slow' = (1 - a) * (x isW^T) + a * slow
        fast' = fun(slow' sfW^T + x ifW^T + fast ffW^T)
        out   = [fast', slow']

    Its size is fast + slow, and it has no bias."""

    def __init__(self, insize, fast_size, slow_size, init=zeros_init,
                 alpha=0.95, fun=activations.sigmoid):
        super().__init__()
        self.insize = insize
        self.fast_size, self.slow_size = fast_size, slow_size
        self.size = fast_size + slow_size
        self.alpha = alpha
        self.fun = fun
        self.has_bias = False
        I, F, S = insize, fast_size, slow_size
        self.isW = self._param(init((S, I)) / np.sqrt(S + I))
        self.sfW = self._param(init((F, S)) / np.sqrt(F + S))
        self.ifW = self._param(init((F, I)) / np.sqrt(F + I))
        self.ffW = self._param(init((F, F)) / np.sqrt(2.0 * F))

    def input_proj(self, x):
        return torch.cat([affine(x, self.isW), affine(x, self.ifW)], dim=2)

    def step(self, xt, state):
        F, S = self.fast_size, self.slow_size
        fast, slow = state[:, :F], state[:, F:]
        iU, iV = xt[:, :S], xt[:, S:]
        slow_out = (1.0 - self.alpha) * iU + self.alpha * slow
        fast_out = self.fun(affine(slow_out, self.sfW) + iV
                            + affine(fast, self.ffW))
        new = torch.cat([fast_out, slow_out], dim=1)
        return new, new

    def _json_config(self):
        return {"activation": activation_name(self.fun),
                "size": self.size, "fast_size": self.fast_size,
                "slow_size": self.slow_size, "insize": self.insize,
                "alpha": float(self.alpha)}

    @classmethod
    def _from_json(cls, obj):
        layer = cls(obj["insize"], obj["fast_size"], obj["slow_size"],
                    alpha=obj.get("alpha", 0.95),
                    fun=activation_from_name(obj.get("activation",
                                                     "sigmoid")))
        return _with_params(layer, obj)


class _MutBase(RNNBase):
    """Shared parameters of the MUT variants
    (cf. ``sloika_tpu/nn/rnn.py:534-571``): one (S, fan) matrix each of
    ``_XMATS`` (input) and ``_HMATS`` (state), and the biases ``b_z``
    (the forget bias), ``b_r``, ``b_h`` and ``b_u``."""

    _XMATS = ()
    _HMATS = ()

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 fun=activations.tanh, gatefun=activations.sigmoid):
        super().__init__()
        self.insize, self.size = insize, size
        self.has_bias = has_bias
        self.fun, self.gatefun = fun, gatefun
        S, I = size, insize
        for nm in self._XMATS + self._HMATS:
            fan_in = I if nm.startswith("W_x") else S
            setattr(self, nm, self._param(init((S, fan_in))
                                          / np.sqrt(fan_in + S)))
        for nm in ("b_z", "b_r", "b_h", "b_u"):
            b = init((S,)) if has_bias else zeros_init((S,))
            if has_bias and nm == "b_z":
                b = b + _FORGET_BIAS
            setattr(self, nm, self._param(b))


@register("MUT1")
class Mut1(_MutBase):
    """MUT1 (cf. ``sloika_tpu/nn/rnn.py:574-597``)::

        u = f(x W_xu + b_u);  z = g(x W_xz + b_z);  r = g(x W_xr + h W_hr + b_r)
        h' = f((r*h) W_hh + u + b_h) * z + (1 - z) * h
    """

    _XMATS = ("W_xu", "W_xz", "W_xr")
    _HMATS = ("W_hr", "W_hh")

    def input_proj(self, x):
        u = self.fun(affine(x, self.W_xu, self.b_u))
        z = self.gatefun(affine(x, self.W_xz, self.b_z))
        return torch.cat([u, z, affine(x, self.W_xr, self.b_r)], dim=2)

    def step(self, xt, state):
        u, z, rx = _gates(xt, 3)
        r = self.gatefun(rx + affine(state, self.W_hr))
        y = affine(r * state, self.W_hh)
        new = self.fun(y + u + self.b_h) * z + (1 - z) * state
        return new, new


@register("MUT2")
class Mut2(_MutBase):
    """MUT2 (cf. ``sloika_tpu/nn/rnn.py:600-625``)::

        u = f(x W_xu + b_u);  r = g(u + h W_hr + b_r);  z = g(x W_xz + h W_hz + b_z)
        h' = f((r*h) W_hh + x W_xh + b_h) * z + (1 - z) * h
    """

    _XMATS = ("W_xu", "W_xz", "W_xh")
    _HMATS = ("W_hz", "W_hr", "W_hh")

    def input_proj(self, x):
        u = self.fun(affine(x, self.W_xu, self.b_u))
        return torch.cat([u, affine(x, self.W_xz, self.b_z),
                          affine(x, self.W_xh)], dim=2)

    def step(self, xt, state):
        u, zx, v = _gates(xt, 3)
        z = self.gatefun(zx + affine(state, self.W_hz))
        r = self.gatefun(u + affine(state, self.W_hr) + self.b_r)
        y = affine(r * state, self.W_hh)
        new = self.fun(y + v + self.b_h) * z + (1 - z) * state
        return new, new


@register("MUT3")
class Mut3(_MutBase):
    """MUT3 (cf. ``sloika_tpu/nn/rnn.py:628-653``)::

        r = g(x W_xr + h W_hr + b_r);  z = g(x W_xz + f(h) W_hz + b_z)
        h' = f((r*h) W_hh + x W_xh + b_h) * z + (1 - z) * h

    ``W_xu`` and ``b_u`` stay in the tree for interchange and are never
    used, as in the JAX package (:637-644); the training step gives them
    the zero gradient JAX gives an unused parameter."""

    _XMATS = ("W_xu", "W_xz", "W_xr", "W_xh")
    _HMATS = ("W_hz", "W_hr", "W_hh")

    def input_proj(self, x):
        return torch.cat([affine(x, self.W_xz, self.b_z),
                          affine(x, self.W_xr, self.b_r),
                          affine(x, self.W_xh)], dim=2)

    def step(self, xt, state):
        zx, rx, v = _gates(xt, 3)
        z = self.gatefun(zx + affine(self.fun(state), self.W_hz))
        r = self.gatefun(rx + affine(state, self.W_hr))
        y = affine(r * state, self.W_hh)
        new = self.fun(y + v + self.b_h) * z + (1 - z) * state
        return new, new


@register("Genmut")
class Genmut(RNNBase):
    """Generalised MUT1 with fused 3-gate weights
    (cf. ``sloika_tpu/nn/rnn.py:656-700``).  Gate order: 0 u (candidate
    input), 1 r (reset), 2 z (keep)."""

    def __init__(self, insize, size, init=zeros_init, has_bias=False,
                 fun=activations.tanh, gatefun=activations.sigmoid):
        super().__init__()
        self.insize, self.size = insize, size
        self.has_bias = has_bias
        self.fun, self.gatefun = fun, gatefun
        S, I = size, insize
        self.xW = self._param(init((3, S, I)) / np.sqrt(I + S))
        self.sW = self._param(init((3, S, S)) / np.sqrt(2.0 * S))
        self.sW2 = self._param(init((S, S)) / np.sqrt(2.0 * S))
        self.b = self._param(init((3, S)) if has_bias
                             else zeros_init((3, S)))
        self.b2 = self._param(init((S,)) if has_bias else zeros_init((S,)))

    def input_proj(self, x):
        return affine(x, _flat(self.xW), self.b.reshape(-1))

    def step(self, xt, state):
        iu, ir, iz = _gates(xt + affine(state, _flat(self.sW)), 3)
        u, r, z = self.fun(iu), self.gatefun(ir), self.gatefun(iz)
        y = affine(r * state, self.sW2)
        new = self.fun(y + u + self.b2) * z + (1 - z) * state
        return new, new
