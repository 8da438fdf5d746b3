"""The port's peephole LSTM recurrence against the JAX Pallas LSTM (CPU).

The Pallas kernels run in interpret mode, as ``tests/test_pallas_lstm.py``
runs them.  Weights are drawn with numpy at the layer's own scales
(1/sqrt(2S) for the recurrent weights, 1/sqrt(S) for the peepholes).
Tolerances:

* forward: h and c within 1e-5 absolute under the mask (the emitted value
  at a masked step is unspecified, ``rnn.py:65-70``);
* gradients (dxp, dsWT, dp) of a masked loss through
  :class:`LstmFunction` (whose backward reads the forward's gate trace)
  against ``jax.grad`` through ``run_lstm_fused``: max|port - jax| <=
  1e-5 * max|jax| (float32 sums in another order);
* the backward twin from the gate trace, ``lstm_scan_bwd_gates_plain``,
  against the Pallas VJP kernel ``_pallas_scan_bwd`` on a mask with
  interior holes and a row masked throughout, at the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sloika_tpu.nn import pallas_lstm
from sloika_tpu_torch.nn.fused_lstm import (LstmFunction, lstm_forward,
                                            lstm_scan_bwd_gates_plain,
                                            lstm_scan_plain)

T, B, S = 23, 4, 16
LENGTHS = np.array([23, 9, 1, 17])


def _inputs(peep, seed=0):
    rs = np.random.RandomState(seed)
    xp = rs.normal(size=(T, B, 4 * S)).astype(np.float32)
    sW = (rs.normal(size=(4, S, S)) / np.sqrt(2 * S)).astype(np.float32)
    p = ((rs.normal(size=(3, S)) / np.sqrt(S)) if peep
         else np.zeros((3, S))).astype(np.float32)
    mask = np.arange(T)[:, None] < LENGTHS[None, :]
    return xp, sW, p, mask


def _sWT(sW):
    return np.ascontiguousarray(sW.reshape(4 * S, S).T)


@pytest.mark.parametrize("peep", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_forward_matches_pallas(reverse, peep):
    xp, sW, p, mask = _inputs(peep)
    sWT = _sWT(sW)
    jh, jc = pallas_lstm._pallas_scan(jnp.asarray(xp),
                                      jnp.asarray(mask.astype(np.int8)),
                                      jnp.asarray(sWT), jnp.asarray(p),
                                      reverse)
    jh_nc, _ = pallas_lstm._pallas_scan(jnp.asarray(xp),
                                        jnp.asarray(mask.astype(np.int8)),
                                        jnp.asarray(sWT), jnp.asarray(p),
                                        reverse, emit_cout=False)
    t = torch.from_numpy
    h, c = lstm_forward(t(xp), t(sWT), t(p), mask=t(mask), reverse=reverse)
    h_nc, none = lstm_forward(t(xp), t(sWT), t(p), mask=t(mask),
                              reverse=reverse, emit_cout=False)
    assert none is None
    m = mask[:, :, None]
    for got, ref in ((h, jh), (c, jc), (h_nc, jh_nc)):
        assert np.max(np.abs(got.numpy() - np.asarray(ref)) * m) <= 1e-5


@pytest.mark.parametrize("reverse,peep", [(False, True), (True, True),
                                          (True, False)])
def test_gradients_match_jax_grad(reverse, peep):
    xp, sW, p, mask = _inputs(peep, seed=1)
    sel = np.random.RandomState(2).normal(size=(T, B, S)).astype(np.float32)
    sel *= mask[:, :, None]

    def loss(xp_, sW_, p_):
        out = pallas_lstm.run_lstm_fused({"sW": sW_, "p": p_}, xp_,
                                         reverse=reverse,
                                         mask=jnp.asarray(mask),
                                         has_peep=peep)
        return jnp.sum(out * sel)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(xp), jnp.asarray(sW), jnp.asarray(p))
    jdxp, jdsW, jdp = (np.asarray(g) for g in jgrads)
    # sW (4, S, S) is sWT.T reshaped: carry its gradient to the sWT layout
    jdsWT = _sWT(jdsW)

    txp = torch.from_numpy(xp).requires_grad_()
    tsWT = torch.from_numpy(_sWT(sW)).requires_grad_()
    tp = torch.from_numpy(p).requires_grad_()
    out = LstmFunction.apply(txp, tsWT, tp, torch.from_numpy(mask), reverse,
                             peep)
    (out * torch.from_numpy(sel)).sum().backward()
    for got, ref in ((txp.grad, jdxp), (tsWT.grad, jdsWT), (tp.grad, jdp)):
        err = np.max(np.abs(got.numpy() - ref))
        assert err <= 1e-5 * max(np.max(np.abs(ref)), 1e-30)
    if not peep:
        assert not tp.grad.any() and not jdp.any()


@pytest.mark.parametrize("reverse", [False, True])
def test_gate_trace_backward_matches_pallas_bwd_kernel(reverse):
    xp, sW, p, mask = _inputs(True, seed=3)
    mask = mask & (np.random.RandomState(4).uniform(size=mask.shape) < 0.8)
    mask[:, -1] = False
    g = np.random.RandomState(5).normal(size=(T, B, S)).astype(np.float32)
    sWT = _sWT(sW)
    t = torch.from_numpy
    h, c, gates = lstm_scan_plain(t(xp), t(sWT), t(p), t(mask), reverse,
                                  emit_gates=True)
    got = lstm_scan_bwd_gates_plain(gates, t(sWT), t(p), t(mask), reverse,
                                    t(g), h, c)
    ref = pallas_lstm._pallas_scan_bwd(
        jnp.asarray(xp), jnp.asarray(mask.astype(np.int8)), jnp.asarray(sWT),
        jnp.asarray(p), reverse, jnp.asarray(g), jnp.asarray(h.numpy()),
        jnp.asarray(c.numpy()))
    m = mask[:, :, None]
    rdxp = np.asarray(ref[0])
    assert np.max(np.abs(got[0].numpy() - rdxp) * m) <= \
        1e-5 * np.max(np.abs(rdxp) * m)
    for a, b in zip(got[1:], ref[1:]):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= 1e-5 * np.max(np.abs(b))
    assert not got[0].numpy()[~mask].any()
