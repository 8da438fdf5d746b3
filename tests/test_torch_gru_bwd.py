"""The port's GRU backward against the JAX package's (CPU).

(a) The plain backward twin ``gru_scan_bwd_plain`` against the Pallas VJP
    kernel ``pallas_gru._pallas_scan_bwd`` in interpret mode, on the same
    ``(xp, mask, sWT, sW2T, g, h_out)`` made with numpy: forward and
    reverse, a ragged mask and an odd batch.  dxp is compared under the
    mask, dsWT and dsW2T whole, at atol 1e-5 (float32 products summed in
    another order over T*B rows of O(1) values).
(b) ``GruFunction`` on the CPU against autograd through the plain forward
    twin ``gru_scan_plain``: the same math differentiated two ways, at atol
    1e-5.
The einsum twin of ``gru_wgrad.cu`` is held against (a)'s per-step sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sloika_tpu.nn import pallas_gru
from sloika_tpu_torch.nn.fused_gru import (GruFunction, gru_scan_bwd_plain,
                                           gru_scan_plain, gru_wgrad_plain,
                                           h_prev_of)

ATOL = 1e-5


def _case(S, T=23, B=5, seed=0):
    rs = np.random.RandomState(seed)
    xp = rs.normal(size=(T, B, 3 * S)).astype(np.float32)
    sWT = (rs.normal(size=(S, 2 * S)) / np.sqrt(S)).astype(np.float32)
    sW2T = (rs.normal(size=(S, S)) / np.sqrt(S)).astype(np.float32)
    g = rs.normal(size=(T, B, S)).astype(np.float32)
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T
    mask = np.arange(T)[:, None] < lengths[None, :]
    return xp, sWT, sW2T, mask, g


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_twin_matches_pallas_bwd_kernel(S, reverse):
    xp, sWT, sW2T, mask, g = _case(S)
    txp, tsWT, tsW2T, tmask, tg = _torch(xp, sWT, sW2T, mask, g)
    h_out = gru_scan_plain(txp, tsWT, tsW2T, tmask, reverse)
    dxp, dsWT, dsW2T = gru_scan_bwd_plain(txp, tsWT, tsW2T, tmask, reverse,
                                          tg, h_out)
    ref = pallas_gru._pallas_scan_bwd(
        jnp.asarray(xp), jnp.asarray(mask.astype(np.int8)), jnp.asarray(sWT),
        jnp.asarray(sW2T), reverse, jnp.asarray(g),
        jnp.asarray(h_out.numpy()), None)
    rdxp, rdsWT, rdsW2T = (np.asarray(a) for a in ref)
    assert np.max(np.abs(dxp.numpy() - rdxp) * mask[:, :, None]) <= ATOL
    assert np.max(np.abs(dsWT.numpy() - rdsWT)) <= ATOL
    assert np.max(np.abs(dsW2T.numpy() - rdsW2T)) <= ATOL
    # masked steps get zero dxp, as in the Pallas kernel
    assert not dxp.numpy()[~mask].any()


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_function_matches_autograd_through_plain_scan(reverse):
    xp, sWT, sW2T, mask, g = _case(8, seed=4)
    tmask, tg = _torch(mask, g)
    ins = [t.requires_grad_() for t in _torch(xp, sWT, sW2T)]
    ref_ins = [t.detach().clone().requires_grad_() for t in ins]
    out = GruFunction.apply(*ins, tmask, reverse)
    ref = gru_scan_plain(*ref_ins, tmask, reverse)
    assert torch.equal(out, ref)
    torch.autograd.backward(out, tg)
    torch.autograd.backward(ref, tg)
    for got, want in zip(ins, ref_ins):
        assert float((got.grad - want.grad).abs().max()) <= ATOL


@pytest.mark.parametrize("reverse", [False, True])
def test_wgrad_einsum_twin_matches_per_step_sums(reverse):
    xp, sWT, sW2T, mask, g = _case(16, seed=7)
    txp, tsWT, tsW2T, tmask, tg = _torch(xp, sWT, sW2T, mask, g)
    h_out = gru_scan_plain(txp, tsWT, tsW2T, tmask, reverse)
    dxp, dsWT, dsW2T = gru_scan_bwd_plain(txp, tsWT, tsW2T, tmask, reverse,
                                          tg, h_out)
    h_prev = h_prev_of(h_out, reverse)
    S = h_out.shape[2]
    rh = torch.sigmoid(txp[:, :, S:2 * S] + h_prev @ tsWT[:, S:]) * h_prev
    got = gru_wgrad_plain(h_out, rh, dxp, reverse)
    assert float((got[0] - dsWT).abs().max()) <= ATOL
    assert float((got[1] - dsW2T).abs().max()) <= ATOL


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
def test_gru_layer_records_a_graph_only_when_training(mode):
    """Under autograd a GRU layer goes through ``GruFunction``; under
    ``no_grad`` and ``inference_mode`` it runs the forward alone and
    records nothing."""
    from sloika_tpu_torch import nn as tnn
    layer = tnn.Gru(4, 8, init=tnn.truncated_normal(
        0.5, np.random.RandomState(0)), has_bias=True)
    x = torch.from_numpy(np.random.RandomState(1).normal(
        size=(11, 3, 4)).astype(np.float32))
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference_mode": torch.inference_mode}[mode]
    with ctx():
        out = layer(x, reverse=True)
    if mode == "grad":
        assert type(out.grad_fn).__name__ == "GruFunctionBackward"
    else:
        assert out.grad_fn is None and not out.requires_grad
    with torch.no_grad():
        ref = gru_scan_plain(layer.input_proj(x),
                             layer.sW.reshape(16, 8).t().contiguous(),
                             layer.sW2.t().contiguous(),
                             torch.ones(11, 3, dtype=bool), True)
    assert torch.equal(out.detach(), ref)
