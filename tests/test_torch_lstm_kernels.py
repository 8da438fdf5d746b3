"""The port's LSTM CUDA kernels against their plain PyTorch twins.

This file imports no jax, so the ``gpu``-marked tests run on a machine with
a CUDA card and without jax::

    python -m pytest tests/test_torch_lstm_kernels.py -m gpu --noconftest -q

On a machine without a card they skip; the CPU tests check that each
wrapper hands CPU tensors to its plain twin without counting a launch, and
that the einsum twin of the weight sums equals the backward twin's own.
"""
import numpy as np
import pytest
import torch

from sloika_tpu_torch import nn as tnn
from sloika_tpu_torch.nn.fused_lstm import (
    LstmFunction, lstm_backward, lstm_forward, lstm_scan_bwd_plain,
    lstm_scan_plain, lstm_wgrad, lstm_wgrad_plain)

#: forward kernel against its twin: max abs difference on valid steps
#: (float32 sums in another order over up to a few thousand steps)
FWD_ATOL = 1e-4
#: backward kernels against the twin: max|kernel - twin| / max|twin|
BWD_RTOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def lstm_inputs(T, B, S, seed=2, peep=True):
    """xp, sWT, p at the layer's own scales, and a ragged (T, B) mask."""
    rs = np.random.RandomState(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    xp = f32(rs.normal(size=(T, B, 4 * S)))
    sWT = f32(rs.normal(size=(S, 4 * S)) / np.sqrt(2 * S))
    p = f32(rs.normal(size=(3, S)) / np.sqrt(S) if peep else np.zeros((3, S)))
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T
    mask = torch.from_numpy(np.arange(T)[:, None] < lengths[None, :])
    return xp, sWT, p, mask


def _cotangent(T, B, S, seed=3):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.normal(size=(T, B, S)).astype(np.float32))


def _rel_err(got, ref, mask=None):
    d = (got - ref).abs()
    if mask is not None:
        d = d * mask[:, :, None]
    return float(d.max()) / max(float(ref.abs().max()), 1e-30)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_cpu_dispatch_is_the_plain_twin(reverse):
    xp, sWT, p, mask = lstm_inputs(9, 3, 8)
    g = _cotangent(9, 3, 8)
    before = (lstm_forward.launches, lstm_backward.launches,
              lstm_wgrad.launches)
    h, c = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse)
    href, cref = lstm_scan_plain(xp, sWT, p, mask, reverse)
    assert torch.equal(h, href) and torch.equal(c, cref)
    h2, none = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                            emit_cout=False)
    assert none is None and torch.equal(h2, href)
    got = lstm_backward(xp, sWT, p, mask, reverse, g, h, c)
    ref = lstm_scan_bwd_plain(xp, sWT, p, mask, reverse, g, h, c)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (lstm_forward.launches, lstm_backward.launches,
            lstm_wgrad.launches) == before
    # the einsum twin of the weight sums gives the backward twin's sums
    w = lstm_wgrad(h, c, got[0], reverse)
    for a, b in zip(w, got[1:]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 64, 130, 256])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_forward_kernel_matches_twin(cuda_device, S, reverse):
    """Both variants; S = 130 and 256 read sWT through L1 (it does not fit
    shared memory)."""
    xp, sWT, p, mask = [a.to(cuda_device) for a in lstm_inputs(301, 19, S)]
    before = lstm_forward.launches
    h, c = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse)
    h2, none = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                            emit_cout=False)
    assert lstm_forward.launches == before + 2 and none is None
    href, cref = lstm_scan_plain(xp, sWT, p, mask, reverse)
    m = mask[:, :, None]
    assert float(((h - href).abs() * m).max()) <= FWD_ATOL
    assert float(((c - cref).abs() * m).max()) <= FWD_ATOL
    assert torch.equal(h, h2)


@pytest.mark.gpu
def test_lstm_kernels_reject_bad_inputs(cuda_device):
    xp, sWT, p, mask = [a.to(cuda_device) for a in lstm_inputs(5, 2, 8)]
    with pytest.raises(ValueError):
        lstm_forward(xp.transpose(0, 1), sWT, p)           # wrong shape
    with pytest.raises(ValueError):
        lstm_forward(xp, sWT, p.t().contiguous().t())      # not contiguous
    with pytest.raises(ValueError):
        lstm_forward(xp, sWT.cpu(), p)                     # wrong device
    big = torch.zeros((2, 1, 4 * 257), device=cuda_device)
    with pytest.raises(ValueError, match="256"):
        lstm_forward(big, torch.zeros((257, 4 * 257), device=cuda_device),
                     torch.zeros((3, 257), device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 64, 130])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_backward_kernels_match_twin(cuda_device, S, reverse):
    T, B = 211, 19
    xp, sWT, p, mask = [a.to(cuda_device) for a in lstm_inputs(T, B, S)]
    g = _cotangent(T, B, S).to(cuda_device)
    h, c = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse)
    before = (lstm_backward.launches, lstm_wgrad.launches)
    got = lstm_backward(xp, sWT, p, mask, reverse, g, h, c)
    assert (lstm_backward.launches, lstm_wgrad.launches) == (
        before[0] + 1, before[1] + 1)
    ref = lstm_scan_bwd_plain(xp, sWT, p, mask, reverse, g, h, c)
    assert _rel_err(got[0], ref[0], mask) <= BWD_RTOL
    assert not got[0][~mask].any()
    assert _rel_err(got[1], ref[1]) <= BWD_RTOL
    assert _rel_err(got[2], ref[2]) <= BWD_RTOL
    # fixed-order sums: the same bits from run to run
    again = lstm_backward(xp, sWT, p, mask, reverse, g, h, c)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the weight-cotangent kernel against its einsum twin on the same rows
    wk = lstm_wgrad(h, c, got[0], reverse)
    wp = lstm_wgrad_plain(h, c, got[0], reverse)
    assert all(_rel_err(a, b) <= BWD_RTOL for a, b in zip(wk, wp))


@pytest.mark.gpu
@pytest.mark.parametrize("S,B", [(64, 200), (64, 600), (256, 1100)])
def test_lstm_kernels_wide_batches(cuda_device, S, B):
    """Batches that take 2, 4 and 8 rows per block, and a width (S = 256)
    whose 8-row block may not fit the SM's registers."""
    T = 37
    xp, sWT, p, mask = [a.to(cuda_device) for a in lstm_inputs(T, B, S)]
    g = _cotangent(T, B, S).to(cuda_device)
    h, c = lstm_forward(xp, sWT, p, mask=mask, reverse=True)
    href, cref = lstm_scan_plain(xp, sWT, p, mask, True)
    assert float(((h - href).abs() * mask[:, :, None]).max()) <= FWD_ATOL
    got = lstm_backward(xp, sWT, p, mask, True, g, h, c)
    ref = lstm_scan_bwd_plain(xp, sWT, p, mask, True, g, h, c)
    assert _rel_err(got[0], ref[0], mask) <= BWD_RTOL
    assert _rel_err(got[1], ref[1]) <= BWD_RTOL
    assert _rel_err(got[2], ref[2]) <= BWD_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("peep", [True, False])
def test_lstm_layer_gradients_match_cpu(cuda_device, peep):
    """An LSTM layer under autograd on the card runs the three kernels and
    gives the CPU twins' gradients; under no_grad only the forward, without
    the cell trace."""
    layer = tnn.Lstm(6, 16, init=tnn.truncated_normal(
        0.5, np.random.RandomState(1)), has_bias=True, has_peep=peep)
    x = torch.from_numpy(np.random.RandomState(2).normal(
        size=(157, 7, 6)).astype(np.float32))
    mask = torch.from_numpy(np.arange(157)[:, None]
                            < np.array([157, 3, 90, 157, 1, 40, 156]))
    grads = []
    for dev in ("cpu", cuda_device):
        layer.zero_grad()
        gpu = layer.to(dev)
        n0 = (lstm_forward.launches, lstm_backward.launches,
              lstm_wgrad.launches)
        out = gpu(x.to(dev), reverse=True, mask=mask.to(dev))
        (out * mask.to(dev)[:, :, None]).square().sum().backward()
        n1 = (lstm_forward.launches, lstm_backward.launches,
              lstm_wgrad.launches)
        assert n1 == (tuple(n + 1 for n in n0) if dev != "cpu" else n0)
        grads.append([p.grad.cpu() for p in gpu.parameters()])
    assert all(_rel_err(a, b) <= BWD_RTOL for a, b in zip(*grads))
    if not peep:
        assert not grads[1][-1].any()
    with torch.no_grad():
        layer(x.to(cuda_device))
    assert (lstm_forward.launches, lstm_backward.launches) == (n1[0] + 1,
                                                               n1[1])


def test_lstm_function_emits_the_cell_trace_only_for_gradients(monkeypatch):
    """Outside autograd the no-cout variant runs (cf. ``lstm_fused``)."""
    xp, sWT, p, mask = lstm_inputs(7, 2, 4)
    seen = []
    real = lstm_forward.__call__

    def spy(*a, **k):
        seen.append(k["emit_cout"])
        return real(*a, **k)

    monkeypatch.setattr(type(lstm_forward), "__call__",
                        lambda self, *a, **k: spy(*a, **k))
    with torch.no_grad():
        LstmFunction.apply(xp, sWT, p, mask, False, True)
    LstmFunction.apply(xp.requires_grad_(), sWT, p, mask, False, True)
    assert seen == [False, True]
