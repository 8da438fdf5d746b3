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
from sloika_tpu_torch.nn import fused_lstm
from sloika_tpu_torch.nn.fused_gru import H100_SMS, SMEM_OPTIN
from sloika_tpu_torch.nn.fused_lstm import (
    LstmFunction, LstmWgrad, lstm_backward, lstm_bwd_plan, lstm_forward,
    lstm_fwd_plan, lstm_scan_bwd_gates_plain, lstm_scan_bwd_plain,
    lstm_scan_plain, lstm_wgrad, lstm_wgrad_plain, lstm_wgrad_plan)

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


def _holes(mask, seed=4):
    """The mask with interior masked steps and, where B > 1, its last row
    masked throughout."""
    rs = np.random.RandomState(seed)
    holes = torch.from_numpy(rs.uniform(size=tuple(mask.shape)) < 0.85)
    mask = mask & holes.to(mask.device)
    if mask.shape[1] > 1:
        mask[:, -1] = False
    return mask


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
    h3, c3, gates = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                                 emit_gates=True)
    assert torch.equal(h3, href) and torch.equal(c3, cref)
    got = lstm_backward(gates, sWT, p, mask, reverse, g, h, c)
    ref = lstm_scan_bwd_gates_plain(gates, sWT, p, mask, reverse, g, h, c)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (lstm_forward.launches, lstm_backward.launches,
            lstm_wgrad.launches) == before
    # the einsum twin of the weight sums gives the backward twin's sums
    w = lstm_wgrad(h, c, got[0], reverse)
    for a, b in zip(w, got[1:]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("S,peep", [(8, True), (24, True), (24, False)])
def test_lstm_gate_trace_twins_match_the_recompute_twin(S, peep, reverse):
    """The gate trace of the plain forward, and the plain backward from it,
    give the recompute twin's results (held to ``jax.grad`` through the
    Pallas kernels in ``tests/test_torch_lstm.py``) on holed masks with a
    row masked throughout: the same arithmetic in the same order."""
    T, B = 17, 5
    xp, sWT, p, mask = lstm_inputs(T, B, S, seed=S, peep=peep)
    mask = _holes(mask)
    g = _cotangent(T, B, S)
    h, c, gates = lstm_scan_plain(xp, sWT, p, mask, reverse, emit_gates=True)
    href, cref = lstm_scan_plain(xp, sWT, p, mask, reverse)
    assert torch.equal(h, href) and torch.equal(c, cref)
    assert torch.isfinite(gates).all()
    got = lstm_scan_bwd_gates_plain(gates, sWT, p, mask, reverse, g, h, c)
    ref = lstm_scan_bwd_plain(xp, sWT, p, mask, reverse, g, h, c)
    for a, b in zip(got, ref):
        assert _rel_err(a, b) <= 1e-6
    assert not got[0][~mask].any()


def test_lstm_bwd_plan_at_the_main_paths_shapes():
    """The backward's plan at the event training path's shape (B = 100,
    S = 64): sWT's quarter rows in registers, one row a block, a ring of 4
    step slots (inputs fetched two or more steps ahead), and dg's quarters
    padded off each other's banks."""
    plan = lstm_bwd_plan(100, 64)
    assert (plan["br"], plan["mode"], plan["kq"], plan["stage"]) == (
        1, "registers", 64, 0)
    assert plan["ns"] == 4 and plan["threads"] == 256 and plan["qs"] == 68
    assert lstm_bwd_plan(100, 64) == plan            # shapes alone
    assert lstm_bwd_plan(600, 64)["br"] == 8
    assert lstm_bwd_plan(19, 8)["mode"] == "smem"
    assert lstm_bwd_plan(19, 96)["mode"] == "smem"
    assert lstm_bwd_plan(19, 144)["mode"] == "global"


def test_lstm_fwd_plan_at_the_main_paths_shapes():
    """The forward's plan at both event paths' shapes (B = 64 reads of up
    to 9,000 events, B = 100 training chunks; S = 64): sWT's columns in
    registers, one row a block, an xp ring of 4 step slots, and a mask
    window that holds all 9,000 steps."""
    for B in (64, 100):
        plan = lstm_fwd_plan(B, 64)
        assert (plan["br"], plan["mode"], plan["kq"], plan["stage"]) == (
            1, "registers", 64, 0)
        assert plan["ns"] == 4 and plan["threads"] == 256
        assert plan["mw"] >= 9000
    assert lstm_fwd_plan(100, 64) == lstm_fwd_plan(100, 64)   # shapes alone
    assert lstm_fwd_plan(600, 64)["br"] == 8
    assert lstm_fwd_plan(19, 8)["mode"] == "smem"
    assert lstm_fwd_plan(19, 96)["mode"] == "smem"
    assert lstm_fwd_plan(19, 130)["mode"] == "global"


@pytest.mark.parametrize("S", [1, 8, 32, 33, 64, 65, 96, 130, 256])
@pytest.mark.parametrize("B", [1, 64, 100, 1100])
def test_lstm_fwd_plan_fits_every_width(B, S):
    plan = lstm_fwd_plan(B, S)
    assert plan["smem"] <= SMEM_OPTIN and plan["threads"] >= 4 * S
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024
    assert -(-B // plan["br"]) <= H100_SMS or plan["br"] == 8
    assert 2 <= plan["ns"] <= 4 and plan["mw"] >= 1
    assert plan["mw"] * plan["br"] in fused_lstm.FWD_MASK_WINDOWS
    kk = plan["kq"] or -(-S // 4) * 4
    assert plan["smem"] == (fused_lstm.FWD_BAR_BYTES
                            + plan["mw"] * plan["br"] + 4 * (
                                plan["ns"] * plan["br"] * 4 * S
                                + 2 * kk * plan["br"]
                                + (4 * S * S if plan["stage"] else 0)))
    assert plan["mode"] == ("registers" if 33 <= S <= 64 else
                            "smem" if plan["stage"] else "global")
    assert plan["kq"] == (64 if plan["mode"] == "registers" else 0)


#: row counts T * B of the weight-sum plan's tests: 1 row, fewer than a
#: slice, a slice and one, one wave's edge, the event-training shape, and a
#: batch of 1,100 x 100
WGRAD_ROWS = (1, 7, 33, 4224, 4225, 50000, 110000)


@pytest.mark.parametrize("S", [1, 8, 33, 64, 65, 96, 130, 256])
@pytest.mark.parametrize("N", WGRAD_ROWS)
def test_lstm_wgrad_plan_fits_and_covers_every_row_once(S, N):
    plan = lstm_wgrad_plan(N, 1, S)
    assert plan == lstm_wgrad_plan(1, N, S)                # shapes alone
    assert plan["smem"] <= SMEM_OPTIN
    threads = plan["threads"]
    assert threads <= fused_lstm.WGRAD_MAX_THREADS and threads % 32 == 0
    MT, G = -(-S // 8), -(-4 * S // 8)
    # the tiles cover the S x 4S output, column block 0's threads its 3S
    # peephole sums
    assert threads >= MT * plan["ng"]
    assert plan["ncb"] * plan["ng"] >= G > (plan["ncb"] - 1) * plan["ng"]
    assert threads * fused_lstm.WGRAD_PEEP_COLUMNS >= 3 * S
    # the splits cover the N rows once, each split whole slices but the
    # last, in one wave
    rows, nsplit = plan["rows_per_split"], plan["nsplit"]
    assert rows % plan["kb"] == 0
    assert (nsplit - 1) * rows < N <= nsplit * rows
    assert plan["ncb"] * nsplit <= H100_SMS
    assert plan["lh"] % 4 == 0 and S <= plan["lh"] < S + 4
    stage = 4 * (plan["kb"] * (3 * plan["lh"] + 4 * S)
                 + 2 * fused_lstm.WGRAD_PAD)
    assert plan["smem"] == fused_lstm.WGRAD_STAGES * stage


def test_lstm_wgrad_plan_at_the_event_training_shape():
    """T = 500, B = 100, S = 64: the whole 64 x 256 output in one block of
    8 x 32 tiles, 32-row slices, 131 splits of 384 rows: one wave over the
    H100's 132 SMs."""
    plan = lstm_wgrad_plan(500, 100, 64)
    assert (plan["ng"], plan["ncb"], plan["kb"]) == (32, 1, 32)
    assert plan["threads"] == 256
    assert (plan["nsplit"], plan["rows_per_split"]) == (131, 384)


@pytest.mark.parametrize("S", [1, 8, 32, 33, 64, 65, 96, 118, 130, 256])
@pytest.mark.parametrize("B", [1, 100, 1100])
def test_lstm_bwd_plan_fits_every_width(B, S):
    plan = lstm_bwd_plan(B, S)
    assert plan["smem"] <= SMEM_OPTIN and plan["threads"] >= 4 * S
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024
    assert -(-B // plan["br"]) <= H100_SMS or plan["br"] == 8
    assert 2 <= plan["ns"] <= 4 and plan["qs"] % 4 == 0
    assert plan["qs"] >= (plan["kq"] or -(-S // 4) * 4) * plan["br"]
    offsets = sorted((q * plan["qs"]) % 32 for q in range(4))
    width = 8 if plan["br"] == 8 else 4
    assert all(b - a >= width for a, b in zip(offsets, offsets[1:]))
    assert (offsets[0] + 32) - offsets[-1] >= width
    assert plan["mode"] == ("registers" if 33 <= S <= 64 else
                            "smem" if plan["stage"] else "global")


def test_lstm_function_emits_the_gate_trace_only_for_gradients(monkeypatch):
    """Under ``no_grad`` and ``inference_mode`` neither trace is written;
    with a gradient both are, and the layer records ``LstmFunction``."""
    xp, sWT, p, mask = lstm_inputs(7, 2, 4)
    seen = []
    real = lstm_forward.__call__

    def spy(*a, **k):
        seen.append((k["emit_cout"], k.get("emit_gates", False)))
        return real(*a, **k)

    monkeypatch.setattr(type(lstm_forward), "__call__",
                        lambda self, *a, **k: spy(*a, **k))
    with torch.no_grad():
        LstmFunction.apply(xp, sWT, p, mask, False, True)
    with torch.inference_mode():
        LstmFunction.apply(xp, sWT, p, mask, False, True)
    out = LstmFunction.apply(xp.requires_grad_(), sWT, p, mask, False, True)
    assert seen == [(False, False), (False, False), (True, True)]
    assert type(out.grad_fn).__name__ == "LstmFunctionBackward"


def _check_forward(xp, sWT, p, mask, reverse):
    """Both variants against the twin (h and c on valid steps, the gate
    trace everywhere), the inference variant's h equal to the training
    variant's, the same bits on a second call; one launch a call."""
    before = lstm_forward.launches
    h, c = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse)
    h2, none = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                            emit_cout=False)
    assert lstm_forward.launches == before + 2 and none is None
    href, cref, gref = lstm_scan_plain(xp, sWT, p, mask, reverse,
                                       emit_gates=True)
    m = mask[:, :, None]
    assert float(((h - href).abs() * m).max()) <= FWD_ATOL
    assert float(((c - cref).abs() * m).max()) <= FWD_ATOL
    assert torch.equal(h, h2)
    # the training variant: the same h and c, and the gate trace
    h3, c3, gates = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                                 emit_gates=True)
    assert torch.equal(h3, h) and torch.equal(c3, c)
    assert torch.isfinite(gates).all()
    assert float((gates - gref).abs().max()) <= FWD_ATOL
    again = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                         emit_gates=True)
    assert all(torch.equal(a, b) for a, b in zip((h3, c3, gates), again))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 33, 64, 65, 96, 130, 256])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_forward_kernel_matches_twin(cuda_device, S, reverse):
    """Both variants of every mode (S = 8, 65, 96 staged; 33, 64 registers;
    130, 256 through L1) on holed masks with a row masked throughout."""
    xp, sWT, p, mask = [a.to(cuda_device) for a in lstm_inputs(301, 19, S)]
    _check_forward(xp, sWT, p, _holes(mask), reverse)


@pytest.mark.gpu
@pytest.mark.parametrize("S,B", [(8, 1100), (64, 1100), (96, 300),
                                 (130, 70), (64, 1)])
def test_lstm_forward_kernel_wide_batches_and_mask_windows(cuda_device, S, B,
                                                           monkeypatch):
    """Batches of 1 to 8 rows a block, and mask windows of a few steps
    (windows of 16 to 64 bytes: the mask is restaged every 2 to 64 steps)
    on holed masks: the same results as the full window."""
    T = 97
    xp, sWT, p, mask = [a.to(cuda_device) for a in lstm_inputs(T, B, S)]
    mask = _holes(mask)
    for reverse in (False, True):
        _check_forward(xp, sWT, p, mask, reverse)
        full = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                            emit_gates=True)
        with monkeypatch.context() as mp:
            mp.setattr(fused_lstm, "FWD_MASK_WINDOWS", (64, 16))
            assert lstm_fwd_plan(B, S)["mw"] * lstm_fwd_plan(B, S)["br"] == 64
            small = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                                 emit_gates=True)
        assert all(torch.equal(a, b) for a, b in zip(full, small))


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
def test_lstm_fwd_clocked_build_gives_the_same_bits(cuda_device):
    """``bench_lstm --clocks``: the clocked build of the forward computes
    what the port's build does, and stamps every warp's steps."""
    from sloika_tpu_torch.scripts import bench_lstm
    T, B, S = 41, 3, 64
    xp, sWT, p, mask = [a.to(cuda_device) for a in lstm_inputs(T, B, S)]
    h, _ = lstm_forward(xp, sWT, p, mask=mask, emit_cout=False)
    split = bench_lstm.fwd_step_clocks(xp, sWT, p, mask, h)
    assert len(split["phases_by_warp"]) == 8
    assert split["cycles_per_step"] > 0
    assert set(split["phases_mean"]) == set(bench_lstm.FWD_PHASES)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 64, 96, 130, 144, 256])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_backward_kernels_match_twin(cuda_device, S, reverse):
    """Every mode of the backward (S = 8, 96 staged; 64 registers; 130, 144,
    256 global) on holed masks with a row masked throughout, from the
    forward's gate trace, against the recompute twin."""
    T, B = 211, 19
    xp, sWT, p, mask = [a.to(cuda_device) for a in lstm_inputs(T, B, S)]
    mask = _holes(mask)
    g = _cotangent(T, B, S).to(cuda_device)
    h, c, gates = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                               emit_gates=True)
    before = (lstm_backward.launches, lstm_wgrad.launches)
    got = lstm_backward(gates, sWT, p, mask, reverse, g, h, c)
    assert (lstm_backward.launches, lstm_wgrad.launches) == (
        before[0] + 1, before[1] + 1)
    ref = lstm_scan_bwd_plain(xp, sWT, p, mask, reverse, g, h, c)
    assert _rel_err(got[0], ref[0], mask) <= BWD_RTOL
    assert not got[0][~mask].any() and torch.isfinite(got[0]).all()
    assert _rel_err(got[1], ref[1]) <= BWD_RTOL
    assert _rel_err(got[2], ref[2]) <= BWD_RTOL
    # fixed-order sums: the same bits from run to run
    again = lstm_backward(gates, sWT, p, mask, reverse, g, h, c)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the weight-cotangent kernel against its einsum twin on the same rows
    wk = lstm_wgrad(h, c, got[0], reverse)
    wp = lstm_wgrad_plain(h, c, got[0], reverse)
    assert all(_rel_err(a, b) <= BWD_RTOL for a, b in zip(wk, wp))


@pytest.mark.gpu
@pytest.mark.parametrize("S,B", [(64, 200), (64, 600), (256, 1100)])
def test_lstm_kernels_wide_batches(cuda_device, S, B):
    """Batches that take 2, 4 and 8 rows per block, and a width (S = 256)
    whose 8-row block may not fit the SM's registers, on holed masks."""
    T = 37
    xp, sWT, p, mask = [a.to(cuda_device) for a in lstm_inputs(T, B, S)]
    mask = _holes(mask)
    g = _cotangent(T, B, S).to(cuda_device)
    h, c, gates = lstm_forward(xp, sWT, p, mask=mask, reverse=True,
                               emit_gates=True)
    href, cref = lstm_scan_plain(xp, sWT, p, mask, True)
    assert float(((h - href).abs() * mask[:, :, None]).max()) <= FWD_ATOL
    got = lstm_backward(gates, sWT, p, mask, True, g, h, c)
    ref = lstm_scan_bwd_plain(xp, sWT, p, mask, True, g, h, c)
    assert _rel_err(got[0], ref[0], mask) <= BWD_RTOL
    assert _rel_err(got[1], ref[1]) <= BWD_RTOL
    assert _rel_err(got[2], ref[2]) <= BWD_RTOL
    again = lstm_backward(gates, sWT, p, mask, True, g, h, c)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 8, 33, 64, 65, 96, 130, 256])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_wgrad_kernel_matches_its_twin(cuda_device, S, reverse):
    """Every width of the plan's tests, on holed masks (a row masked
    throughout), with N = 37 x 29 rows (no multiple of a slice, and the
    first scan step straddling slices): within BWD_RTOL of the einsum twin,
    and the same bits on two calls."""
    T, B = 37, 29
    xp, sWT, p, mask = [a.to(cuda_device) for a in lstm_inputs(T, B, S)]
    mask = _holes(mask)
    g = _cotangent(T, B, S).to(cuda_device)
    h, c, gates = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                               emit_gates=True)
    dxp = lstm_backward.recurrence(gates, sWT, p, mask, reverse, g, c)
    kernel = LstmWgrad()
    got = kernel(h, c, dxp, reverse)
    assert kernel.launches == 1
    ref = lstm_wgrad_plain(h, c, dxp, reverse)
    assert all(_rel_err(a, b) <= BWD_RTOL for a, b in zip(got, ref))
    again = kernel(h, c, dxp, reverse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_wgrad_kernel_at_the_event_training_shape(cuda_device, reverse):
    """(T, B, S) = (500, 100, 64), the plan's 131 splits, against the twin
    and the same bits on two calls; and views that start off a 16-byte
    boundary (copied by 4-byte copies in the kernel, in the same sum
    order: the same bits)."""
    T, B, S = 500, 100, 64
    rs = np.random.RandomState(31)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    h, c = f32(rs.normal(size=(T, B, S))), f32(rs.normal(size=(T, B, S)))
    dxp = f32(rs.normal(size=(T, B, 4 * S)))
    ref = lstm_wgrad_plain(h, c, dxp, reverse)
    got = lstm_wgrad(h, c, dxp, reverse)
    assert all(_rel_err(a, b) <= BWD_RTOL for a, b in zip(got, ref))
    again = lstm_wgrad(h, c, dxp, reverse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    def off(t):
        view = torch.empty(t.numel() + 1, device=cuda_device)[1:]
        return view.view(t.shape).copy_(t)

    for args in ((off(h), c, dxp), (h, c, off(dxp)),
                 (off(h), off(c), off(dxp))):
        assert all(torch.equal(a, b) for a, b in zip(
            lstm_wgrad(*args, reverse), got))


@pytest.mark.gpu
def test_lstm_wgrad_clocked_build_gives_the_same_bits(cuda_device):
    """``bench_lstm --clocks``: the clocked build of the weight sums
    computes what the port's build does and stamps every warp."""
    from sloika_tpu_torch.scripts import bench_lstm
    T, B, S = 41, 30, 64
    rs = np.random.RandomState(5)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    h, c = f32(rs.normal(size=(T, B, S))), f32(rs.normal(size=(T, B, S)))
    dxp = f32(rs.normal(size=(T, B, 4 * S)))
    split = bench_lstm.wgrad_clocks(h, c, dxp, lstm_wgrad(h, c, dxp, False))
    assert split["cycles_per_slice"] > 0
    assert set(split["phases_mean"]) == set(bench_lstm.WGRAD_PHASES)


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
