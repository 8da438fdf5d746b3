"""The port's CUDA kernels against their plain PyTorch twins.

This file imports no jax, so the ``gpu``-marked tests run on a machine with
a CUDA card and without jax::

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q

On a machine without a card they skip; the CPU tests check that each
wrapper hands CPU tensors to its plain twin without counting a launch.
"""
import numpy as np
import pytest
import torch

from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch import models as tmodels
from sloika_tpu_torch import nn as tnn
from sloika_tpu_torch.nn.fused_gru import (
    BWD_STAGED_THREADS, FWD_STAGED_THREADS, H100_SMS, SMEM_OPTIN, GruFunction,
    gru_backward, gru_bwd_plan, gru_forward, gru_fwd_plan,
    gru_scan_bwd_gates_plain, gru_scan_bwd_plain, gru_scan_plain, gru_wgrad,
    gru_wgrad_plain, gru_wgrad_plan, h_prev_of)
from sloika_tpu_torch.ops import decode, viterbi_kernel

#: GRU backward kernels against the twin: max|kernel - twin| / max|twin|
#: (float32 sums in another order; the weight cotangents over T*B rows)
BWD_RTOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _gru_inputs(T, B, S, seed=2):
    rs = np.random.RandomState(seed)
    xp = torch.from_numpy(rs.normal(size=(T, B, 3 * S)).astype(np.float32))
    sWT = torch.from_numpy((rs.normal(size=(S, 2 * S))
                            / np.sqrt(2 * S)).astype(np.float32))
    sW2T = torch.from_numpy((rs.normal(size=(S, S))
                             / np.sqrt(2 * S)).astype(np.float32))
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T
    mask = torch.from_numpy(np.arange(T)[:, None] < lengths[None, :])
    return xp, sWT, sW2T, mask


def _cotangent(T, B, S, seed=3):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.normal(size=(T, B, S)).astype(np.float32))


def _rel_err(got, ref, mask=None):
    d = (got - ref).abs()
    if mask is not None:
        d = d * mask[:, :, None]
    return float(d.max()) / max(float(ref.abs().max()), 1e-30)


def _posterior(klen, kind, T, B, seed=0):
    rs = np.random.RandomState(seed)
    post = rs.dirichlet(np.full(4 ** klen + 1, 0.05),
                        size=(T, B)).astype(np.float32)
    if kind == "ties":
        post = (np.round(post * 8) / 8 + 1e-3).astype(np.float32)
    return torch.from_numpy(post)


def test_gru_cpu_dispatch_is_the_plain_twin():
    xp, sWT, sW2T, mask = _gru_inputs(9, 3, 8)
    before = gru_forward.launches
    for reverse in (False, True):
        out = gru_forward(xp, sWT, sW2T, mask=mask, reverse=reverse)
        assert torch.equal(out, gru_scan_plain(xp, sWT, sW2T, mask, reverse))
    assert gru_forward.launches == before


def test_gru_backward_cpu_dispatch_is_the_plain_twin():
    xp, sWT, sW2T, mask = _gru_inputs(9, 3, 8)
    g = _cotangent(9, 3, 8)
    before = (gru_forward.launches, gru_backward.launches,
              gru_wgrad.launches)
    for reverse in (False, True):
        h_out, gates = gru_forward(xp, sWT, sW2T, mask=mask, reverse=reverse,
                                   emit_gates=True)
        assert torch.equal(h_out, gru_scan_plain(xp, sWT, sW2T, mask,
                                                 reverse))
        got = gru_backward(gates, sWT, sW2T, mask, reverse, g, h_out)
        ref = gru_scan_bwd_gates_plain(gates, sWT, sW2T, mask, reverse, g,
                                       h_out)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (gru_forward.launches, gru_backward.launches,
            gru_wgrad.launches) == before


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("S", [8, 24])
def test_gru_gate_trace_twins_match_the_recompute_twin(S, reverse):
    """The gate trace of the plain forward, and the plain backward from it,
    give the recompute twin's results (held to the Pallas VJP in
    ``tests/test_torch_gru_bwd.py``) on holed masks with a row masked
    throughout: the same arithmetic in the same order."""
    T, B = 17, 5
    xp, sWT, sW2T, mask = _gru_inputs(T, B, S, seed=S)
    mask = _holes(mask)
    g = _cotangent(T, B, S)
    h_out, gates = gru_scan_plain(xp, sWT, sW2T, mask, reverse,
                                  emit_gates=True)
    assert torch.equal(h_out, gru_scan_plain(xp, sWT, sW2T, mask, reverse))
    assert torch.isfinite(gates).all()
    got = gru_scan_bwd_gates_plain(gates, sWT, sW2T, mask, reverse, g, h_out)
    ref = gru_scan_bwd_plain(xp, sWT, sW2T, mask, reverse, g, h_out)
    for a, b in zip(got, ref):
        assert _rel_err(a, b) <= 1e-6
    assert not got[0][~mask].any()


def test_gru_function_emits_the_gate_trace_only_for_gradients(monkeypatch):
    """Outside autograd the inference variant runs and nothing is saved."""
    xp, sWT, sW2T, mask = _gru_inputs(7, 2, 4)
    seen = []
    real = gru_forward.__call__

    def spy(*a, **k):
        seen.append(k["emit_gates"])
        return real(*a, **k)

    monkeypatch.setattr(type(gru_forward), "__call__",
                        lambda self, *a, **k: spy(*a, **k))
    with torch.no_grad():
        GruFunction.apply(xp, sWT, sW2T, mask, False)
    with torch.inference_mode():
        GruFunction.apply(xp, sWT, sW2T, mask, False)
    out = GruFunction.apply(xp.requires_grad_(), sWT, sW2T, mask, False)
    assert seen == [False, False, True]
    assert type(out.grad_fn).__name__ == "GruFunctionBackward"


def test_gru_launch_plans_at_the_main_paths_shapes():
    """The plans of the two GRU kernels at the main paths' shapes: S = 96
    (training) and S = 112 (basecall) hold both weight matrices in
    registers, S = 144 (basecall, remap) holds sW2T and 48 rows of sWT in
    registers at B = 64 and sW2T alone at the production B = 1,024, every
    ring fetches two or more steps ahead there, and the weight-cotangent
    split fills one wave of the H100's 132 SMs with the whole S x 3S in a
    block."""
    mode = lambda p: (p["br"], p["mode"], p["kr"], p["kh2"])
    train = gru_fwd_plan(100, 96)
    assert mode(train) == (1, "registers", 96, 48) and train["ns"] == 4
    assert mode(gru_fwd_plan(64, 112)) == (1, "registers", 112, 56)
    assert mode(gru_fwd_plan(64, 64)) == (1, "smem", 0, 0)
    for B, want in ((64, (1, "registers", 48, 72)),
                    (1024, (8, "registers", 0, 72))):
        plan = gru_fwd_plan(B, 144)
        assert mode(plan) == want
        assert plan["ns"] >= 3 and plan["smem"] <= SMEM_OPTIN
    w = gru_wgrad_plan(400, 100, 96)
    assert w["ncb"] == 1 and w["nsplit"] == H100_SMS
    assert w["rows_per_split"] % w["kb"] == 0
    assert w["nsplit"] * w["rows_per_split"] >= 400 * 100
    assert gru_wgrad_plan(400, 100, 96) == w        # shapes alone


@pytest.mark.parametrize("S", [1, 8, 64, 96, 112, 136, 137, 144, 200, 256,
                               511, 512])
@pytest.mark.parametrize("B", [1, 100, 1024])
def test_gru_fwd_plan_fits_every_width(B, S):
    plan = gru_fwd_plan(B, S)
    assert plan["smem"] <= SMEM_OPTIN and plan["threads"] >= 2 * S
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024
    assert -(-B // plan["br"]) <= H100_SMS or plan["br"] == 8
    if plan["mode"] != "global":
        assert plan["stage1"] and plan["threads"] <= FWD_STAGED_THREADS
    if plan["mode"] == "registers":
        assert S <= 2 * plan["kh2"] and plan["kr"] in (0, 48, 96, 112)
    assert plan["mode"] == ("smem" if S < 73 else "registers" if S <= 144
                            else "global")


def test_gru_bwd_plan_at_the_main_paths_shapes():
    """The backward's plans: the training path's S = 96 and the basecall
    width S = 112 hold both products' weights in registers, S = 144 the
    second's (the first's staged), each with a ring of 4 step slots (inputs
    fetched two or more steps ahead); a batch past 4 x 132 rows takes 8 rows
    a block."""
    mode = lambda p: (p["br"], p["mode"], p["ka"], p["kb"], p["stage"])
    train = gru_bwd_plan(100, 96)
    assert mode(train) == (1, "registers", 96, 48, 0) and train["ns"] == 4
    assert train["threads"] == 192
    assert mode(gru_bwd_plan(64, 112)) == (1, "registers", 112, 56, 0)
    assert mode(gru_bwd_plan(64, 144)) == (1, "mixed", 0, 72, 1)
    assert mode(gru_bwd_plan(100, 64)) == (1, "smem", 0, 0, 3)
    assert mode(gru_bwd_plan(1024, 96)) == (8, "registers", 96, 48, 0)
    assert gru_bwd_plan(100, 96) == train            # shapes alone


@pytest.mark.parametrize("S", [1, 8, 64, 72, 73, 96, 112, 113, 136, 144,
                               145, 200, 256])
@pytest.mark.parametrize("B", [1, 100, 1024])
def test_gru_bwd_plan_fits_every_width(B, S):
    plan = gru_bwd_plan(B, S)
    assert plan["smem"] <= SMEM_OPTIN and plan["threads"] >= 2 * S
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024
    assert -(-B // plan["br"]) <= H100_SMS or plan["br"] == 8
    assert 2 <= plan["ns"] <= 4
    if plan["ka"]:
        assert S <= plan["ka"] and plan["mode"] == "registers"
    if plan["kb"]:
        assert S <= 2 * plan["kb"] and plan["kb"] in (48, 56, 72)
    else:
        assert plan["threads"] <= BWD_STAGED_THREADS
    assert plan["mode"] == ("smem" if S < 73 else "registers" if S <= 112
                            else "mixed" if S <= 144 else "global")


@pytest.mark.parametrize("T,B,S", [(0, 4, 96), (1, 1, 8), (211, 19, 8),
                                   (37, 1100, 256), (3277, 64, 144)])
def test_gru_wgrad_plan_covers_the_rows(T, B, S):
    w = gru_wgrad_plan(T, B, S)
    assert w["nsplit"] * w["rows_per_split"] >= T * B
    assert (w["nsplit"] - 1) * w["rows_per_split"] < max(T * B, 1)
    assert w["ncb"] * w["nsplit"] <= H100_SMS
    assert w["ncb"] * w["ng"] >= -(-2 * S // 8) + -(-S // 8)
    assert w["threads"] <= 512 and w["smem"] <= SMEM_OPTIN


def test_viterbi_cpu_dispatch_is_the_plain_twin():
    post = _posterior(3, "ties", T=17, B=3, seed=5)
    before = (viterbi_kernel.viterbi_forward.launches,
              viterbi_kernel.viterbi_backtrace.launches)
    got = viterbi_kernel.viterbi(post, 3, skip_pen=5.0)
    ref = decode.viterbi(post, 3, skip_pen=5.0)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert (viterbi_kernel.viterbi_forward.launches,
            viterbi_kernel.viterbi_backtrace.launches) == before


#: (T, B, S) of the forward kernel's cases: every mode (S = 8 and 64 both
#: weights in shared memory; 96, 112 and 144 weights in registers, at 1, 2
#: and 8 rows a block; 160 sWT staged and sW2T from global memory; 256 and
#: 512 both from global memory), and T = 1
GRU_FWD_CASES = [(301, 19, 8), (301, 19, 64), (301, 19, 96), (301, 19, 112),
                 (301, 19, 144), (201, 19, 160), (301, 19, 256), (97, 19, 512), (301, 1, 96),
                 (301, 3, 144), (301, 64, 144), (400, 100, 96),
                 (157, 1024, 96), (157, 1024, 144), (29, 1024, 512),
                 (1, 7, 96), (1, 1024, 144)]


def _holes(mask, seed=4):
    """The mask with interior masked steps and, where B > 1, its last row
    masked throughout."""
    rs = np.random.RandomState(seed)
    holes = torch.from_numpy(rs.uniform(size=tuple(mask.shape)) < 0.85)
    mask = mask & holes.to(mask.device)
    if mask.shape[1] > 1:
        mask[:, -1] = False
    return mask


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,S", GRU_FWD_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_kernel_matches_twin(cuda_device, T, B, S, reverse):
    xp, sWT, sW2T, mask = _gru_inputs(T, B, S)
    args = [a.to(cuda_device) for a in (xp, sWT, sW2T, _holes(mask))]
    before = gru_forward.launches
    got = gru_forward(*args[:3], mask=args[3], reverse=reverse)
    assert gru_forward.launches == before + 1
    ref = gru_scan_plain(*args, reverse=reverse)
    assert float(((got - ref).abs() * args[3][:, :, None]).max()) <= 1e-4
    # a row masked throughout keeps and emits its zero state
    if B > 1:
        assert not got[:, -1].any()


@pytest.mark.gpu
def test_gru_kernel_rejects_bad_inputs(cuda_device):
    xp, sWT, sW2T, mask = [a.to(cuda_device) for a in _gru_inputs(5, 2, 8)]
    with pytest.raises(ValueError):
        gru_forward(xp.transpose(0, 1), sWT, sW2T)        # wrong shape
    with pytest.raises(ValueError):
        gru_forward(xp, sWT.t().contiguous().t(), sW2T)   # not contiguous
    with pytest.raises(ValueError):
        gru_forward(xp, sWT.cpu(), sW2T)                  # wrong device


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 64, 96, 112, 144, 256])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_backward_kernels_match_twin(cuda_device, S, reverse):
    """Every mode of the backward (S = 8, 64 staged; 96, 112 registers; 144
    mixed; 256 global) on holed masks with a row masked throughout: the
    forward's gate trace against its twin, then the backward from it
    against the recompute twin."""
    T, B = 211, 19          # N = 4,009 rows: not a multiple of a slice
    xp, sWT, sW2T, mask = [a.to(cuda_device) for a in _gru_inputs(T, B, S)]
    mask = _holes(mask)
    g = _cotangent(T, B, S).to(cuda_device)
    h_out, gates = gru_forward(xp, sWT, sW2T, mask=mask, reverse=reverse,
                               emit_gates=True)
    assert torch.equal(h_out, gru_forward(xp, sWT, sW2T, mask=mask,
                                          reverse=reverse))
    _, gref = gru_scan_plain(xp, sWT, sW2T, mask, reverse, emit_gates=True)
    assert float((gates - gref).abs().max()) <= 1e-4
    before = (gru_backward.launches, gru_wgrad.launches)
    got = gru_backward(gates, sWT, sW2T, mask, reverse, g, h_out)
    assert (gru_backward.launches, gru_wgrad.launches) == (
        before[0] + 1, before[1] + 1)
    ref = gru_scan_bwd_plain(xp, sWT, sW2T, mask, reverse, g, h_out)
    assert _rel_err(got[0], ref[0], mask) <= BWD_RTOL
    assert not got[0][~mask].any() and torch.isfinite(got[0]).all()
    assert _rel_err(got[1], ref[1]) <= BWD_RTOL
    assert _rel_err(got[2], ref[2]) <= BWD_RTOL
    # fixed-order sums: the same bits from run to run
    again = gru_backward(gates, sWT, sW2T, mask, reverse, g, h_out)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the weight-cotangent kernel against its einsum twin on the same rows
    dxp, rh = gru_backward.recurrence(gates, sWT, sW2T, mask, reverse, g,
                                      h_out)
    assert _rel_err(rh, gates[:, :, S:2 * S] * h_prev_of(
        h_out, reverse)) <= 1e-6
    wk = gru_wgrad(h_out, rh, dxp, reverse)
    wp = gru_wgrad_plain(h_out, rh, dxp, reverse)
    assert all(_rel_err(a, b) <= BWD_RTOL for a, b in zip(wk, wp))
    assert all(torch.equal(a, b) for a, b in zip(
        wk, gru_wgrad(h_out, rh, dxp, reverse)))


@pytest.mark.gpu
@pytest.mark.parametrize("S,B", [(96, 200), (96, 600), (144, 1100),
                                 (256, 1100)])
def test_gru_backward_kernels_wide_batches(cuda_device, S, B):
    """Batches that take 2, 4 and 8 rows per block (S = 144 at 8 rows: the
    mixed mode with a 2-slot ring), on holed masks."""
    T = 37
    xp, sWT, sW2T, mask = [a.to(cuda_device) for a in _gru_inputs(T, B, S)]
    mask = _holes(mask)
    g = _cotangent(T, B, S).to(cuda_device)
    h_out, gates = gru_forward(xp, sWT, sW2T, mask=mask, reverse=True,
                               emit_gates=True)
    got = gru_backward(gates, sWT, sW2T, mask, True, g, h_out)
    ref = gru_scan_bwd_plain(xp, sWT, sW2T, mask, True, g, h_out)
    assert _rel_err(got[0], ref[0], mask) <= BWD_RTOL
    assert not got[0][~mask].any()
    assert _rel_err(got[1], ref[1]) <= BWD_RTOL
    assert _rel_err(got[2], ref[2]) <= BWD_RTOL
    again = gru_backward(gates, sWT, sW2T, mask, True, g, h_out)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_gru_layer_gradients_match_cpu(cuda_device):
    """A GRU layer under autograd on the card runs the three kernels and
    gives the CPU twins' gradients; under no_grad only the forward."""
    layer = tnn.Gru(6, 16, init=tnn.truncated_normal(
        0.5, np.random.RandomState(1)), has_bias=True)
    x = torch.from_numpy(np.random.RandomState(2).normal(
        size=(157, 7, 6)).astype(np.float32))
    mask = torch.from_numpy(np.arange(157)[:, None]
                            < np.array([157, 3, 90, 157, 1, 40, 156]))
    grads = []
    for dev in ("cpu", cuda_device):
        layer.zero_grad()
        gpu = layer.to(dev)
        n0 = (gru_forward.launches, gru_backward.launches,
              gru_wgrad.launches)
        out = gpu(x.to(dev), reverse=True, mask=mask.to(dev))
        (out * mask.to(dev)[:, :, None]).square().sum().backward()
        n1 = (gru_forward.launches, gru_backward.launches,
              gru_wgrad.launches)
        assert n1 == (tuple(n + 1 for n in n0) if dev != "cpu" else n0)
        grads.append([p.grad.cpu() for p in gpu.parameters()])
    assert all(_rel_err(a, b) <= BWD_RTOL for a, b in zip(*grads))
    with torch.no_grad():
        layer(x.to(cuda_device))
    assert (gru_forward.launches, gru_backward.launches) == (n1[0] + 1,
                                                             n1[1])


@pytest.mark.gpu
@pytest.mark.parametrize("klen", [3, 5])
@pytest.mark.parametrize("kind", ["peaked", "ties"])
@pytest.mark.parametrize("skip_pen", [0.0, 5.0])
def test_viterbi_kernels_bit_equal_to_twins(cuda_device, klen, kind,
                                            skip_pen):
    post = _posterior(klen, kind, T=200, B=7).to(cuda_device)
    v, tb = viterbi_kernel.viterbi_forward(post, klen, skip_pen=skip_pen)
    v_ref, tb_ref = decode.viterbi_forward_plain(post, klen,
                                                 skip_pen=skip_pen)
    assert torch.equal(v, v_ref) and torch.equal(tb, tb_ref)
    last = torch.argmax(v, dim=1)
    got = viterbi_kernel.viterbi_backtrace(tb, last)
    ref = decode.viterbi_backtrace_plain(tb, last)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.gpu
def test_basecaller_gpu_posterior_matches_cpu(cuda_device):
    """The GPU forward (cuDNN conv with TF32 off, cuBLAS, the GRU kernel)
    agrees with the CPU forward, and the GPU move records equal the CPU
    ones for the same path."""
    layer = tmodels.network_factory("raw_1_00_rGr")(
        klen=3, sd=0.5, sizes=(16, 12, 16, 12), stride=5, seed=4)
    cpu = tbc.Basecaller(layer, 3, chunk_size=2048, overlap=100,
                         chunked=True, output="bases", device="cpu")
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.normal(size=(2048, 3, 1)).astype(np.float32))
    lengths = torch.tensor([2048, 1500, 333])
    with torch.inference_mode():
        ref, _ = cpu._floored_masked_post(x, lengths)
        gpu = tbc.Basecaller(layer, 3, chunk_size=2048, overlap=100,
                             chunked=True, output="bases",
                             device=cuda_device)
        got, _ = gpu._floored_masked_post(x.to(cuda_device),
                                          lengths.to(cuda_device))
        assert float((got.cpu() - ref).abs().max()) <= 1e-4
        _, path, moved = decode.viterbi(ref, 3, skip_pen=5.0)
        host = tbc._move_records(path, moved, 3, gpu._f_splits)
        dev = tbc._move_records(path.to(cuda_device), moved.to(cuda_device),
                                3, gpu._f_splits)
        assert all(torch.equal(h, d.cpu()) for h, d in zip(host, dev))


@pytest.mark.gpu
def test_bf16_affine_on_the_card_matches_the_plain_form(cuda_device,
                                                        monkeypatch):
    """Under ``config.compute_dtype`` bfloat16, ``affine`` on the card (a
    bfloat16 product with a float32 accumulator) returns float32 within
    float32 summation order of the CPU's plain form, and its gradients
    likewise (each rounded to bfloat16: within one bfloat16 ulp)."""
    from sloika_tpu_torch import config
    monkeypatch.setattr(config, "compute_dtype", torch.bfloat16)
    config.disable_tf32()
    rs = np.random.RandomState(3)
    x = rs.normal(size=(50, 16, 96)).astype(np.float32)
    W = rs.normal(size=(432, 96)).astype(np.float32)
    b = rs.normal(size=(432,)).astype(np.float32)
    g = rs.normal(size=(50, 16, 432)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        xt, Wt, bt = (torch.tensor(a, device=dev, requires_grad=True)
                      for a in (x, W, b))
        y = tnn.affine(xt, Wt, bt)
        y.backward(torch.tensor(g, device=dev))
        out[str(dev)] = [t.detach().cpu() for t in (y, xt.grad, Wt.grad)]
        assert y.dtype == torch.float32
    (y, dx, dW), (y_ref, dx_ref, dW_ref) = out[str(cuda_device)], out["cpu"]
    assert float((y - y_ref).abs().max()) <= 1e-5 * float(y_ref.abs().max())
    for got, ref in ((dx, dx_ref), (dW, dW_ref)):
        assert float((got - ref).abs().max()) <= 2 ** -7 * float(
            ref.abs().max())
