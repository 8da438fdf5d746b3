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
from sloika_tpu_torch.nn.fused_gru import gru_forward, gru_scan_plain
from sloika_tpu_torch.ops import decode, viterbi_kernel


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


def test_viterbi_cpu_dispatch_is_the_plain_twin():
    post = _posterior(3, "ties", T=17, B=3, seed=5)
    before = (viterbi_kernel.viterbi_forward.launches,
              viterbi_kernel.viterbi_backtrace.launches)
    got = viterbi_kernel.viterbi(post, 3, skip_pen=5.0)
    ref = decode.viterbi(post, 3, skip_pen=5.0)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert (viterbi_kernel.viterbi_forward.launches,
            viterbi_kernel.viterbi_backtrace.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 112, 144])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_kernel_matches_twin(cuda_device, S, reverse):
    args = [a.to(cuda_device) for a in _gru_inputs(301, 19, S)]
    before = gru_forward.launches
    got = gru_forward(*args[:3], mask=args[3], reverse=reverse)
    assert gru_forward.launches == before + 1
    ref = gru_scan_plain(*args, reverse=reverse)
    assert float(((got - ref).abs() * args[3][:, :, None]).max()) <= 1e-4


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
                         device="cpu")
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.normal(size=(2048, 3, 1)).astype(np.float32))
    lengths = torch.tensor([2048, 1500, 333])
    with torch.inference_mode():
        ref, _ = cpu._floored_masked_post(x, lengths)
        gpu = tbc.Basecaller(layer, 3, chunk_size=2048, overlap=100,
                             device=cuda_device)
        got, _ = gpu._floored_masked_post(x.to(cuda_device),
                                          lengths.to(cuda_device))
        assert float((got.cpu() - ref).abs().max()) <= 1e-4
        _, path, moved = decode.viterbi(ref, 3, skip_pen=5.0)
        host = tbc._move_records(path, moved, 3, gpu._f_splits)
        dev = tbc._move_records(path.to(cuda_device), moved.to(cuda_device),
                                3, gpu._f_splits)
        assert all(torch.equal(h, d.cpu()) for h, d in zip(host, dev))
