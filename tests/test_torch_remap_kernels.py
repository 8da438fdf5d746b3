"""The banded remap kernels against their plain PyTorch twins.

This file imports no jax, so the ``gpu``-marked tests run on a machine with
a CUDA card and without jax::

    python -m pytest tests/test_torch_remap_kernels.py -m gpu --noconftest -q

On a machine without a card they skip; the CPU tests check that each
wrapper hands CPU tensors to its plain twin without counting a launch.
"""
import numpy as np
import pytest
import torch

from sloika_tpu_torch.ops import remap_kernel as rk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def near_linear_case(nframes, nposs, T, P, nstate=66, seed=0, jitter=3):
    """Log-posteriors (T, B, nstate) whose best path runs near the
    diagonal, with stay-padded frames past each row's length, plus the
    sequences and masks (cf. tests/test_remap_banded.py::_make_case)."""
    rs = np.random.RandomState(seed)
    B = len(nframes)
    lt = np.full((T, B, nstate), np.log(1e-6), dtype=np.float32)
    seq = np.zeros((B, P), np.int32)
    mask = np.zeros((B, P), bool)
    for b in range(B):
        npos, tb = nposs[b], nframes[b]
        s = rs.randint(1, nstate, size=npos).astype(np.int32)
        seq[b, :npos] = s
        mask[b, :npos] = True
        base = np.clip(np.arange(tb) * (npos - 1) // max(tb - 1, 1)
                       + rs.randint(-jitter, jitter + 1, size=tb),
                       0, npos - 1)
        base = np.maximum.accumulate(base)
        post = np.full((tb, nstate), 1e-4)
        for t in range(tb):
            if t > 0 and base[t] == base[t - 1] and rs.rand() < 0.5:
                post[t, 0] = 1.0
            else:
                post[t, s[base[t]]] = 1.0
        post /= post.sum(1, keepdims=True)
        lt[:tb, b] = np.log(post)
        lt[tb:, b] = np.log(1e-10)
        lt[tb:, b, 0] = 0.0
    return lt, seq, mask


def _inputs(nframes, nposs, T, P, W, dev, seed=0):
    lt, seq, mask = near_linear_case(nframes, nposs, T, P, seed=seed)
    rs = np.random.RandomState(seed + 1)
    p0 = np.log(rs.uniform(0.1, 1.0, size=(len(nframes), P))) \
        .astype(np.float32)
    TB = rk.block_len(W)
    Tp = -(-T // TB) * TB
    starts = rk.band_starts_blocked(torch.from_numpy(np.asarray(nframes)),
                                    torch.from_numpy(np.asarray(nposs)),
                                    Tp, W, TB)
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(lt), t(seq), t(mask), t(p0), starts.to(dev)


def test_cpu_tensors_take_the_plain_twins():
    lt, seq, mask, p0, starts = _inputs([60, 45], [30, 20], 60, 40, 16,
                                        torch.device("cpu"))
    n0, m0 = rk.remap_banded.launches, rk.remap_backtrack.launches
    tb, vfinal = rk.remap_banded(lt, seq, mask, p0, starts, 3.0, 16)
    ref_tb, ref_v = rk.remap_banded_plain(lt, seq, mask, p0, starts, 3.0, 16)
    assert torch.equal(tb, ref_tb) and torch.equal(vfinal, ref_v)
    last = torch.argmax(vfinal, dim=1).to(torch.int32) + starts[-1]
    assert torch.equal(rk.remap_backtrack(tb, starts, last),
                       rk.remap_backtrack_plain(tb, starts, last))
    assert (rk.remap_banded.launches, rk.remap_backtrack.launches) == (n0, m0)


@pytest.mark.gpu
@pytest.mark.parametrize("W,P,nposs", [
    (64, 256, [200, 150, 90]),          # banded, nbits > 0
    (128, 256, [200, 150, 90]),
    (256, 256, [200, 150, 90]),         # the full-window (exact) form
    (3072, 3072, [2900, 2000, 1200]),   # 256 threads x 12 positions
    (5000, 5000, [4900, 3000, 100]),    # > 1,024 threads' worth at 3 each
])
def test_remap_kernels_bit_identical_to_plain(cuda_device, W, P, nposs):
    T = 400
    nframes = [400, 300, 250]
    lt, seq, mask, p0, starts = _inputs(nframes, nposs, T, P, W, cuda_device)
    n0 = rk.remap_banded.launches
    tb, vfinal = rk.remap_banded(lt, seq, mask, p0, starts, 3.0, W)
    torch.cuda.synchronize()
    assert rk.remap_banded.launches == n0 + 1
    ref_tb, ref_v = rk.remap_banded_plain(lt, seq, mask, p0, starts, 3.0, W)
    assert torch.equal(tb, ref_tb)
    assert torch.equal(vfinal, ref_v)
    last = torch.argmax(vfinal, dim=1).to(torch.int32) + starts[-1]
    path = rk.remap_backtrack(tb, starts, last)
    torch.cuda.synchronize()
    assert torch.equal(path, rk.remap_backtrack_plain(tb, starts, last))


@pytest.mark.gpu
def test_remap_widest_window(cuda_device):
    """W = 16,384, the kernel's limit: 1,024 threads of 16 positions."""
    W = P = 16384
    lt, seq, mask, p0, starts = _inputs([40, 33], [16000, 9000], 40, P, W,
                                        cuda_device)
    tb, vfinal = rk.remap_banded(lt, seq, mask, p0, starts, 2.0, W)
    ref_tb, ref_v = rk.remap_banded_plain(lt, seq, mask, p0, starts, 2.0, W)
    torch.cuda.synchronize()
    assert torch.equal(tb, ref_tb) and torch.equal(vfinal, ref_v)


@pytest.mark.gpu
def test_remap_window_out_of_range_raises(cuda_device):
    lt, seq, mask, p0, starts = _inputs([40], [30], 40, 64, 32, cuda_device)
    with pytest.raises(ValueError, match="window of 1..16384"):
        rk.remap_banded(lt, seq, mask, p0, starts, 3.0,
                        rk.RemapBanded.MAX_W + 1)
