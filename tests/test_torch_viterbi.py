"""The port's Viterbi and move-record collapse against the JAX package's
(CPU).

Given the same log-posterior, score, path and moved must be bit-equal to the
Pallas kernel (both layouts, interpret mode) and to the XLA decoder:
the DP is max/compare/add only, so any difference is a tie-break fault.
Log-domain inputs are made once with numpy and fed to both sides, because
the two frameworks' float32 ``log`` differ in the last ulp on the CPU.
Tie-heavy quantised posteriors (cf. tests/test_pallas_viterbi.py) exercise
the tie-breaks.  The CUDA kernels are held against these twins in
tests/test_torch_kernels.py and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sloika_tpu import basecall as jbc
from sloika_tpu.ops import decode_jax
from sloika_tpu.ops.pallas import viterbi as pallas_viterbi
from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch.ops import decode
from sloika_tpu_torch.ops import viterbi_kernel


def _posterior(klen, kind, T=23, B=3, seed=0, nbase=4):
    """Time-major (T, B, nbase**klen + 1) float32 probabilities."""
    rs = np.random.RandomState(seed)
    post = rs.dirichlet(np.full(nbase ** klen + 1, 0.05),
                        size=(T, B)).astype(np.float32)
    if kind == "ties":
        post = (np.round(post * 8) / 8 + 1e-3).astype(np.float32)
    return post


def _np(*xs):
    return [np.asarray(x) for x in xs]


@pytest.mark.parametrize("klen", [3, 5, 7])
@pytest.mark.parametrize("kind", ["peaked", "ties"])
@pytest.mark.parametrize("skip_pen", [0.0, 5.0])
def test_plain_viterbi_bit_equal_to_jax(klen, kind, skip_pen):
    post = _posterior(klen, kind)
    lpost = np.log(post + np.float32(1e-10)).astype(np.float32)
    got = _np(*decode.viterbi(torch.from_numpy(lpost), klen,
                              skip_pen=skip_pen, log=True))
    refs = [decode_jax.viterbi(jnp.asarray(lpost), klen, skip_pen=skip_pen,
                               log=True, time_major=True)]
    for layout in ("lanes", "sublanes"):
        refs.append(pallas_viterbi.viterbi(
            jnp.asarray(lpost), klen, skip_pen=skip_pen, log=True,
            time_major=True, layout=layout))
    for ref in refs:
        for g, r in zip(got, _np(*ref)):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("klen,nbase", [(7, 4), (4, 3)])
def test_entry_points_outside_the_tuned_kernels_bit_equal_to_jax(klen,
                                                                 nbase):
    """The port's entry points at klen 7 (16,384 states) and at nbase 3,
    which the tuned CUDA kernels do not take (on a CUDA tensor they take
    the kernels' general route, whose GPU tests hold it to this twin),
    against the JAX package's XLA decoder, which its ``Basecaller`` uses
    off the TPU."""
    post = _posterior(klen, "peaked", T=16, B=2, seed=klen, nbase=nbase)
    assert viterbi_kernel.kernel_route(nbase ** klen, klen,
                                       nbase) == "general"
    vfinal, tb = viterbi_kernel.viterbi_forward(torch.from_numpy(post), klen,
                                                skip_pen=5.0, nbase=nbase)
    score = torch.amax(vfinal, dim=1)
    path, moved = viterbi_kernel.viterbi_backtrace(
        tb, torch.argmax(vfinal, dim=1), nbase=nbase)
    # the entry points take probabilities: log them as the twin does, and
    # hand the JAX decoder the same float32 logs
    lp = torch.log(torch.from_numpy(post) + 1e-10).numpy()
    ref = decode_jax.viterbi(jnp.asarray(lp), klen, skip_pen=5.0, log=True,
                             nbase=nbase, time_major=True)
    for g, r in zip(_np(score, path, moved), _np(*ref)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("klen", [3, 5])
def test_traceback_codes_equal_pallas(klen):
    """The forward twin writes the Pallas kernel's int8 codes, bit for
    bit (lane-major kernel, batch-major output)."""
    lpost = np.log(_posterior(klen, "ties", seed=4) + np.float32(1e-10))
    vfinal, tb = decode.viterbi_forward_plain(
        torch.from_numpy(lpost), klen, skip_pen=5.0, log=True)
    v_ref, tb_ref = pallas_viterbi.viterbi_forward(
        jnp.asarray(lpost), klen, skip_pen=5.0, time_major=True)
    np.testing.assert_array_equal(vfinal.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(tb_ref))


@pytest.mark.parametrize("klen", [3, 5])
def test_move_records_bit_equal_to_jax(klen):
    post = _posterior(klen, "peaked", T=61, B=4, seed=klen)
    lpost = np.log(post + np.float32(1e-10)).astype(np.float32)
    _, path, moved = decode.viterbi(torch.from_numpy(lpost), klen,
                                    skip_pen=0.0, log=True)
    f_splits = (10, 50)
    got = _np(*tbc._move_records(path, moved, klen, f_splits))
    ref = _np(*jbc._move_records(jnp.asarray(path.numpy()),
                                 jnp.asarray(moved.numpy()), klen, f_splits))
    assert [g.dtype for g in got] == [np.int16, np.int32, np.uint8]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("nev", [None, 0, 1, 17])
def test_collapse_path_equal_to_jax(nev):
    post = _posterior(3, "peaked", T=40, B=1, seed=9)
    lpost = np.log(post + np.float32(1e-10)).astype(np.float32)
    _, path, moved = decode.viterbi(torch.from_numpy(lpost), 3,
                                    skip_pen=5.0, log=True)
    got = decode.collapse_path(path[0].numpy(), moved[0].numpy(), nev=nev)
    ref = decode_jax.collapse_path(path[0].numpy(), moved[0].numpy(), nev=nev)
    np.testing.assert_array_equal(got, ref)
