"""Transducer Viterbi on the GPU: the CUDA kernels and their dispatch.

:data:`viterbi_forward` replaces the Pallas TPU kernels
``sloika_tpu/ops/pallas/viterbi.py::_fwd_kernel_sm`` (the production,
state-major layout) and its lane-major twin ``_fwd_kernel`` with
``csrc/viterbi_fwd.cu``: it reads the forward's native time-major posterior
(T, B, K+1) in the probability domain, takes ``log(p + 1e-10)`` in-kernel
and writes int8 traceback codes (T, B, K) and the final scores (B, K).

:data:`viterbi_backtrace` replaces the int8-code backtrace of
``_viterbi_impl`` (an XLA scan in the JAX package) with
``csrc/viterbi_back.cu``.

Both dispatch on the device of their input: the kernel for a CUDA tensor,
the plain twin of :mod:`sloika_tpu_torch.ops.decode` for a CPU tensor.
``launches`` counts kernel launches.  The kernels handle nbase = 4 only.
"""
import ctypes

import torch

from sloika_tpu_torch import cuda_build
from sloika_tpu_torch.ops.decode import (viterbi_backtrace_plain,
                                         viterbi_forward_plain)


class ViterbiForward:
    """(vfinal (B, K), traceback (T, B, K) int8) from a probability-domain
    posterior (T, B, K+1), column 0 = stay.  Replaces the Pallas TPU
    kernels ``sloika_tpu/ops/pallas/viterbi.py::_fwd_kernel_sm`` and
    ``_fwd_kernel`` with ``csrc/viterbi_fwd.cu``."""

    _ARGTYPES = {"viterbi_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                 + [ctypes.c_float, ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def __call__(self, post, klen, skip_pen=0.0, nbase=4):
        if post.device.type == "cpu":
            return viterbi_forward_plain(post, klen, skip_pen=skip_pen,
                                         nbase=nbase)
        T, B, nst = post.shape
        K = nst - 1
        if nbase != 4 or K != 4 ** klen or not 2 <= klen <= 6:
            raise ValueError("viterbi_fwd takes nbase 4 and klen 2..6 "
                             "(got nbase {}, klen {}, {} states)".format(
                                 nbase, klen, nst))
        cuda_build.check_tensor(post, (T, B, nst), torch.float32,
                                post.device, "post")
        tb = torch.empty((T, B, K), dtype=torch.int8, device=post.device)
        vfinal = torch.empty((B, K), dtype=torch.float32, device=post.device)
        if T == 0 or B == 0:
            return vfinal, tb
        lib = cuda_build.load("viterbi_fwd", self._ARGTYPES)
        with torch.cuda.device(post.device):
            err = lib.viterbi_fwd(post.data_ptr(), tb.data_ptr(),
                                  vfinal.data_ptr(), T, B, K,
                                  float(skip_pen),
                                  torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "viterbi_fwd")
        self.launches += 1
        return vfinal, tb


class ViterbiBacktrace:
    """(path (B, T) int32, moved (B, T) bool) from traceback codes
    (T, B, K) int8 and the last state of each row.  Replaces the XLA
    backtrace of ``sloika_tpu/ops/pallas/viterbi.py::_viterbi_impl`` with
    ``csrc/viterbi_back.cu``."""

    _ARGTYPES = {"viterbi_back": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def __call__(self, tb, last_state, nbase=4):
        if tb.device.type == "cpu":
            return viterbi_backtrace_plain(tb, last_state, nbase=nbase)
        T, B, K = tb.shape
        if nbase != 4 or K % 16:
            raise ValueError("viterbi_back takes nbase 4 and K % 16 == 0")
        cuda_build.check_tensor(tb, (T, B, K), torch.int8, tb.device, "tb")
        last = last_state.to(torch.int32).contiguous()
        cuda_build.check_tensor(last, (B,), torch.int32, tb.device,
                                "last_state")
        path = torch.empty((B, T), dtype=torch.int32, device=tb.device)
        moved = torch.empty((B, T), dtype=torch.bool, device=tb.device)
        if T == 0 or B == 0:
            return path, moved
        lib = cuda_build.load("viterbi_back", self._ARGTYPES)
        with torch.cuda.device(tb.device):
            err = lib.viterbi_back(tb.data_ptr(), last.data_ptr(),
                                   path.data_ptr(), moved.data_ptr(),
                                   T, B, K,
                                   torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "viterbi_back")
        self.launches += 1
        return path, moved


#: the Viterbi forward entry point (kernel on CUDA, plain twin on the CPU)
viterbi_forward = ViterbiForward()

#: the backtrace entry point (kernel on CUDA, plain twin on the CPU)
viterbi_backtrace = ViterbiBacktrace()


def viterbi(post, klen, skip_pen=0.0, nbase=4):
    """Viterbi decode of a probability-domain time-major posterior
    (T, B, K+1) through :data:`viterbi_forward` and
    :data:`viterbi_backtrace` (cf. ``sloika_tpu.ops.pallas.viterbi.viterbi``
    with ``time_major=True``).

    :returns: (score (B,), path (B, T) int32, moved (B, T) bool)
    """
    vfinal, tb = viterbi_forward(post, klen, skip_pen=skip_pen, nbase=nbase)
    score = torch.amax(vfinal, dim=1)
    last = torch.argmax(vfinal, dim=1)          # first of equal maxima
    path, moved = viterbi_backtrace(tb, last, nbase=nbase)
    return score, path, moved
