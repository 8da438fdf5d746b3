"""The parents of the port's last two kernel redesigns, for timing beside
the new designs in one process (``chip_smoke.py`` phases 4, 9a and 17c).

``csrc/redesign_parents.cu`` keeps the wide route of the banded remap DP
as it was before its cluster design (one block of 1,024 threads a row, the
window's scores in device memory) and the general Viterbi backtrace as it
was before its ring design (one thread a row walking the codes in device
memory).  They give the port's bits.  This module is the library's only
loader, and no path of the port imports it: it counts no launch.
"""
import ctypes

import torch

from sloika_tpu_torch import cuda_build

#: the parent wide route's block: threads, each of ceil(W / 1024) positions
WIDE_THREADS = 1024

_ARGTYPES = {"remap_banded_wide_parent": [ctypes.c_void_p] * 8
             + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2
             + [ctypes.c_void_p],
             "viterbi_back_general_parent": [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 4 + [ctypes.c_void_p]}


def _library():
    return cuda_build.load("redesign_parents", _ARGTYPES)


def remap_banded_wide_parent(ltrans_t, seq_states, pos_mask, prior_initial,
                             starts, slip, W):
    """(traceback (Tp, B, W) int16, vfinal (B, W) f32) by the parent wide
    route: ppt = ceil(W / 1024) positions a thread, two staged traceback
    rows in shared memory, (B, 4, ppt * 1024) floats of device scratch."""
    T, B, nstate = ltrans_t.shape
    P = seq_states.shape[1]
    Tp = starts.shape[0]
    dev = ltrans_t.device
    ppt = -(-W // WIDE_THREADS)
    wc = ppt * WIDE_THREADS
    traceback = torch.empty((Tp, B, W), dtype=torch.int16, device=dev)
    vfinal = torch.empty((B, W), dtype=torch.float32, device=dev)
    scratch = torch.empty((B, 4 * wc), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _library().remap_banded_wide_parent(
            ltrans_t.data_ptr(), seq_states.data_ptr(), pos_mask.data_ptr(),
            prior_initial.data_ptr(), starts.data_ptr(),
            traceback.data_ptr(), vfinal.data_ptr(), scratch.data_ptr(), T,
            B, nstate, P, W, Tp, float(slip), ppt, 2 * 2 * wc,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "remap_banded_wide_parent")
    return traceback, vfinal


def viterbi_back_general_parent(tb, last_state, nbase):
    """(path (B, T) int32, moved (B, T) bool) by the parent general
    backtrace: a thread a row."""
    T, B, K = tb.shape
    last = last_state.to(torch.int32).contiguous()
    path = torch.empty((B, T), dtype=torch.int32, device=tb.device)
    moved = torch.empty((B, T), dtype=torch.bool, device=tb.device)
    with torch.cuda.device(tb.device):
        err = _library().viterbi_back_general_parent(
            tb.data_ptr(), last.data_ptr(), path.data_ptr(),
            moved.data_ptr(), T, B, K, nbase,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "viterbi_back_general_parent")
    return path, moved
