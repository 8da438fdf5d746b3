"""Transducer Viterbi decoding in plain PyTorch (cf.
``sloika_tpu/ops/decode_jax.py``).

These functions are the plain twins of the CUDA kernels in
:mod:`sloika_tpu_torch.ops.viterbi_kernel`: the forward pass writes the
same int8 traceback codes as the Pallas kernel
(``sloika_tpu/ops/pallas/viterbi.py``, -1 stay, g step from group g,
nbase + h skip from group h) and the backtrace decodes them as its
``_viterbi_impl`` does.  Posteriors are time-major (T, B, nstate) with
column 0 the stay state.

Tie-breaks (they decide the path): the step and skip maxima keep the first
of equal predecessors; a skip wins a tie with a step; a stay wins a tie with
a move.
"""
import numpy as np
import torch

from sloika_tpu_torch import variables as sv

_ETA = 1e-10


def _first_max(p):
    """(max, first-wins arg) over axis 1 of (B, n, m), both (B, m)."""
    mx = p[:, 0]
    am = torch.zeros_like(mx, dtype=torch.int32)
    for g in range(1, p.shape[1]):
        cand = p[:, g]
        better = cand > mx
        mx = torch.where(better, cand, mx)
        am = torch.where(better, g, am)
    return mx, am


def viterbi_forward_plain(post, klen, skip_pen=0.0, nbase=4, log=False):
    """Viterbi forward pass.

    :param post: (T, B, nbase**klen + 1) posteriors, probabilities unless
        ``log`` (then log-probabilities); a bfloat16 row is upcast to
        float32 before the log, as the Pallas kernel's ``_row`` does, so
        the DP is float32
    :returns: (vfinal (B, K) float32, traceback codes (T, B, K) int8)
    """
    T, B, nst = post.shape
    K = sv.nkmer(klen, nbase=nbase)
    if nst != K + 1:
        raise ValueError("posterior has {} states, klen {} needs {}".format(
            nst, klen, K + 1))
    nstep, nskip = nbase, nbase * nbase
    nrs, nrk = K // nstep, K // nskip

    def lrow(t):
        row = post[t].to(torch.promote_types(post.dtype, torch.float32))
        return row if log else torch.log(row + _ETA)

    tb = torch.empty((T, B, K), dtype=torch.int8, device=post.device)
    tb[0] = -1
    score = lrow(0)[:, 1:].contiguous()
    for t in range(1, T):
        lp = lrow(t)
        mx, am = _first_max(score.view(B, nstep, nrs))
        mk, ak = _first_max(score.view(B, nskip, nrk))
        sk = (mk - skip_pen).repeat_interleave(nstep, dim=1)     # (B, nrs)
        ak = ak.repeat_interleave(nstep, dim=1)
        m = torch.maximum(mx, sk)
        c = torch.where(mx > sk, am, nstep + ak)
        new = lp[:, 1:] + m.repeat_interleave(nstep, dim=1)
        stay = score + lp[:, 0:1]
        tb[t] = torch.where(new > stay, c.repeat_interleave(nstep, dim=1),
                            -1)
        score = torch.maximum(new, stay)
    return score.contiguous(), tb


def viterbi_backtrace_plain(tb, last_state, nbase=4):
    """Walk the traceback codes from ``last_state`` (B,) back to t = 0.

    :returns: (path (B, T) int32 state at each step, moved (B, T) bool —
        True where the path entered its state by a move)
    """
    T, B, K = tb.shape
    nstep, nskip = nbase, nbase * nbase
    path = torch.empty((B, T), dtype=torch.int32, device=tb.device)
    moved = torch.empty((B, T), dtype=torch.bool, device=tb.device)
    rows = torch.arange(B, device=tb.device)
    state = last_state.long()
    for t in range(T - 1, 0, -1):
        c = tb[t, rows, state].long()
        path[:, t] = state
        moved[:, t] = c >= 0
        prev = torch.where(c < nstep,
                           c * (K // nstep) + state // nstep,
                           (c - nstep) * (K // nskip) + state // nskip)
        state = torch.where(c >= 0, prev, state)
    path[:, 0] = state
    moved[:, 0] = False
    return path, moved


def viterbi(post, klen, skip_pen=0.0, log=False, nbase=4):
    """Batched Viterbi decode of time-major posteriors, all in plain torch.

    :returns: (score (B,), path (B, T) int32, moved (B, T) bool)
    """
    vfinal, tb = viterbi_forward_plain(post, klen, skip_pen=skip_pen,
                                       nbase=nbase, log=log)
    score = torch.amax(vfinal, dim=1)
    last = torch.argmax(vfinal, dim=1)          # first of equal maxima
    path, moved = viterbi_backtrace_plain(tb, last, nbase=nbase)
    return score, path, moved


def collapse_path(path, moved, nev=None):
    """Collapse a full state path to the called sequence: the initial state
    followed by every state entered by a move (host side, numpy)."""
    path = np.asarray(path)
    moved = np.asarray(moved).astype(bool)
    if nev is not None:
        path, moved = path[:nev], moved[:nev]
    if len(path) == 0:
        return path
    keep = moved.copy()
    keep[0] = True
    return path[keep]
