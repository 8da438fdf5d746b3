"""The plain reference of sloika's transducer decode: the min_prob floor,
the kmer-transducer Viterbi over a posterior, the backtrace, and the
collapse of a state path to a call.

It imports nothing of the measured program and nothing of the JAX
package.  The DP is sloika's ``decode.viterbi`` with the tie-breaks of
the Pallas kernel it was ported from (``sloika_tpu/ops/pallas/viterbi.py``;
plain form ``sloika_tpu_torch/ops/decode.py:37-97``): a state steps from
the best of the ``nbase`` kmers it extends, skips from the best of the
``nbase**2`` two back (at ``skip`` below), the first of equal maxima wins,
a skip wins a tie with a step and a stay wins a tie with a move.  Column 0
of the posterior is the stay state.
"""
import numpy as np
import torch

from benchmark.reference import steps

ETA = 1e-10


def floor(post, min_prob, frames):
    """``(1 - min_prob) * post + min_prob``, with one-hot stays on the
    frames past each row's count (the padding every batch of the program
    decodes past a row's end)."""
    post = (1.0 - min_prob) * post + min_prob
    T = post.shape[0]
    pad = torch.arange(T, device=post.device)[:, None] >= frames[None, :]
    stay = torch.zeros(post.shape[2], dtype=post.dtype, device=post.device)
    stay[0] = 1.0
    return torch.where(pad[:, :, None], stay, post)


def forward(post, klen, skip, nbase=4):
    """(final scores (B, K), traceback codes (T, B, K) int8): -1 a stay, g
    a step from group g, nbase + h a skip from group h."""
    T, B, _ = post.shape
    K = nbase ** klen
    nrs, nrk = K // nbase, K // (nbase * nbase)
    lp = torch.log(post + ETA)
    tb = torch.empty((T, B, K), dtype=torch.int8, device=post.device)
    tb[0] = -1
    score = lp[0, :, 1:].clone()
    stay_code = torch.tensor(-1, dtype=torch.int8, device=post.device)

    def step(lp_t, tb_t):
        mx, am = torch.max(score.view(B, nbase, nrs), dim=1)
        mk, ak = torch.max(score.view(B, nbase * nbase, nrk), dim=1)
        sk = (mk - skip)[:, :, None]
        mx, am = mx.view(B, nrk, nbase), am.view(B, nrk, nbase)
        by_step = mx > sk                       # a skip wins a tie
        best = torch.where(by_step, mx, sk).view(B, nrs, 1)
        code = torch.where(by_step, am, ak[:, :, None] + nbase).to(
            torch.int8).view(B, nrs, 1)
        new = (lp_t[:, 1:].view(B, nrs, nbase) + best).view(B, K)
        stay = score + lp_t[:, :1]
        move = new > stay                       # a stay wins a tie
        torch.where(move.view(B, nrs, nbase), code, stay_code,
                    out=tb_t.view(B, nrs, nbase))
        score.copy_(torch.maximum(new, stay))

    steps.run_steps(step, [lp[1:]], [tb[1:]])
    return score, tb


def backtrace(tb, last, nbase=4):
    """(path (B, T) int64, moved (B, T) bool) walked on the host from the
    final states ``last`` (B,)."""
    tb = tb.cpu().numpy()
    T, B, K = tb.shape
    path = np.empty((B, T), np.int64)
    moved = np.zeros((B, T), bool)
    rows = np.arange(B)
    state = np.asarray(last, np.int64).copy()
    for t in range(T - 1, 0, -1):
        c = tb[t, rows, state].astype(np.int64)
        path[:, t] = state
        moved[:, t] = c >= 0
        prev = np.where(c < nbase, c * (K // nbase) + state // nbase,
                        (c - nbase) * (K // (nbase * nbase))
                        + state // (nbase * nbase))
        state = np.where(c >= 0, prev, state)
    path[:, 0] = state
    return path, moved


def viterbi(post, klen, skip, nbase=4):
    """(score (B,) float64, path (B, T), moved (B, T)) of floored posts."""
    vfinal, tb = forward(post, klen, skip, nbase)
    score = torch.amax(vfinal, dim=1).double().cpu().numpy()
    last = torch.argmax(vfinal, dim=1).cpu().numpy()
    del vfinal
    path, moved = backtrace(tb, last, nbase)
    return score, path, moved


def collapse_states(path, moved, frames):
    """The states entered by a move, after the opening state: a whole
    read's call (``output="states"``)."""
    path, moved = path[:frames], moved[:frames].copy()
    moved[0] = True
    return path[moved]


def window_bases(path, moved, klen, f_lo, f_hi, first_window):
    """The base codes a chunked window contributes to its read: those its
    moves emit in frames [f_lo, f_hi), after the opening kmer's bases for
    a read's first window.  A move emits the new kmer's last base where
    the kmer before it matches at shift 1, else its last two (sloika's
    maximal-overlap ``kmers_to_sequence``)."""
    npow = 4 ** (klen - 1)
    prev = np.concatenate([path[:1], path[:-1]])
    one = (prev % npow) == (path // 4)
    t = np.flatnonzero(moved[:f_hi])
    t = t[t >= f_lo]
    codes = np.stack([(path[t] // 4) % 4, path[t] % 4], axis=1)
    keep = np.stack([~one[t], np.ones(len(t), bool)], axis=1)
    out = codes[keep]
    if first_window:
        first = (path[0] >> (2 * np.arange(klen - 1, -1, -1))) & 3
        out = np.concatenate([first, out])
    return out.astype(np.uint8)
