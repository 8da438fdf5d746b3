"""The plain reference of bonito's CRF decode (seqdist's ``CTC_CRF``, as
bonito's ``decode_batch`` calls it): the transition posteriors of a batch
of score frames by forward-backward, the Viterbi over their logs plus 1e-8,
and each row's best path's transition a frame, a k of 1..4 emitting base
k - 1 of ACGT (``path_to_str``).

A frame's scores M (T, B, N, 5) are the transitions into each of N =
4^state_len states: [s, 0] the stay, [s, k] the step from state
(k - 1) N/4 + s // 4.  A row's DP runs over its first ``frames`` frames,
all states open at both ends.  Departures from seqdist, exact in exact
arithmetic: the posterior is normalised a frame (a softmax over its 5N
transitions, not ``exp(alpha + M + beta - logZ)``, which loses ~1e-3 nats
to the cancellation of 2,000 frames' sums in float32); the forward,
backward and Viterbi sums are kept relative to their state 0, the
Viterbi's offsets summed in float64; of equal maxima the first wins.

It imports nothing of the measured program and nothing of the JAX
package.
"""
import torch

EPS = 1e-8


def transitions(N, device):
    """(idx (N, 5): the state each transition into s leaves; into_s,
    into_k (N, 5): the (s, k) of the transitions into each state)."""
    s = torch.arange(N, device=device)
    idx = torch.cat([s[:, None], torch.arange(N, device=device)
                     .repeat_interleave(4).reshape(4, -1).t()], dim=1)
    Q = N // 4
    into_s = torch.cat([s[:, None], 4 * (s[:, None] % Q)
                        + torch.arange(4, device=device)[None, :]], dim=1)
    into_k = torch.cat([torch.zeros_like(s)[:, None],
                        (s[:, None] // Q + 1).expand(-1, 4)], dim=1)
    return idx, into_s, into_k


def decode(scores, frames):
    """(score (B,) float64 on the host, labels (B, T) int64 on the host)
    of float32 scores (T, B, 5N) on any device: each row's best path's
    score over log(P + 1e-8) and its transition k a frame (0 past the
    row's frames)."""
    T, B, C = scores.shape
    N = C // 5
    dev = scores.device
    M = scores.reshape(T, B, N, 5)
    idx, into_s, into_k = transitions(N, dev)
    n = frames.to(dev)
    beta = scores.new_zeros((T + 1, B, N))
    b = scores.new_zeros((B, N))
    for t in range(T - 1, -1, -1):
        live = (t < n)[:, None]
        bhat = b - b[:, :1]
        beta[t + 1] = torch.where(live, bhat, 0.0)
        terms = M[t] + bhat[:, :, None]
        b = torch.where(live, torch.logsumexp(terms[:, into_s, into_k],
                                              dim=2), b)
    a = scores.new_zeros((B, N))
    v = scores.new_zeros((B, N))
    off = torch.zeros(B, dtype=torch.float64, device=dev)
    back = torch.zeros((T, B, N), dtype=torch.uint8, device=dev)
    for t in range(T):
        live = t < n
        off += torch.where(live, v[:, 0].double(), 0.0)
        e = (a - a[:, :1])[:, idx] + M[t]
        post = torch.softmax((e + beta[t + 1][:, :, None]).reshape(B, -1),
                             dim=1).reshape(B, N, 5)
        cand = (v - v[:, :1])[:, idx] + torch.log(post + EPS)
        best, k = torch.max(cand, dim=2)
        a = torch.where(live[:, None], torch.logsumexp(e, dim=2), a)
        v = torch.where(live[:, None], best, v)
        back[t] = k.to(torch.uint8)
    s = torch.argmax(v, dim=1)
    rows = torch.arange(B, device=dev)
    score = torch.where(n > 0, off + v[rows, s].double(), 0.0)
    back = back.cpu()
    s, n = s.cpu(), n.cpu()
    labels = torch.zeros((B, T), dtype=torch.int64)
    rows = torch.arange(B)
    for t in range(T - 1, -1, -1):
        live = t < n
        k = back[t, rows, s].long()
        labels[:, t] = torch.where(live, k, 0)
        s = torch.where(live & (k > 0), (k - 1) * (N // 4) + s // 4, s)
    return score.cpu().numpy(), labels.numpy()
