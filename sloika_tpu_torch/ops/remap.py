"""The exact sequence-remap DP in plain PyTorch (cf.
``sloika_tpu/ops/remap_jax.py``).

Viterbi alignment of transducer log-posteriors to known sequences: each
frame stays on its position, steps one position forward, or slips ``k >= 2``
positions forward at a cost of ``slip`` per skipped position.  The slip
update is a prefix max over positions,

    from_score[j] = max_{k <= j-2} (x[k] - slip * (j-1-k))
                  = cummax(x + slip*k)[j-2] - slip * (j-1),

with the earlier position winning ties.  This module is the reference the
tests hold the banded kernel's full-window form against; the production
remap runs through :func:`sloika_tpu_torch.ops.remap_kernel.
map_to_sequence_banded`.
"""
import torch

#: padding-position score (sloika_tpu/ops/remap_jax.py:29): far below any
#: reachable path score, which reaches -1e5..-1e6 on long reads
NEG_LARGE = -1.0e30


def slip_update(x, slip):
    """Geometric-slip scores of each row (sloika_tpu/ops/remap_jax.py:32).

    :param x: (B, n) previous scores
    :returns: (from_score, from_pos), both (B, n): position j holds the best
        ``x[k] - slip*(j-1-k)`` over ``k <= j-2`` and that ``k`` (the
        earliest of equal maxima); entries 0 and 1 are -1e38 and 0
    """
    B, n = x.shape
    idx = torch.arange(n, dtype=torch.float32, device=x.device)
    y = x + slip * idx
    cmax = torch.cummax(y, dim=1).values
    # the running max first reaches its value where it strictly rises;
    # torch.cummax itself keeps the latest of equal maxima
    rises = torch.ones_like(y, dtype=torch.bool)
    rises[:, 1:] = y[:, 1:] > cmax[:, :-1]
    ipos = torch.arange(n, dtype=torch.int64, device=x.device)
    cpos = torch.cummax(torch.where(rises, ipos, 0), dim=1).values

    from_score = torch.full((B, n), -1e38, dtype=x.dtype, device=x.device)
    from_pos = torch.zeros((B, n), dtype=torch.int32, device=x.device)
    from_score[:, 2:] = cmax[:, :-2] - slip * (idx[2:] - 1.0)
    from_pos[:, 2:] = cpos[:, :-2].to(torch.int32)
    return from_score, from_pos


def map_to_sequence(ltrans, seq_states, slip, prior_initial, prior_final,
                    pos_mask):
    """Batched exact Viterbi alignment (sloika_tpu/ops/remap_jax.py:60).

    :param ltrans: (B, T, nstate) log posteriors, column 0 = stay
    :param seq_states: (B, npos) int emission state per position
    :param slip: slip penalty (>= 0)
    :param prior_initial, prior_final: (B, npos) log position priors
    :param pos_mask: (B, npos) True for real positions
    :returns: (score (B,), path (B, T) int32 sequence positions)
    """
    B, T, _ = ltrans.shape
    npos = seq_states.shape[1]
    dev = ltrans.device
    neg = torch.tensor(NEG_LARGE, dtype=torch.float32, device=dev)
    slip = torch.tensor(slip, dtype=torch.float32, device=dev)
    barange = torch.arange(B, device=dev)
    seq = seq_states.long()
    positions = torch.arange(npos, dtype=torch.int32, device=dev)

    emit0 = torch.gather(ltrans[:, 0], 1, seq)
    pscore = torch.where(pos_mask, prior_initial
                         + torch.fmax(emit0, ltrans[:, 0, 0:1]), neg)
    vmat = []
    for t in range(1, T):
        lt = ltrans[:, t]
        emit = torch.gather(lt, 1, seq)
        # stay
        vm = positions.expand(B, npos).clone()
        cscore = pscore + lt[:, 0:1]
        # step
        step_score = pscore[:, :-1] + emit[:, 1:]
        take = step_score > cscore[:, 1:]
        cscore[:, 1:] = torch.where(take, step_score, cscore[:, 1:])
        vm[:, 1:] = torch.where(take, positions[:-1], vm[:, 1:])
        # slip
        from_score, from_pos = slip_update(pscore, slip)
        from_score = from_score + emit
        take = from_score > cscore
        vm = torch.where(take, from_pos, vm)
        cscore = torch.where(take, from_score, cscore)

        pscore = torch.where(pos_mask, cscore, neg)
        vmat.append(vm)
    pscore = pscore + prior_final

    last = torch.argmax(pscore, dim=1)           # first of equal maxima
    score = pscore[barange, last]
    path = torch.empty((B, T), dtype=torch.int32, device=dev)
    pos = last
    path[:, T - 1] = pos.to(torch.int32)
    for t in range(T - 1, 0, -1):
        pos = vmat[t - 1][barange, pos].long()
        path[:, t - 1] = pos.to(torch.int32)
    return score, path
