"""The host decoder of non-transducer models, copied from
``sloika_tpu/ops/olddecode.py``: Viterbi over kmer states with per-event
[stay, step, skip] weights and a uniform "slip" teleport.  On equal scores
a skip beats a step beats a slip beats a stay.
"""
import numpy as np

from sloika_tpu_torch.ops.decode_np import predecessor_table

_ETA = 1e-10
_NBASE = 4
_NSTEP = _NBASE
_NSKIP = _NSTEP ** 2
#: step/skip weights are priors over *which* kmer is moved to, so each is
#: normalised by its fan-out before entering the DP
_STEP_FACTOR = np.log(_NSTEP)
_SKIP_FACTOR = np.log(_NSKIP)


def decode_profile(post, trans=None, log=False, slip=0.0):
    """Viterbi decoding with per-event [stay, step, skip] weights and an
    optional uniform slip move (sloika_tpu/ops/olddecode.py:26).

    :param post: (time, nkmer) posteriors
    :param trans: per-event log-scaled transition weight triples
    :param log: posteriors already log-scaled
    :param slip: slip probability (uniform teleport between states)
    :returns: (score, state sequence, one state an event)
    """
    nev, nkmer = post.shape
    lpost = np.asarray(post, dtype=float)
    if not log:
        lpost = np.log(lpost + _ETA)

    if trans is None:
        ev_weights = np.zeros((nev - 1, 3))
    else:
        ev_weights = np.array(trans, dtype=float)[:nev - 1].copy()
        ev_weights[:, 1] -= _STEP_FACTOR
        ev_weights[:, 2] -= _SKIP_FACTOR

    log_slip = np.log(_ETA + slip)
    step_pred = predecessor_table(nkmer, _NBASE, 1)
    skip_pred = predecessor_table(nkmer, _NBASE, 2)
    states = np.arange(nkmer)

    score = lpost[0].copy()
    tb = np.empty((nev - 1, nkmer), dtype=np.int32)
    for ev in range(nev - 1):
        w_stay, w_step, w_skip = ev_weights[ev]

        stepped = score[step_pred]
        a = np.argmax(stepped, axis=1)
        step_score = stepped[states, a] + w_step
        step_from = step_pred[states, a]

        skipped = score[skip_pred]
        a = np.argmax(skipped, axis=1)
        skip_score = skipped[states, a] + w_skip
        skip_from = skip_pred[states, a]

        slip_from = int(np.argmax(score))
        slip_score = score[slip_from] + log_slip

        # rows in tie priority order (skip > step > slip > stay): argmax
        # keeps the first of equal scores
        cand_scores = np.stack([skip_score, step_score,
                                np.full(nkmer, slip_score), score + w_stay])
        cand_from = np.stack([skip_from, step_from,
                              np.full(nkmer, slip_from, dtype=np.int32),
                              states.astype(np.int32)])
        pick = np.argmax(cand_scores, axis=0)
        tb[ev] = cand_from[pick, states]
        score = cand_scores[pick, states] + lpost[ev + 1]

    state_seq = np.empty(nev, dtype=int)
    state_seq[-1] = int(np.argmax(score))
    for ev in range(nev - 2, -1, -1):
        state_seq[ev] = tb[ev, state_seq[ev + 1]]

    return np.amax(score), state_seq


def decode_transition(post, trans, log=False, slip=0.0):
    """Viterbi decoding with one [stay, step, skip] weight for every event
    (sloika_tpu/ops/olddecode.py:90)."""
    return decode_profile(post, trans=np.tile(np.asarray(trans),
                                              (len(post), 1)),
                          log=log, slip=slip)


def decode_simple(post, log=False, slip=0.0):
    """Viterbi decoding with uniform transitions
    (sloika_tpu/ops/olddecode.py:102)."""
    return decode_profile(post, log=log, slip=slip)


def _successor_table(nkmer, nbase, order):
    """int32 table of shape (nkmer, nbase**order): row i lists every state
    reachable from state i by an ``order``-base move
    (sloika_tpu/ops/olddecode.py:107)."""
    width = nbase ** order
    shifted = (np.arange(nkmer, dtype=np.int64) * width) % nkmer
    fresh = np.arange(width, dtype=np.int64)
    return (shifted[:, None] + fresh[None, :]).astype(np.int32)


def estimate_transitions(post, trans=None):
    """Per-event estimate of stay/step/skip weights from the posteriors
    (sloika_tpu/ops/olddecode.py:117): each move family's mass is the
    overlap of the previous event's posterior with the current event's mean
    over each state's successors.

    :param trans: prior [stay, step, skip]; None takes the global estimate
    :returns: (time, 3) row-normalised transition weights
    """
    if trans is not None and len(trans) != 3:
        raise ValueError('Incorrect number of transitions')
    nev, nkmer = post.shape
    succ_step = _successor_table(nkmer, _NBASE, 1)
    succ_skip = _successor_table(nkmer, _NBASE, 2)

    res = np.full((nev, 3), _ETA)
    for ev in range(1, nev):
        prev, cur = post[ev - 1], post[ev]
        stay = float(np.dot(prev, cur))
        step = float(np.dot(prev, cur[succ_step].mean(axis=1)))
        skip = float(np.dot(prev, cur[succ_skip].mean(axis=1)))
        res[ev - 1] = [stay, step, skip]

    if trans is None:
        trans = np.sum(res, axis=0)
        trans /= np.sum(trans)

    res *= trans
    res /= np.sum(res, axis=1).reshape((-1, 1))
    return res
