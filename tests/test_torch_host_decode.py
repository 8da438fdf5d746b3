"""The port's host decoders against the JAX package's (CPU): the legacy
non-transducer decoder (``ops/olddecode.py`` over ``ops/decode_np.py``'s
tables) and ``decode_post_host`` on both of its branches (a raw posterior,
or one floored on the device); and the JAX package's host transducer
Viterbi (``ops/decode_np.py``), which the port replaces by its device
route, against that route's plain twin (``ops/decode.py``) at nbase 4 and 5.

One shared shape: 40 events of posteriors over klen 3 (65 states, or 64 and
65 for a non-transducer without and with a bad state; 126 at nbase 5), drawn
from a numpy seed as softmaxes of normal logits at scale 3.  The two
packages run the same numpy arithmetic, so every result must be bit-equal.
"""
import numpy as np
import pytest
import torch

from sloika_tpu import basecall as jbc
from sloika_tpu.ops import decode_np as jdnp
from sloika_tpu.ops import olddecode as jold
from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch.ops import decode as tdecode
from sloika_tpu_torch.ops import decode_np as tdnp
from sloika_tpu_torch.ops import olddecode as told

T, KLEN = 40, 3


def posterior(nstate, seed, T=T):
    rs = np.random.RandomState(seed)
    logits = 3.0 * rs.normal(size=(T, nstate))
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)).astype(np.float32)


def same(a, b):
    """Equal results, tuples and lists element by element."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_prepare_post_equals_jax(seed):
    post = posterior(65, seed)
    for drop_bad in (False, True):
        same(tdnp.prepare_post(post[:, None], 1e-3, drop_bad),
             jdnp.prepare_post(post[:, None], 1e-3, drop_bad))


@pytest.mark.parametrize("nbase,klen", [(4, 3), (4, 5), (5, 3), (3, 4)])
def test_predecessor_and_successor_tables_equal_jax(nbase, klen):
    nkmer = nbase ** klen
    for order in (1, 2):
        same(tdnp.predecessor_table(nkmer, nbase, order),
             jdnp.predecessor_table(nkmer, nbase, order))
        same(told._successor_table(nkmer, nbase, order),
             jold._successor_table(nkmer, nbase, order))


@pytest.mark.parametrize("nbase", (4, 5))
@pytest.mark.parametrize("skip", (0.0, 5.0))
@pytest.mark.parametrize("seed", (3, 4))
def test_the_plain_twin_is_the_jax_host_viterbi(nbase, skip, seed):
    """The JAX package decodes a transducer read on the host (``decode_np.
    viterbi``); the port decodes it by the device route, whose plain twin
    gives the same call and the same score within float32 round-off, from
    probabilities and from log-probabilities."""
    post = posterior(nbase ** KLEN + 1, seed)
    for p, log in ((post, False), (np.log(post + 1e-10), True)):
        score, call = jdnp.viterbi(p, KLEN, skip_pen=skip, log=log,
                                   nbase=nbase)
        dscore, path, moved = tdecode.viterbi(
            torch.from_numpy(p)[:, None], KLEN, skip_pen=skip, log=log,
            nbase=nbase)
        np.testing.assert_array_equal(
            tdecode.collapse_path(path[0].numpy(), moved[0].numpy()), call)
        assert float(dscore[0]) == pytest.approx(score, rel=1e-5)


@pytest.mark.parametrize("slip", (0.0, 0.1))
@pytest.mark.parametrize("seed", (7, 8))
def test_legacy_decoders_equal_jax(slip, seed):
    post = posterior(64, seed)
    trans = np.log(1e-10 + told.estimate_transitions(post))
    same(told.estimate_transitions(post), jold.estimate_transitions(post))
    prior = [0.3, 0.6, 0.1]
    same(told.estimate_transitions(post, trans=prior),
         jold.estimate_transitions(post, trans=prior))
    same(told.decode_profile(post, trans=trans, slip=slip),
         jold.decode_profile(post, trans=trans, slip=slip))
    same(told.decode_profile(np.log(post), log=True, slip=slip),
         jold.decode_profile(np.log(post), log=True, slip=slip))
    same(told.decode_transition(post, np.log(prior), slip=slip),
         jold.decode_transition(post, np.log(prior), slip=slip))
    same(told.decode_simple(post, slip=slip),
         jold.decode_simple(post, slip=slip))


def test_estimate_transitions_refuses_other_priors():
    with pytest.raises(ValueError):
        told.estimate_transitions(posterior(64, 0), trans=[0.5, 0.5])


@pytest.mark.parametrize("bad", (False, True))
@pytest.mark.parametrize("floored", (False, True))
@pytest.mark.parametrize("trans", (None, [0.3, 0.6, 0.1]))
def test_decode_post_host_equals_jax(bad, floored, trans):
    """Both branches: a posterior floored on the device (``floored``: only
    the bad frames and column dropped) or raw (``prepare_post``)."""
    nstate = 4 ** KLEN + bad
    post = posterior(nstate, 9)[:, None]
    if floored:
        post = 1e-5 + (1.0 - 1e-5) * post
    got = tbc.decode_post_host(post, KLEN, bad, 1e-5, trans,
                               floored=floored)
    ref = jbc.decode_post_host(post, KLEN, False, bad, 1e-5, 5.0, trans,
                               floored=floored)
    same(got, ref)
    # one state an event, but for the bad frames dropped
    assert len(got[1]) <= T and (bad or len(got[1]) == T)


@pytest.mark.parametrize("bad", (False, True))
def test_decode_post_host_refuses_other_state_counts(bad):
    """A transducer's posterior (one state more than a non-transducer's
    without a bad state) or one over 5 bases is not the legacy decoder's."""
    for nstate in (4 ** KLEN + 1 + bad, 5 ** KLEN + bad):
        with pytest.raises(ValueError, match="posterior has"):
            tbc.decode_post_host(posterior(nstate, 10)[:, None], KLEN, bad,
                                 1e-5)
