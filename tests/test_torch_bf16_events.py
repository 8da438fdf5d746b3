"""The events model's bfloat16 posterior against the JAX package's (CPU).

chip_smoke's bf16 phase holds each basecall path's bfloat16 posterior to
its float32 one by the two tests of tests/test_bf16.py:40-45: max abs
difference < 0.05 and argmax agreement > 0.95.  The events model at the
events phase's weights (``baseline_lstm``, klen 5, size 64, drawn at
sd 0.5) reads an agreement near 0.91 there, so the phase holds the check
at sd 1.5 and prints sd 0.5.  These tests show that the shortfall at sd 0.5
is bfloat16's and not the port's.  The JAX package runs the same weights,
with its LSTMs fused (the TPU's float32 recurrence, in interpret mode).
Its ``Basecaller`` streams a bfloat16 posterior that is the port's to
within one bfloat16 step.  Its argmax agrees with its own float32 argmax
no better than the port's does.  Every frame whose argmax moves is a tie:
the posterior is near-uniform over 1,025 states (0.85e-3 to 1.1e-3), the
bfloat16 step there is 7.6e-6, and the rounding makes the float32 argmax
state equal to an earlier one.  At sd 1.5 the posterior is peaked and
both packages pass.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sloika_tpu.config as jconfig
import sloika_tpu.nn.core as jcore
import sloika_tpu.nn.rnn as jrnn
from sloika_tpu import basecall as jbc
from sloika_tpu.models import network_factory as jfactory
from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch import config
from sloika_tpu_torch import models as tmodels
from sloika_tpu_torch.data.features import from_events

KLEN, SIZE, SEED = 5, 64, 21
#: the two reads of the one JAX input shape of this file (events)
LENGTHS = np.array([300, 220])
#: chip_smoke's held limits (tests/test_bf16.py:40-45)
POST_TOL, ARGMAX = 0.05, 0.95
SDS = (0.5, 1.5)


def _seeded(layer, sd):
    """chip_smoke's ``seeded_weights``: every parameter from numpy at
    sd / sqrt(fan-in), in the port's parameter order."""
    rs = np.random.RandomState(SEED)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(
                (sd * rs.normal(size=tuple(p.shape))
                 / np.sqrt(p.shape[-1])).astype(np.float32)))
    return layer


def _fuse(layer):
    """Set ``fused`` on every JAX LSTM under ``layer``; returns their
    count."""
    if isinstance(layer, jrnn.Lstm):
        layer.fused = True
        return 1
    subs = getattr(layer, "layers", None) or getattr(layer, "layer", None)
    if subs is None:
        return 0
    return sum(_fuse(s) for s in (subs if isinstance(subs, (list, tuple))
                                  else [subs]))


def _features():
    """(T, 2, 4) zero-padded features of two seeded event reads, as
    chip_smoke's ``event_reads`` makes them (LENGTHS events)."""
    rs = np.random.RandomState(13)
    x = np.zeros((LENGTHS.max(), len(LENGTHS), 4), np.float32)
    for b, L in enumerate(LENGTHS):
        ev = np.zeros(L, dtype=[("mean", "f8"), ("stdv", "f8"),
                                ("length", "f8")])
        ev["mean"] = 90 + 12 * rs.normal(size=L)
        ev["stdv"] = rs.uniform(0.5, 3.0, size=L)
        ev["length"] = rs.geometric(0.1, size=L) / 4000.0
        x[:L, b] = from_events(ev, tag="")
    return x


@pytest.fixture(scope="module")
def posts():
    """{sd: {(package, dtype): (frames, nstate) float32 valid frames of the
    posterior each Basecaller streams to its Viterbi}}; the JAX LSTMs'
    count."""
    x = _features()
    out, nfused = {}, set()
    for sd in SDS:
        port = _seeded(tmodels.network_factory("baseline_lstm")(
            klen=KLEN, sd=0.5, size=SIZE), sd)
        layer = jfactory("baseline_lstm")(klen=KLEN, sd=0.5, size=SIZE)
        nfused.add(_fuse(layer))
        params = jax.tree_util.tree_map(jnp.asarray, port.param_tree())
        out[sd] = {}
        for name, jd, td in (("f32", jnp.float32, torch.float32),
                             ("bf16", jnp.bfloat16, torch.bfloat16)):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jcore, "compute_dtype", jd)
                mp.setattr(jconfig, "compute_dtype", jd)
                mp.setattr(config, "compute_dtype", td)
                jb = jbc.Basecaller(layer, params, KLEN,
                                    viterbi_impl="pallas", post_dtype="auto")
                jp, jl = jb._floored_masked_post(params, jnp.asarray(x),
                                                 jnp.asarray(LENGTHS))
                tb = tbc.Basecaller(port, KLEN, device="cpu",
                                    output="states")
                with torch.inference_mode():
                    tp, tl = tb._floored_masked_post(
                        torch.from_numpy(x), torch.from_numpy(LENGTHS))
            assert jp.dtype == jd and tp.dtype == td
            assert np.array_equal(np.asarray(jl), tl.numpy())
            valid = np.arange(x.shape[0])[:, None] < LENGTHS[None, :]
            out[sd]["jax", name] = np.asarray(jp.astype(jnp.float32))[valid]
            out[sd]["port", name] = tp.float().numpy()[valid]
    return out, nfused


def _agreement(a, b):
    return float((a.argmax(1) == b.argmax(1)).mean())


def test_the_jax_lstms_run_fused(posts):
    """All four LSTMs of baseline_lstm take the fused float32 recurrence
    (the JAX scan's default on the CPU would round its products to bf16)."""
    assert posts[1] == {4}


@pytest.mark.parametrize("sd", SDS)
def test_the_float32_posteriors_agree(posts, sd):
    p = posts[0][sd]
    assert np.abs(p["port", "f32"] - p["jax", "f32"]).max() <= \
        1e-6 * p["jax", "f32"].max()
    assert _agreement(p["port", "f32"], p["jax", "f32"]) == 1.0


@pytest.mark.parametrize("sd", SDS)
def test_the_bf16_posteriors_agree_within_one_step(posts, sd):
    """The port's bfloat16 stream is the JAX package's, to within one
    bfloat16 step (2^-7 of a value bounds it), and has the same argmax."""
    p = posts[0][sd]
    j16, t16 = p["jax", "bf16"], p["port", "bf16"]
    assert np.all(np.abs(t16 - j16) <= 2.0 ** -7 * np.abs(j16))
    assert _agreement(t16, j16) >= 0.99


@pytest.mark.parametrize("pkg", ("jax", "port"))
def test_sd_0_5_fails_the_argmax_test_in_both_packages(posts, pkg):
    """At sd 0.5 the bfloat16 posterior is within 1e-5 of float32's and yet
    its argmax misses 0.95 in the JAX package as in the port, by the same
    share; at sd 1.5 both pass."""
    flat, peaked = posts[0][0.5], posts[0][1.5]
    assert np.abs(flat[pkg, "bf16"] - flat[pkg, "f32"]).max() < 1e-5
    agree = _agreement(flat[pkg, "bf16"], flat[pkg, "f32"])
    assert 0.85 < agree < ARGMAX
    assert abs(agree - _agreement(flat["jax", "bf16"],
                                  flat["jax", "f32"])) <= 0.01
    assert np.abs(peaked[pkg, "bf16"] - peaked[pkg, "f32"]).max() < POST_TOL
    assert _agreement(peaked[pkg, "bf16"], peaked[pkg, "f32"]) > ARGMAX


@pytest.mark.parametrize("pkg", ("jax", "port"))
def test_every_moved_argmax_at_sd_0_5_is_a_bf16_tie(posts, pkg):
    """At sd 0.5 each frame whose bfloat16 argmax differs from float32's
    holds, at the float32 argmax state, a bfloat16 value equal to the
    bfloat16 maximum: the rounding tied it with an earlier state.  (At
    sd 1.5 the few frames that move are near-ties that the bfloat16
    products reorder.)"""
    p = posts[0][0.5]
    p16, p32 = p[pkg, "bf16"], p[pkg, "f32"]
    i32 = p32.argmax(1)
    moved = p16.argmax(1) != i32
    tied = p16[np.arange(len(p16)), i32] == p16.max(1)
    assert moved.sum() > 0 and np.all(tied[moved])
