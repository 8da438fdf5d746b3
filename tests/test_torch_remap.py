"""The remap slice against the JAX package (CPU).

Inputs are made with numpy from seeds and fed to both packages.  The DP
twins get log-posteriors made once with numpy (torch and XLA ``log`` differ
in the last ulp on the CPU); the JAX Pallas kernel runs in interpret mode,
as ``tests/test_pallas_remap.py`` runs it.  Each JAX run is made once, in a
module-scoped fixture.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sloika_tpu import util as jutil
from sloika_tpu.ops import remap_banded as jbanded
from sloika_tpu.ops import remap_jax
from sloika_tpu.ops.pallas import remap as pr
from sloika_tpu_torch.ops import remap as tops
from sloika_tpu_torch.ops import remap_banded as tbanded
from sloika_tpu_torch.ops import remap_kernel as rk
from tests.test_remap_banded import _make_case

#: score tolerance where the two sides sum in another order (the JAX test's)
SCORE_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Band schedules
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(2, 3))
def _jax_schedules(nframes, nposs, T, W):
    return (jbanded.band_starts(nframes, nposs, T, W),
            pr.band_starts_blocked(nframes, nposs, T, W, pr.block_len(W)))


@pytest.mark.parametrize("nframes,nposs,T,W", [
    ([400, 300, 250], [200, 150, 90], 400, 64),    # ragged rows
    ([400, 37, 1], [380, 20, 1], 512, 128),        # npos < W, one frame
    ([1000, 999], [999, 3], 1024, 256),            # slope 1
])
def test_band_schedules_match_jax(nframes, nposs, T, W):
    nf, npos = np.array(nframes, np.int32), np.array(nposs, np.int32)
    TB = rk.block_len(W)
    assert TB == pr.block_len(W)
    base, blocked = _jax_schedules(jnp.asarray(nf), jnp.asarray(npos), T, W)
    np.testing.assert_array_equal(
        tbanded.band_starts(_t(nf), _t(npos), T, W).numpy(),
        np.asarray(base))
    np.testing.assert_array_equal(
        rk.band_starts_blocked(_t(nf), _t(npos), T, W, TB).numpy(),
        np.asarray(blocked))


# ---------------------------------------------------------------------------
# Kernel 7 and 8's plain twins against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("W",))
def _jax_banded(lt, seq_pad, mask, nframes, nposs, slip, p0, p1, W):
    """The Pallas path of sloika_tpu/ops/pallas/remap.py:278-365 (its code,
    batch-major entry), keeping the kernels' outputs: (traceback, vfinal,
    starts, score, path (B, T))."""
    B, T, nstate = lt.shape
    P = seq_pad.shape[1]
    TB = pr.block_len(W)
    neg = jnp.float32(remap_jax.NEG_LARGE)
    lt_t = jnp.moveaxis(lt, 0, 1)
    Tp = -(-T // TB) * TB
    if Tp != T:
        stay_row = jnp.full((nstate,), jnp.float32(pr._LOG_ETA)).at[0].set(0)
        lt_t = jnp.concatenate(
            [lt_t, jnp.broadcast_to(stay_row, (Tp - T, B, nstate))], axis=0)
    starts = pr.band_starts_blocked(nframes, nposs, Tp, W, TB)
    d = jnp.diff(starts, axis=0, prepend=starts[0:1])
    emit, valid = pr._block_emissions(lt_t, seq_pad, mask, starts[::TB], W,
                                      TB)
    emit = jnp.where(jnp.arange(Tp)[:, None, None] < T, emit, neg)
    stay = lt_t[:, :, 0:1]
    warange = jnp.arange(W, dtype=jnp.int32)
    p0_w = jnp.take_along_axis(
        p0, jnp.clip(starts[0][:, None] + warange, 0, P - 1), axis=1)
    emit = emit.at[0].set(jnp.where(emit[0] > neg * 0.5,
                                    p0_w + jnp.fmax(emit[0], stay[0]), neg))
    nbits = 0 if W >= P else max(int(TB).bit_length(), 1)
    spec = partial(pl.BlockSpec, memory_space=pr.pltpu.VMEM)
    traceback, vfinal = pl.pallas_call(
        partial(pr._banded_kernel, B=B, W=W, TB=TB, nbits=nbits),
        grid=(Tp,),
        in_specs=[pl.BlockSpec((1, 1), lambda t: (0, 0),
                               memory_space=pr.pltpu.SMEM),
                  spec((1, B, W), lambda t: (t, 0, 0)),
                  spec((1, B, 1), lambda t: (t, 0, 0)),
                  spec((1, B, 1), lambda t: (t, 0, 0)),
                  spec((1, B, W), lambda t: (t // TB, 0, 0))],
        out_specs=[spec((1, B, W), lambda t: (t, 0, 0)),
                   spec((B, W), lambda t: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((Tp, B, W), jnp.int16),
                   jax.ShapeDtypeStruct((B, W), jnp.float32)],
        scratch_shapes=[pr.pltpu.VMEM((B, W), jnp.float32)],
        interpret=True,
    )(slip.reshape(1, 1), emit, stay, d[:, :, None].astype(jnp.int32),
      valid.astype(jnp.int32))
    s_last = starts[Tp - 1]
    pscore = vfinal + jnp.take_along_axis(
        p1, jnp.clip(s_last[:, None] + warange, 0, P - 1), axis=1)
    last_w = jnp.argmax(pscore, axis=1).astype(jnp.int32)
    score = pscore[jnp.arange(B), last_w]
    path = pr._backtrack(traceback, starts, s_last + last_w, B, W)
    return traceback, vfinal, starts, score, path[:T].T


def _three_rows():
    rs = np.random.RandomState(11)
    nframes = np.array([400, 300, 250], np.int32)
    nposs = np.array([200, 150, 90], np.int32)
    lt, seq_pad, mask = _make_case(rs, nframes, nposs, 400, 256)
    zeros = np.zeros((3, 256), np.float32)
    return lt, seq_pad, mask, nframes, nposs, 3.0, zeros, zeros


def _slips():
    """Paths that jump 3 positions every 40 frames (test_pallas_remap.py:67),
    at the three-row case's shapes, so the JAX runs share one compile."""
    rs = np.random.RandomState(5)
    B, T, P, nstate = 3, 400, 256, 66
    nframes = np.array([400, 220, 200], np.int32)
    nposs = np.array([250, 180, 160], np.int32)
    lt = np.full((B, T, nstate), np.log(1e-6), dtype=np.float32)
    seq_pad = np.zeros((B, P), np.int32)
    mask = np.zeros((B, P), bool)
    for b in range(B):
        npos, tb = nposs[b], nframes[b]
        seq = rs.randint(1, nstate, size=npos).astype(np.int32)
        seq_pad[b, :npos] = seq
        mask[b, :npos] = True
        pos = 0
        post = np.full((tb, nstate), 1e-4)
        for t in range(tb):
            if t > 0 and t % 40 == 0:
                pos = min(pos + 3, npos - 1)
            elif t > 0 and rs.rand() < 0.8:
                pos = min(pos + 1, npos - 1)
            post[t, seq[pos]] = 1.0
        post /= post.sum(1, keepdims=True)
        lt[b, :tb] = np.log(post)
        lt[b, tb:] = np.log(1e-10)
        lt[b, tb:, 0] = 0.0
    zeros = np.zeros((B, P), np.float32)
    return lt, seq_pad, mask, nframes, nposs, 2.0, zeros, zeros


def _priors():
    """Geometric start and end priors on every row, at the three-row
    case's shapes."""
    rs = np.random.RandomState(23)
    nframes = np.array([300, 400, 260], np.int32)
    nposs = np.array([150, 200, 90], np.int32)
    lt, seq_pad, mask = _make_case(rs, nframes, nposs, 400, 256)
    p0 = np.zeros((3, 256), np.float32)
    p1 = np.zeros((3, 256), np.float32)
    for b, n in enumerate(nposs):
        p0[b, :n] = jutil.geometric_prior(n, 25.0)
        p1[b, :n] = jutil.geometric_prior(n, 25.0, rev=True)
    return lt, seq_pad, mask, nframes, nposs, 3.0, p0, p1


def _holes():
    """Rows whose first positions are masked out: the slip scan then meets
    prefixes of NEG_LARGE only, where the TPU scan's positions wrap in from
    the far end of the window."""
    lt, seq_pad, mask, nframes, nposs, slip, p0, p1 = _three_rows()
    mask = mask.copy()
    mask[0, :5] = False
    mask[2, :40] = False
    return lt, seq_pad, mask, nframes, nposs, slip, p0, p1


CASES = {"three_rows": _three_rows, "slips": _slips, "priors": _priors,
         "holes": _holes}
RUNS = [("three_rows", 64), ("three_rows", 128), ("slips", 64),
        ("priors", 64), ("holes", 64)]


@pytest.fixture(scope="module")
def jax_runs():
    """{(case, W): (inputs, JAX outputs)}, each JAX run made once."""
    runs = {}
    for name, W in RUNS:
        args = CASES[name]()
        out = _jax_banded(*(jnp.asarray(a) for a in args), W=W)
        runs[(name, W)] = (args, [np.asarray(o) for o in out])
    return runs


def _port_banded(args, W):
    lt, seq_pad, mask, nframes, nposs, slip, p0, p1 = args
    TB = rk.block_len(W)
    T = lt.shape[1]
    Tp = -(-T // TB) * TB
    starts = rk.band_starts_blocked(_t(nframes), _t(nposs), Tp, W, TB)
    lt_t = _t(np.moveaxis(lt, 0, 1))
    tb, vfinal = rk.remap_banded(lt_t, _t(seq_pad), _t(mask), _t(p0), starts,
                                 slip, W)
    score, path = rk.map_to_sequence_banded(
        lt_t, _t(seq_pad), slip, _t(p0), _t(p1), _t(mask), _t(nframes),
        _t(nposs), W)
    return tb, vfinal, starts, score, path


@pytest.mark.parametrize("name,W", RUNS)
def test_banded_plain_bit_identical_to_pallas(jax_runs, name, W):
    args, (j_tb, j_vfinal, j_starts, j_score, j_path) = jax_runs[(name, W)]
    tb, vfinal, starts, score, path = _port_banded(args, W)
    np.testing.assert_array_equal(starts.numpy(), j_starts)
    np.testing.assert_array_equal(tb.numpy(), j_tb)
    np.testing.assert_array_equal(vfinal.numpy(), j_vfinal)
    np.testing.assert_array_equal(score.numpy(), j_score)
    np.testing.assert_array_equal(path.numpy(), j_path)


@pytest.mark.parametrize("name,W", RUNS)
def test_backtrack_plain_matches_pallas(jax_runs, name, W):
    """Kernel 8's twin walks the JAX traceback to JAX ``_backtrack``'s
    path."""
    args, (j_tb, j_vfinal, j_starts, j_score, j_path) = jax_runs[(name, W)]
    T = args[0].shape[1]
    pscore = j_vfinal + np.take_along_axis(
        args[7], np.clip(j_starts[-1][:, None] + np.arange(W), 0,
                         args[7].shape[1] - 1), axis=1)
    last = (np.argmax(pscore, axis=1) + j_starts[-1]).astype(np.int32)
    got = rk.remap_backtrack(_t(j_tb), _t(j_starts), _t(last))
    np.testing.assert_array_equal(got.numpy()[:T].T, j_path)


def _earliest_prefix_max(y, lane, W, neg):
    """The slip scan as the CUDA kernel computes it: the running max, and
    the earliest position of equal maxima, whatever the values."""
    cmax = torch.cummax(y, dim=1).values
    rises = torch.ones_like(y, dtype=torch.bool)
    rises[:, 1:] = y[:, 1:] > cmax[:, :-1]
    return cmax, torch.cummax(torch.where(rises, lane, 0), dim=1).values


@pytest.mark.parametrize("name,W", RUNS)
def test_wrapped_slip_sources_never_win(jax_runs, monkeypatch, name, W):
    """Where every score up to a position is NEG_LARGE the TPU scan's
    position wraps in from the far end of the window (so does the slip
    source of lanes 0 and 1, and of lanes shifted past the window's end):
    such a source never wins, so the kernel's plain prefix max gives the
    same traceback."""
    args, (j_tb, j_vfinal, _, _, _) = jax_runs[(name, W)]
    monkeypatch.setattr(rk, "_slip_prefix_max", _earliest_prefix_max)
    tb, vfinal, _, _, _ = _port_banded(args, W)
    np.testing.assert_array_equal(tb.numpy(), j_tb)
    np.testing.assert_array_equal(vfinal.numpy(), j_vfinal)


def test_full_window_is_the_exact_dp():
    """W >= P: the banded twin is the exact DP on fully random posteriors
    (test_pallas_remap.py:147), against JAX's exact DP and the port's."""
    rs = np.random.RandomState(44)
    B, T, P, nstate = 3, 300, 160, 66
    nframes = np.array([300, 250, 180], np.int32)
    nposs = np.array([150, 100, 60], np.int32)
    lt = np.log(rs.dirichlet(np.ones(nstate), size=(B, T))).astype(np.float32)
    seq_pad = np.zeros((B, P), np.int32)
    mask = np.zeros((B, P), bool)
    for b in range(B):
        seq_pad[b, :nposs[b]] = rs.randint(1, nstate, size=nposs[b])
        mask[b, :nposs[b]] = True
        lt[b, nframes[b]:] = np.log(1e-10)
        lt[b, nframes[b]:, 0] = 0.0
    zeros = np.zeros((B, P), np.float32)
    s_e, p_e = remap_jax.map_to_sequence(
        jnp.asarray(lt), jnp.asarray(seq_pad), jnp.float32(2.0),
        jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(mask))
    s_x, p_x = tops.map_to_sequence(_t(lt), _t(seq_pad), 2.0, _t(zeros),
                                    _t(zeros), _t(mask))
    W = max(256, -(-P // 128) * 128)
    s_b, p_b = rk.map_to_sequence_banded(
        _t(np.moveaxis(lt, 0, 1)), _t(seq_pad), 2.0, _t(zeros), _t(zeros),
        _t(mask), _t(nframes), _t(nposs), W)
    np.testing.assert_array_equal(p_x.numpy(), np.asarray(p_e))
    np.testing.assert_array_equal(p_b.numpy(), np.asarray(p_e))
    np.testing.assert_allclose(s_x.numpy(), np.asarray(s_e), rtol=SCORE_RTOL)
    np.testing.assert_allclose(s_b.numpy(), np.asarray(s_e), rtol=SCORE_RTOL)


_jax_slip_update = jax.jit(jax.vmap(remap_jax.slip_update,
                                    in_axes=(0, None)))


def test_slip_update_matches_jax():
    """Ties, NEG_LARGE stretches and the first two entries."""
    rs = np.random.RandomState(3)
    x = np.round(rs.normal(size=(3, 70)) * 2) .astype(np.float32)
    x[1, :10] = tops.NEG_LARGE
    x[2] = 0.0
    for slip in (0.0, 3.0):
        ref = _jax_slip_update(jnp.asarray(x), jnp.float32(slip))
        got = tops.slip_update(_t(x), torch.tensor(slip))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
