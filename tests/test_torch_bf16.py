"""The port's bfloat16 compute dtype against the JAX package's (CPU).

``SLOIKA_TPU_COMPUTE_DTYPE=bfloat16`` sets both packages' compute dtype when
they are imported.  Here the tests set it for one test at a time: the
``bf16`` fixture patches ``sloika_tpu.nn.core.compute_dtype`` and
``sloika_tpu.config.compute_dtype`` (the JAX package's copies) and the
port's ``config.compute_dtype``, and pytest restores all three.  The
variable itself is never set in this process: subprocess tests would
inherit it (tests/test_bench_accuracy.py).

Under bfloat16 the JAX package rounds the operands of ``affine`` to
bfloat16 and keeps a float32 product; its convolution and its fused (Pallas)
recurrences stay float32; its ``Basecaller`` with the Pallas Viterbi streams
the posterior in bfloat16, cast after the floor and the pad-frame mask, and
the kernel upcasts each row to float32 before the log.  The stand-in models
here run the JAX GRU and LSTM fused (``fused=True``, interpret mode): the
JAX package's XLA scan, its CPU default, would send the recurrent product
through ``affine`` too and round it to bfloat16, which neither the TPU nor
the port does.  Weights are numpy-made and large (sd 3 / sqrt(fan-in)), so
the posteriors are peaked and the decoded calls are free of near-ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sloika_tpu.config as jconfig
import sloika_tpu.nn as jnn
import sloika_tpu.nn.core as jcore
from sloika_tpu import basecall as jbc
from sloika_tpu.ops.pallas import viterbi as pallas_viterbi
from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch import config
from sloika_tpu_torch import nn as tnn
from sloika_tpu_torch import serialize as tser
from sloika_tpu_torch.ops import decode
from sloika_tpu_torch.ops import viterbi_kernel as vk

KLEN = 3
#: one input shape for every JAX forward of this file: B reads of T samples
T, B = 1500, 2
LENGTHS = np.array([T, 1100])


@pytest.fixture
def bf16(monkeypatch):
    monkeypatch.setattr(jcore, "compute_dtype", jnp.bfloat16)
    monkeypatch.setattr(jconfig, "compute_dtype", jnp.bfloat16)
    monkeypatch.setattr(config, "compute_dtype", torch.bfloat16)


@pytest.fixture(scope="module")
def model():
    """(JAX layer, its params, the port's layer): convolution of stride 5,
    a reversed GRU, a peephole LSTM and a softmax over the 65 states of
    k = 3, both recurrences fused."""
    layer = jnn.Serial([
        jnn.Convolution(1, 8, 11, 5, has_bias=True),
        jnn.Reverse(jnn.Gru(8, 12, has_bias=True, fused=True)),
        jnn.Lstm(12, 10, has_bias=True, has_peep=True, fused=True),
        jnn.Softmax(10, 4 ** KLEN + 1, has_bias=True),
    ])
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda a: (3.0 * rs.normal(size=a.shape)
                   / np.sqrt(a.shape[-1])).astype(a.dtype),
        jax.eval_shape(layer.init, jax.random.PRNGKey(0)))
    port, _ = tser.load_model_json(layer.to_json(None))
    port = tser.params_from_numpy(
        port, jax.tree_util.tree_map(np.asarray, params))
    return layer, params, port


def _signal(seed=3):
    rs = np.random.RandomState(seed)
    return rs.normal(size=(T, B, 1)).astype(np.float32)


def _rounds_to_bf16(a):
    a = np.asarray(a, np.float32)
    return np.array_equal(a, a.astype(jnp.bfloat16).astype(np.float32))


# -- affine ---------------------------------------------------------------

@pytest.mark.parametrize("xshape,nout", [((4, 5, 7), 3), ((30, 8, 96), 64),
                                         ((600, 12), 65)])
def test_affine_bf16_equals_jax(bf16, xshape, nout):
    """Forward and both gradients of ``affine`` under bfloat16 against JAX's
    ``dot_general(preferred_element_type=float32)``: the product of the
    rounded operands is float32 (never bfloat16), within float32 summation
    order of JAX's (|d| <= 1e-6 max|y|); the gradients are rounded to
    bfloat16 on both sides (JAX transposes the casts), within one bfloat16
    ulp of the largest (a float32 sum that lands on either side of a
    rounding boundary); the bias's within float32 summation order."""
    rs = np.random.RandomState(len(xshape) + nout)
    x = rs.normal(size=xshape).astype(np.float32)
    W = rs.normal(size=(nout, xshape[-1])).astype(np.float32)
    b = rs.normal(size=(nout,)).astype(np.float32)
    g = rs.normal(size=xshape[:-1] + (nout,)).astype(np.float32)
    y_ref, vjp = jax.vjp(jcore.affine, jnp.asarray(x), jnp.asarray(W),
                         jnp.asarray(b))
    dx_ref, dW_ref, db_ref = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    xt, Wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, W, b))
    y = tnn.affine(xt, Wt, bt)
    assert y.dtype == torch.float32
    y.backward(torch.from_numpy(g))
    y_ref = np.asarray(y_ref)
    assert np.abs(y.detach().numpy() - y_ref).max() <= 1e-6 * np.abs(
        y_ref).max()
    for got, ref in ((xt.grad.numpy(), dx_ref), (Wt.grad.numpy(), dW_ref)):
        assert _rounds_to_bf16(got) and _rounds_to_bf16(ref)
        assert np.abs(got - ref).max() <= 2 ** -8 * np.abs(ref).max()
    assert np.abs(bt.grad.numpy() - db_ref).max() <= 1e-6 * np.abs(
        db_ref).max()


def test_affine_bf16_rounds_the_operands_only(bf16):
    """The bfloat16 product is the float32 product of the rounded operands,
    bit for bit (each term is exact in float32), and its input is left
    alone; float32 mode is ``x @ W.T`` as before."""
    rs = np.random.RandomState(8)
    x = torch.from_numpy(rs.normal(size=(9, 4, 33)).astype(np.float32))
    W = torch.from_numpy(rs.normal(size=(17, 33)).astype(np.float32))
    x0 = x.clone()
    y = tnn.affine(x, W)
    assert y.dtype == torch.float32 and torch.equal(x, x0)
    assert torch.equal(y, x.bfloat16().float() @ W.bfloat16().float().t())
    assert not torch.equal(y, x @ W.t())
    config.compute_dtype = torch.float32
    assert torch.equal(tnn.affine(x, W), x @ W.t())


def test_compute_dtype_defaults_to_float32():
    # the variable is unset in the test process
    assert config.compute_dtype == torch.float32
    caller = tbc.Basecaller(tnn.Softmax(4, 4 ** KLEN + 1), KLEN,
                            device="cpu")
    assert caller.post_dtype == torch.float32


# -- what stays float32 ----------------------------------------------------

def test_convolution_stays_float32(bf16, model):
    """The convolution reads no compute dtype in either package
    (``sloika_tpu/ops/conv.py:57-64``): under bfloat16 the port's equals
    its float32 self bit for bit, and JAX's within float32 round-off."""
    layer, params, port = model
    x = _signal()
    conv = port.layers[0]
    with torch.no_grad():
        y = conv(torch.from_numpy(x))
        config.compute_dtype = torch.float32
        y32 = conv(torch.from_numpy(x))
    assert y.dtype == torch.float32 and torch.equal(y, y32)
    ref = np.asarray(layer.layers[0].apply(params["sublayers"][0],
                                           jnp.asarray(x)))
    assert np.abs(y.numpy() - ref).max() <= 1e-5


@pytest.mark.parametrize("index", [1, 2])
def test_recurrences_stay_float32(bf16, model, monkeypatch, index):
    """Under bfloat16 only a recurrent layer's input projection changes:
    the recurrence (kernel on the card, its plain twin here) run on the
    bfloat16 projection gives the bits it gives in float32 mode; and the
    layer agrees with JAX's fused (Pallas, float32 HIGHEST) layer within
    float32 round-off."""
    layer, params, port = model
    rs = np.random.RandomState(index)
    x = rs.normal(size=(60, B, port.layers[index].insize)).astype(np.float32)
    rnn = port.layers[index]
    inner = getattr(rnn, "layer", rnn)
    with torch.no_grad():
        y = rnn(torch.from_numpy(x))
        xp = inner.input_proj(torch.from_numpy(x))
        assert xp.dtype == torch.float32
        config.compute_dtype = torch.float32
        monkeypatch.setattr(inner, "input_proj", lambda _: xp)
        y32 = rnn(torch.from_numpy(x))
    assert y.dtype == torch.float32 and torch.equal(y, y32)
    config.compute_dtype = torch.bfloat16
    ref = np.asarray(layer.layers[index].apply(
        params["sublayers"][index], jnp.asarray(x)))
    assert np.abs(y.numpy() - ref).max() <= 1e-5


# -- the stand-in's posterior ---------------------------------------------

def _callers(model):
    layer, params, port = model
    jax_caller = jbc.Basecaller(layer, params, KLEN, batch_size=B,
                                viterbi_impl="pallas",
                                post_dtype="bfloat16")
    return jax_caller, tbc.Basecaller(port, KLEN, batch_size=B,
                                      device="cpu")


def test_standin_posterior_bf16_against_jax(bf16, model):
    """The posterior that reaches the Viterbi, under bfloat16 in both
    packages: bfloat16 on both sides, and the stand-in's softmax before the
    floor within 2e-3 of JAX's (the recurrences agree to float32 round-off,
    which may move an operand of the next ``affine`` across a bfloat16
    rounding boundary: one bfloat16 ulp of an activation of magnitude <= 1
    times a row of weights); at least 99% of the streamed values are the
    same bits, the rest one bfloat16 ulp apart (at most 2^-7 of the
    value)."""
    layer, params, port = model
    jax_caller, caller = _callers(model)
    assert caller.post_dtype == torch.bfloat16
    x = _signal()
    ref, ref_len = jax_caller._floored_masked_post(
        params, jnp.asarray(x), jnp.asarray(LENGTHS))
    with torch.inference_mode():
        got, got_len = caller._floored_masked_post(
            torch.from_numpy(x), torch.from_numpy(LENGTHS))
        soft = port.apply_with_lengths(torch.from_numpy(x),
                                       torch.from_numpy(LENGTHS))[0]
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    soft_ref = np.asarray(layer.apply_with_lengths(
        params, jnp.asarray(x), jnp.asarray(LENGTHS))[0])
    frames = int(LENGTHS.max()) // 5
    assert np.abs(soft.numpy() - soft_ref)[:frames].max() <= 2e-3
    g = got.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    assert (g == r).mean() >= 0.99
    assert np.all(np.abs(g - r) <= 2 ** -7 * np.maximum(np.abs(g),
                                                        np.abs(r)))


def test_floored_masked_post_casts_after_the_floor_and_mask(bf16, model):
    """The bfloat16 posterior is the float32 one (floor, then one-hot stays
    on padded frames) rounded to bfloat16, bit for bit: the order of the
    JAX package's ``_floored_masked_post``."""
    _, _, port = model
    caller = tbc.Basecaller(port, KLEN, device="cpu")
    f32 = tbc.Basecaller(port, KLEN, device="cpu", post_dtype="float32")
    x, lengths = torch.from_numpy(_signal(7)), torch.from_numpy(LENGTHS)
    with torch.inference_mode():
        got, _ = caller._floored_masked_post(x, lengths)
        ref, out_len = f32._floored_masked_post(x, lengths)
    assert ref.dtype == torch.float32 and got.dtype == torch.bfloat16
    assert torch.equal(got, ref.to(torch.bfloat16))
    # a padded frame is an exact one-hot stay
    pad = got[int(out_len[1]):, 1].float()
    assert len(pad) and torch.all(pad[:, 0] == 1) and torch.all(
        pad[:, 1:] == 0)


@pytest.mark.parametrize("post_dtype,want", [
    ("auto", torch.bfloat16), ("float32", torch.float32),
    ("bfloat16", torch.bfloat16)])
def test_post_dtype_follows_the_compute_dtype(bf16, post_dtype, want):
    caller = tbc.Basecaller(tnn.Softmax(4, 4 ** KLEN + 1), KLEN,
                            device="cpu", post_dtype=post_dtype)
    assert caller.post_dtype == want


def test_post_dtype_rejects_other_dtypes():
    with pytest.raises(KeyError):
        tbc.Basecaller(tnn.Softmax(4, 4 ** KLEN + 1), KLEN, device="cpu",
                       post_dtype="float16")


def test_basecall_bf16_equals_jax(bf16, model):
    """Whole reads through both ``Basecaller``s under bfloat16 (JAX's Pallas
    Viterbi in interpret mode, streaming bfloat16): the same calls, scores
    within 1e-4 relative (the posteriors differ by a bfloat16 ulp here and
    there, and the two frameworks' float32 ``log`` by an ulp).  Then, given
    JAX's own bfloat16 posterior, the port's decode gives the Pallas
    kernel's states bit for bit."""
    jax_caller, caller = _callers(model)
    rs = np.random.RandomState(11)
    sigs = [rs.normal(size=n).astype(np.float32) for n in (T, 1100, 700)]
    ref = jax_caller.basecall_signals(sigs)
    got = caller.basecall_signals(sigs)
    for (s1, c1), (s2, c2) in zip(got, ref):
        assert s1 == pytest.approx(s2, rel=1e-4)
        np.testing.assert_array_equal(c1, c2)
        assert len(c1) > 10
    post, _ = jax_caller._floored_masked_post(
        model[1], jnp.asarray(_signal()), jnp.asarray(LENGTHS))
    score_ref, path_ref, moved_ref = jax_caller._make_viterbi_fn()(post)
    score, path, moved = vk.viterbi(
        torch.from_numpy(np.array(post.astype(jnp.float32))).to(
            torch.bfloat16), KLEN, skip_pen=caller.skip)
    np.testing.assert_array_equal(path.numpy(), np.asarray(path_ref))
    np.testing.assert_array_equal(moved.numpy(), np.asarray(moved_ref))
    np.testing.assert_allclose(score.numpy(), np.asarray(score_ref),
                               rtol=1e-6)


# -- the Viterbi on a bfloat16 posterior -----------------------------------

def _bf16_posterior(kind, log, seed):
    """(T, B, 4^k + 1) bfloat16 numbers as float32 numpy: Dirichlet(0.05)
    probabilities, or their logs, each rounded to bfloat16."""
    rs = np.random.RandomState(seed)
    post = rs.dirichlet(np.full(4 ** KLEN + 1, 0.05),
                        size=(40, 3)).astype(np.float32)
    if kind == "ties":
        post = (np.round(post * 8) / 8 + 1e-3).astype(np.float32)
    if log:
        post = np.log(post + np.float32(1e-10))
    return np.array(jnp.asarray(post).astype(jnp.bfloat16).astype(
        jnp.float32))


def _pallas_forward(post16, layout, take_log):
    """JAX's Pallas forward on a bfloat16 (T, B, K+1) array, either
    layout; (vfinal (B, K), codes (T, B, K))."""
    if layout == "lanes":
        v, tb = pallas_viterbi.viterbi_forward(
            post16, KLEN, skip_pen=5.0, time_major=True, take_log=take_log)
        return np.asarray(v), np.asarray(tb)
    v, tb = pallas_viterbi.viterbi_forward_sm(
        jnp.transpose(post16, (0, 2, 1)), KLEN, skip_pen=5.0,
        take_log=take_log)
    return np.asarray(v).T, np.transpose(np.asarray(tb), (0, 2, 1))


@pytest.mark.parametrize("layout", ["lanes", "sublanes"])
@pytest.mark.parametrize("kind", ["peaked", "ties"])
def test_plain_viterbi_bf16_bit_equal_to_pallas(layout, kind):
    """``viterbi_forward_plain`` on a bfloat16 log-posterior against the
    Pallas kernel on the same bfloat16 array (its ``_row`` upcast, no log):
    final scores and codes bit for bit, in both layouts."""
    lp = _bf16_posterior(kind, log=True, seed=len(layout))
    v, tb = decode.viterbi_forward_plain(
        torch.from_numpy(lp).to(torch.bfloat16), KLEN, skip_pen=5.0,
        log=True)
    v_ref, tb_ref = _pallas_forward(jnp.asarray(lp).astype(jnp.bfloat16),
                                    layout, take_log=False)
    assert v.dtype == torch.float32
    np.testing.assert_array_equal(v.numpy(), v_ref)
    np.testing.assert_array_equal(tb.numpy(), tb_ref[:len(tb)])


@pytest.mark.parametrize("layout", ["lanes", "sublanes"])
def test_viterbi_forward_bf16_probabilities_against_pallas(layout):
    """The forward entry point on bfloat16 probabilities (the Basecaller's
    stream; each side takes the log of the upcast row): the Pallas kernel's
    codes bit for bit, final scores within 1e-6 relative (the two
    frameworks' float32 ``log`` differ in the last ulp on 65 of the 16,256
    positive bfloat16 values up to 1)."""
    post = _bf16_posterior("peaked", log=False, seed=2)
    v, tb = vk.viterbi_forward(torch.from_numpy(post).to(torch.bfloat16),
                               KLEN, skip_pen=5.0)
    v_ref, tb_ref = _pallas_forward(jnp.asarray(post).astype(jnp.bfloat16),
                                    layout, take_log=True)
    np.testing.assert_array_equal(tb.numpy(), tb_ref[:len(tb)])
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=1e-6)


@pytest.mark.parametrize("log", [False, True])
def test_plain_viterbi_upcasts_each_row(log):
    """A bfloat16 posterior gives the bits of its float32 upcast."""
    post = torch.from_numpy(_bf16_posterior("ties", log, seed=5))
    got = decode.viterbi(post.to(torch.bfloat16), KLEN, skip_pen=5.0,
                         log=log)
    ref = decode.viterbi(post, KLEN, skip_pen=5.0, log=log)
    assert got[0].dtype == torch.float32
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


# -- the plans in bytes ----------------------------------------------------

@pytest.mark.parametrize("pairs", [None, 0])
@pytest.mark.parametrize("B", (1, 8, 64, 133, 1024))
@pytest.mark.parametrize("K", (16, 256, 1024, 4096))
def test_viterbi_fwd_plan_bf16_fits(K, B, pairs):
    """A bfloat16 row's slot is its 16-byte-aligned superset, 2 (K+1) + 14
    bytes rounded up to 16: about half a float32 slot.  The ring is as
    deep as before or deeper, and the plan fits the SM."""
    plan = vk.viterbi_fwd_plan(B, K, pairs=pairs, esize=2)
    f32 = vk.viterbi_fwd_plan(B, K, pairs=pairs)
    assert plan["row_bytes"] % 16 == 0
    assert 2 * (K + 1) + 14 <= plan["row_bytes"] < 2 * (K + 1) + 30
    assert plan["route"] == f32["route"] and plan["dpt"] == f32["dpt"]
    assert plan["threads"] == f32["threads"]
    assert plan["smem"] <= vk.SMEM_OPTIN
    if plan["route"] == "pair":
        assert plan["smem"] >= (vk.FWD_PAIR_BAR_BYTES + 8 * K + plan["G"]
                                * (plan["nslots"] * 4 * (K + 4)
                                   + vk.FWD_PAIR_POST_SLOTS
                                   * plan["row_bytes"]))
        assert plan["G"] * plan["nslots"] >= f32["G"] * f32["nslots"]
        return
    assert plan["nslots"] >= f32["nslots"]
    assert plan["blocks"] >= f32["blocks"]
    assert plan["smem"] == (vk.FWD_BAR_BYTES + plan["nslots"]
                            * plan["row_bytes"] + 8 * K)
    assert plan["blocks"] * (plan["smem"] + vk.BLOCK_RESERVED) <= vk.SM_SMEM


def test_viterbi_plans_bf16_at_the_decode_paths_shapes():
    # the float32 plans are those of the default element size
    assert vk.viterbi_fwd_plan(64, 1024, esize=4) == vk.viterbi_fwd_plan(
        64, 1024)
    plan = vk.viterbi_fwd_plan(64, 1024, esize=2)
    assert (plan["route"], plan["G"], plan["nslots"],
            plan["row_bytes"]) == ("pair", 8, 4, 2064)
    # bench.py's batch: 8 blocks an SM, 9 one-frame slots where float32
    # holds 4
    plan = vk.viterbi_fwd_plan(1024, 1024, esize=2)
    assert (plan["dpt"], plan["blocks"], plan["nslots"]) == (8, 8, 9)
    with pytest.raises(ValueError):
        vk.viterbi_fwd_plan(8, 1024, esize=8)


@pytest.mark.parametrize("B", (1, 8, 1024))
@pytest.mark.parametrize("nbase,klen", [(3, 4), (4, 7), (4, 8), (5, 6)])
def test_viterbi_general_plan_bf16_fits(nbase, klen, B):
    """The general route's slot at bfloat16: the stay's 16-byte unit and
    the aligned superset of a block's KC kmers of 2 bytes; the plan fits,
    and a cluster size that fits at float32 fits at bfloat16 (where no
    size runs every row in one wave, the smallest that fits is taken, so
    bfloat16 may take a smaller one)."""
    K = nbase ** klen
    plan = vk.viterbi_general_plan(B, K, nbase, esize=2)
    f32 = vk.viterbi_general_plan(B, K, nbase)
    KC = K // plan["C"]
    assert plan["slot_bytes"] % 16 == 0
    assert 16 + 2 * KC + 14 <= plan["slot_bytes"] < 16 + 2 * KC + 30
    assert plan["smem"] <= vk.SMEM_OPTIN
    assert plan["shared"] >= f32["shared"]
    assert set(vk.general_cluster_shapes(K, nbase)) <= set(
        vk.general_cluster_shapes(K, nbase, esize=2))
    if plan["shared"]:
        assert plan["smem"] >= (vk.FWD_BAR_BYTES
                                + plan["nslots"] * plan["slot_bytes"])
