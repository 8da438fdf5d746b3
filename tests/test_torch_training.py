"""The port's training path against the JAX package's (CPU).

A small raw_0.98_rgrgr (elu convolution 1->16 stride 5, five alternating
GRUs of 16, softmax over klen 3's 65 states) is built and initialised in
JAX and carried to the port with ``params_from_numpy``.  Tolerances:

* loss and gradients of the whole loss: rtol 1e-5 on the loss, and
  max|port - jax| <= 1e-4 * max|jax| per parameter (float32 through five
  recurrent layers, summed in another order);
* optimiser steps on the same gradients: atol 1e-7 (the same float32
  formulas; XLA may contract a multiply-add into one rounding);
* three iterations of ``train()`` in each package, resumed from one port
  checkpoint with one seed: per-iteration loss rtol 1e-5, final parameters
  atol 1e-5 (1% of one 1e-3 ADAMski step);
* checkpoints: bit-exact.
"""
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sloika_tpu.nn as jnn
from sloika_tpu import activations as jact
from sloika_tpu import optim as joptim
from sloika_tpu import serialize as jser
from sloika_tpu import training as jtraining
from sloika_tpu.models import build as jbuild
from sloika_tpu.variables import nstate
from sloika_tpu_torch import models as tmodels
from sloika_tpu_torch import optim as toptim
from sloika_tpu_torch import serialize as tser
from sloika_tpu_torch import training as ttraining
from sloika_tpu_torch.nn.core import tree_items

KLEN = 3
WIDTH = 16
SD = 0.5


def _jax_rgrgr(n=WIDTH, klen=KLEN):
    """The JAX raw_0.98_rgrgr graph at width n (the JAX file fixes 96)."""
    init = jnn.truncated_normal(SD)

    def gru():
        return jnn.Gru(n, n, init=init, has_bias=True, fun=jact.tanh)

    return jnn.Serial([
        jnn.Convolution(1, n, 11, 5, init=init, has_bias=True,
                        fun=jact.elu),
        jnn.Reverse(gru()), gru(), jnn.Reverse(gru()), gru(),
        jnn.Reverse(gru()),
        jnn.Softmax(n, nstate(klen), init=init, has_bias=True),
    ])


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _seeded_params(layer, seed):
    """A parameter tree of ``layer``'s structure, drawn with numpy (the
    shapes from tracing ``init``; compiling it would cost seconds)."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(layer.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (SD * rs.normal(size=s.shape)
                   / np.sqrt(s.shape[-1])).astype(s.dtype), shapes)


def _leaves(tree):
    return [np.asarray(v) for _, v in tree_items(tree)]


@pytest.fixture(scope="module")
def jax_model():
    layer = _jax_rgrgr()
    return layer, _seeded_params(layer, 3)


@pytest.fixture
def models(jax_model):
    """(JAX layer, JAX params, the port's model holding the same weights)"""
    layer, params = jax_model
    # fresh device arrays: the JAX train step donates its inputs
    params = jax.tree_util.tree_map(jnp.asarray, params)
    port = tmodels.network_factory("raw_0.98_rgrgr")(klen=KLEN, sd=SD,
                                                     size=WIDTH)
    tser.params_from_numpy(port, _numpy(params))
    return layer, params, port


def _data(nchunk=24, chunk_len=200, stride=5, seed=0):
    rs = np.random.RandomState(seed)
    chunks = rs.normal(size=(nchunk, chunk_len, 1)).astype(np.float32)
    labels = rs.randint(0, nstate(KLEN),
                        size=(nchunk, chunk_len // stride)).astype(np.int32)
    bad = np.zeros(labels.shape, dtype=bool)
    bad[0, 3] = True
    weights = np.ones(nchunk) / nchunk
    return {"chunks": chunks, "labels": labels, "bad": bad,
            "weights": weights, "attrs": {"kmer": KLEN}}


def test_port_model_takes_the_jax_model_weights():
    """The port's raw_0.98_rgrgr has the JAX file's graph and widths: a
    full-width tree of the JAX model's structure loads into it and survives
    unchanged."""
    layer = jbuild("raw_0.98_rgrgr", klen=5, sd=SD, stride=5)
    params = _seeded_params(layer, 0)
    port = tmodels.network_factory("raw_0_98_rgrgr")(klen=5, sd=SD)
    tser.params_from_numpy(port, params)
    assert all(np.array_equal(a, b) for a, b in zip(
        _leaves(port.param_tree()), jax.tree_util.tree_leaves(params)))
    assert port.to_json()["sublayers"][0]["activation"] == "elu"


@pytest.mark.parametrize("min_prob,l2", [(1e-30, 0.0), (0.1, 1e-3)])
def test_loss_and_gradients_match_jax(models, min_prob, l2):
    layer, params, port = models
    rs = np.random.RandomState(5)
    T, B, drop = 200, 3, 3
    x = rs.normal(size=(T, B, 1)).astype(np.float32)
    labels = rs.randint(0, nstate(KLEN), size=(T // 5, B)).astype(np.int32)
    weights = rs.uniform(0.5, 2.0, size=labels.shape).astype(np.float32)
    weights[5, 1] = 0.0
    loss_fn = jtraining.make_loss_fn(layer, min_prob=min_prob, l2=l2,
                                     drop=drop)
    (jloss, jacc), jgrad = jax.jit(jax.value_and_grad(loss_fn,
                                                      has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(weights))
    loss, acc = ttraining.make_loss_fn(port, min_prob=min_prob, l2=l2,
                                       drop=drop)(
        torch.from_numpy(x), torch.from_numpy(labels).long(),
        torch.from_numpy(weights))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert float(acc) == pytest.approx(float(jacc), abs=1e-7)
    got = [p.grad.numpy() for _, p in tree_items(port.param_tensors())]
    for g, ref in zip(got, jax.tree_util.tree_leaves(_numpy(jgrad))):
        assert np.max(np.abs(g - ref)) <= 1e-4 * np.max(np.abs(ref))


@pytest.mark.parametrize("name", ["adamski", "adam", "sgd"])
def test_optimiser_steps_match_jax(models, name):
    _, params, port = models
    jopt = {"adamski": joptim.adamski(), "adam": joptim.adam(),
            "sgd": joptim.sgd(0.9)}[name]
    topt = {"adamski": toptim.adamski(), "adam": toptim.adam(),
            "sgd": toptim.sgd(0.9)}[name]
    jstate, tstate = jopt[0](params), topt[0](port)
    rs = np.random.RandomState(8)
    for i, lr in enumerate((1e-3, 5e-4, 2e-3)):
        grads = jax.tree_util.tree_map(
            lambda p: (rs.normal(size=p.shape) * 3).astype(np.float32),
            _numpy(params))
        for (_, p), g in zip(tree_items(port.param_tensors()),
                             jax.tree_util.tree_leaves(grads)):
            p.grad = torch.from_numpy(g)
        params, jstate = jopt[1](grads, jstate, params, jnp.float32(lr))
        tstate = topt[1](port, tstate, lr)
    for a, b in zip(_leaves(port.param_tree()),
                    jax.tree_util.tree_leaves(_numpy(params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    if name == "sgd":
        pairs = [(tstate.vel, jstate.vel)]
    else:
        assert float(tstate.count) == float(jstate.count) == 3.0
        pairs = [(tstate.mu, jstate.mu), (tstate.nu, jstate.nu)]
    for t, j in pairs:
        for a, b in zip(_leaves(t), jax.tree_util.tree_leaves(_numpy(j))):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


def _jax_train_losses(monkeypatch, layer, params, data, **kw):
    """JAX ``train`` with its per-iteration losses recorded."""
    losses = []
    make = jtraining.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(*args):
            out = step(*args)
            losses.append(float(out[2]))
            return out
        return run

    monkeypatch.setattr(jtraining, "make_train_step", recording)
    params, opt_state = jtraining.train(layer, params, data, **kw)
    return params, opt_state, losses


TRAIN = dict(batch_size=8, niteration=3, drop=2, seed=5, quiet=True,
             n_length_buckets=2)


@pytest.fixture(scope="module")
def resumed_runs(jax_model, tmp_path_factory):
    """Three iterations of the port's ``train()`` from the JAX weights,
    saved with their optimiser state; then three more in each package from
    that checkpoint, with the same seed and data."""
    layer, params = jax_model
    port = tmodels.network_factory("raw_0.98_rgrgr")(klen=KLEN, sd=SD,
                                                     size=WIDTH)
    tser.params_from_numpy(port, params)
    tmp = tmp_path_factory.mktemp("train")
    data = _data()
    ttraining.train(port, data, output=str(tmp / "start"), device="cpu",
                    **TRAIN)
    start = str(tmp / "start" / "model_final.npz")
    jlayer, jparams, jstate = jser.load_checkpoint(start)
    assert float(jstate.count) == 3.0
    with pytest.MonkeyPatch.context() as mp:
        jparams, jstate, jlosses = _jax_train_losses(
            mp, jlayer, jparams, data, opt_state=jstate,
            output=str(tmp / "jax"), **TRAIN)
    tlayer, _, tstate = tser.load_checkpoint(start)
    tstate, history = ttraining.train(tlayer, data, opt_state=tstate,
                                      output=str(tmp / "port"), device="cpu",
                                      **TRAIN)
    return {"tmp": tmp, "data": data, "jparams": _numpy(jparams),
            "jstate": jstate, "jlosses": jlosses, "port": tlayer,
            "tstate": tstate, "history": history}


def test_three_train_iterations_match_jax(resumed_runs):
    run = resumed_runs
    np.testing.assert_allclose(run["history"][:, 0], run["jlosses"],
                               rtol=1e-5)
    for a, b in zip(_leaves(run["port"].param_tree()),
                    jax.tree_util.tree_leaves(run["jparams"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert float(run["tstate"].count) == float(run["jstate"].count) == 6.0
    # the same log lines and checkpoint files
    tmp = run["tmp"]
    for d in ("jax", "port"):
        assert sorted(os.listdir(tmp / d)) == sorted([
            "model.log", "model_checkpoint_00000.npz",
            "model_checkpoint_00000.npz.json", "model_final.npz",
            "model_final.npz.json"])
    head = lambda d: open(tmp / d / "model.log").read().splitlines()[:3]
    assert head("jax") == head("port")


@pytest.mark.parametrize("kind", ["adamski", "sgd"])
def test_checkpoint_round_trip_jax_port_jax_is_bit_exact(models, tmp_path,
                                                         kind):
    layer, params, _ = models
    init, update = joptim.adamski() if kind == "adamski" else joptim.sgd(0.9)
    state = init(params)
    grads = jax.tree_util.tree_map(lambda p: 0.1 * p + 0.01, params)
    params, state = update(grads, state, params, jnp.float32(1e-3))
    first, back = str(tmp_path / "j.npz"), str(tmp_path / "back.npz")
    jser.save_checkpoint(first, layer, params, state)
    port, _, tstate = tser.load_checkpoint(first)
    assert isinstance(tstate, toptim.SGDState if kind == "sgd"
                      else toptim.OptState)
    tser.save_checkpoint(back, port, tstate)
    _, params2, state2 = jser.load_checkpoint(back)
    assert type(state2) is type(state)
    for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                    jax.tree_util.tree_leaves((params2, state2))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_training_resumes_across_packages(resumed_runs):
    """A port checkpoint resumes in ``sloika_tpu.training.train`` (the
    shared runs) and a JAX checkpoint in the port's ``train``; the step
    count carries on."""
    tlayer, _, tstate = tser.load_checkpoint(
        str(resumed_runs["tmp"] / "jax" / "model_final.npz"))
    assert float(tstate.count) == 6.0
    tstate, history = ttraining.train(tlayer, resumed_runs["data"],
                                      opt_state=tstate, device="cpu",
                                      **TRAIN)
    assert float(tstate.count) == 9.0
    assert np.isfinite(history).all()


def test_cli_train_then_validate(tmp_path):
    from sloika_tpu.data.hdf5 import create_labelled_chunks_hdf5
    from sloika_tpu_torch.cli import train as tcli_train
    from sloika_tpu_torch.cli import validate as tcli_validate
    from sloika_tpu_torch.data import hdf5 as thdf5
    rs = np.random.RandomState(4)
    h5 = str(tmp_path / "chunks.hdf5")
    chunks = rs.normal(size=(12, 200, 1)).astype(np.float32)
    labels = rs.randint(1, nstate(KLEN), size=(12, 40)).astype(np.int32)
    create_labelled_chunks_hdf5(h5, 0.5, {"kmer": KLEN}, [chunks], [labels],
                                [np.zeros((12, 40), bool)])
    out = str(tmp_path / "run")
    assert tcli_train.main(["raw", "raw_0.98_rgrgr", out, h5, "--device",
                            "cpu", "--niteration", "3", "--batch_size", "4",
                            "--drop", "2", "--save_every", "2", "--seed",
                            "3", "--quiet"]) == 0
    assert os.path.exists(os.path.join(out, "model_checkpoint_00001.npz"))
    final = os.path.join(out, "model_final.npz")
    # resume with the optimiser state
    again = str(tmp_path / "again")
    assert tcli_train.main(["raw", final, again, h5, "--device", "cpu",
                            "--niteration", "1", "--batch_size", "4",
                            "--drop", "2", "--quiet"]) == 0
    assert float(tser.load_checkpoint(os.path.join(
        again, "model_final.npz"))[2].count) == 4.0
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli_validate.main([final, h5, "--device", "cpu",
                                   "--batch_size", "5"]) == 0
    assert buf.getvalue().splitlines()[-1].startswith("loss ")
    # the port's validate agrees with the JAX package's on the checkpoint
    data = thdf5.load_labelled_chunks(h5)
    jlayer, jparams, _ = jser.load_checkpoint(final)
    tlayer, _, _ = tser.load_checkpoint(final)
    jl, ja = jtraining.validate(jlayer, jparams, data, batch_size=5)
    tl, ta = ttraining.validate(tlayer, data, batch_size=5, device="cpu")
    assert tl == pytest.approx(jl, rel=1e-5)
    assert ta == pytest.approx(ja, abs=1e-6)
