"""The port's event training path against the JAX package (CPU):
``baseline_lstm`` (size 16, klen 3: 65 states) on chunks of event
features, labelled at every event (stride 1).

The JAX model's parameters are drawn with numpy at each leaf's
1/sqrt(fan-in) scale and carried to the port with ``load_param_tree``.
Tolerances:

* the loss and gradients that ``make_train_step`` differentiates
  (B = 4, T = 40): loss rtol 1e-5, max|port - jax| <= 1e-5 * max|jax| per
  parameter (float32 through four LSTMs, summed in another order);
* three iterations of ``train()`` in each package from the same weights
  and sampler seed: per-iteration loss rtol 1e-5, final parameters atol
  1e-5 (1% of one 1e-3 ADAMski step);
* the ``events`` train CLI, then the validate CLI, run on the CPU and the
  port's validation agrees with the JAX package's (loss rtol 1e-5).
"""
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sloika_tpu import serialize as jser
from sloika_tpu import training as jtraining
from sloika_tpu.models import network_factory as jfactory
from sloika_tpu.variables import nstate
from sloika_tpu_torch import models as tmodels
from sloika_tpu_torch import serialize as tser
from sloika_tpu_torch import training as ttraining
from sloika_tpu_torch.nn.core import tree_items

KLEN, SIZE = 3, 16


def _seeded_params(layer, seed):
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(layer.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (0.5 * rs.normal(size=s.shape)
                   / np.sqrt(s.shape[-1])).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def jax_model():
    layer = jfactory("baseline_lstm")(klen=KLEN, sd=0.5, size=SIZE)
    return layer, _seeded_params(layer, 4)


def _port(params):
    port = tmodels.network_factory("baseline_lstm")(klen=KLEN, sd=0.5,
                                                    size=SIZE)
    port.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return port


def event_chunks(nchunk=16, chunk_len=40, seed=0):
    """Studentised-looking event features with a label at every event."""
    rs = np.random.RandomState(seed)
    chunks = rs.normal(size=(nchunk, chunk_len, 4)).astype(np.float32)
    labels = rs.randint(0, nstate(KLEN),
                        size=(nchunk, chunk_len)).astype(np.int32)
    bad = np.zeros(labels.shape, dtype=bool)
    bad[0, 3] = True
    return {"chunks": chunks, "labels": labels, "bad": bad,
            "weights": np.ones(nchunk) / nchunk, "attrs": {"kmer": KLEN}}


def test_loss_and_gradients_match_jax(jax_model):
    layer, params = jax_model
    port = _port(params)
    rs = np.random.RandomState(5)
    T, B, drop = 40, 4, 3
    x = rs.normal(size=(T, B, 4)).astype(np.float32)
    labels = rs.randint(0, nstate(KLEN), size=(T, B)).astype(np.int32)
    weights = rs.uniform(0.5, 2.0, size=labels.shape).astype(np.float32)
    loss_fn = jtraining.make_loss_fn(layer, min_prob=1e-30, drop=drop)
    (jloss, jacc), jgrad = jax.jit(jax.value_and_grad(loss_fn,
                                                      has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(labels), jnp.asarray(weights))
    loss, acc = ttraining.make_loss_fn(port, min_prob=1e-30, drop=drop)(
        torch.from_numpy(x), torch.from_numpy(labels).long(),
        torch.from_numpy(weights))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert float(acc) == pytest.approx(float(jacc), abs=1e-7)
    got = [(k, p.grad.numpy()) for k, p in tree_items(port.param_tensors())]
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                           jgrad))
    assert len(got) == len(ref) == 22     # 4 LSTMs x 4, 2 x 2, softmax 2
    for (k, g), r in zip(got, ref):
        assert np.max(np.abs(g - r)) <= 1e-5 * np.max(np.abs(r)), k


TRAIN = dict(batch_size=4, niteration=3, drop=2, seed=5, quiet=True,
             chunk_len_range=(1.0, 1.0))


def test_three_train_iterations_match_jax(jax_model, monkeypatch):
    layer, params = jax_model
    data = event_chunks()
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
    # fresh arrays: the JAX train step donates its inputs
    jparams, jstate = jtraining.train(
        layer, jax.tree_util.tree_map(jnp.asarray, params), data, **TRAIN)
    port = _port(params)
    tstate, history = ttraining.train(port, data, device="cpu", **TRAIN)
    np.testing.assert_allclose(history[:, 0], losses, rtol=1e-5)
    for (_, a), b in zip(tree_items(port.param_tree()),
                         jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    assert float(tstate.count) == float(jstate.count) == 3.0


def test_cli_train_events_then_validate(tmp_path):
    from sloika_tpu.data.hdf5 import create_labelled_chunks_hdf5
    from sloika_tpu_torch.cli import train as tcli_train
    from sloika_tpu_torch.cli import validate as tcli_validate
    from sloika_tpu_torch.data import hdf5 as thdf5
    data = event_chunks(nchunk=10, chunk_len=100, seed=3)
    h5 = str(tmp_path / "events.hdf5")
    create_labelled_chunks_hdf5(h5, 0.5, {"kmer": KLEN}, [data["chunks"]],
                                [data["labels"]], [data["bad"]])
    out = str(tmp_path / "run")
    assert tcli_train.main(["events", "baseline_lstm", out, h5, "--device",
                            "cpu", "--niteration", "2", "--batch_size", "4",
                            "--seed", "3", "--quiet"]) == 0
    final = os.path.join(out, "model_final.npz")
    tlayer, _, state = tser.load_checkpoint(final)
    assert float(state.count) == 2.0
    assert tlayer.to_json()["sublayers"][0] == {"type": "window", "w": 3,
                                                "insize": 4}
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli_validate.main([final, h5, "--device", "cpu",
                                   "--batch_size", "4"]) == 0
    assert buf.getvalue().splitlines()[-1].startswith("loss ")
    chunks = thdf5.load_labelled_chunks(h5)
    jlayer, jparams, _ = jser.load_checkpoint(final)
    jl, _ = jtraining.validate(jlayer, jparams, chunks, batch_size=4)
    tl, _ = ttraining.validate(tlayer, chunks, batch_size=4, device="cpu")
    assert tl == pytest.approx(jl, rel=1e-5)
