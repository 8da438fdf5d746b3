"""The port's event-domain layers and ``baseline_lstm`` against the JAX
package (CPU), and interchange of their checkpoints and model JSON.

Weights are drawn with numpy at each parameter's 1/sqrt(fan-in) scale in
the JAX package's tree and carried to the port with ``load_param_tree``.
Tolerances: outputs within 1e-5 absolute (under the mask for
variable-length batches, whose padded positions are unspecified);
checkpoints and model JSON written back bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sloika_tpu.nn as jnn
from sloika_tpu import activations as jact
from sloika_tpu import optim as joptim
from sloika_tpu import serialize as jser
from sloika_tpu.models import network_factory as jfactory
from sloika_tpu_torch import models as tmodels
from sloika_tpu_torch import nn as tnn
from sloika_tpu_torch import serialize as tser

KLEN, SIZE = 3, 16
ATOL = 1e-5


def seeded_params(layer, seed, sd=0.5):
    """A parameter tree of the JAX ``layer``'s structure drawn with numpy
    at each leaf's 1/sqrt(fan-in) scale (shapes from tracing ``init``)."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(layer.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (sd * rs.normal(size=s.shape)
                   / np.sqrt(s.shape[-1])).astype(s.dtype), shapes)


def _x(T, B, F, seed=1):
    return np.random.RandomState(seed).normal(size=(T, B, F)).astype(
        np.float32)


def _port_of(jlayer, params):
    """The port's layer from the JAX layer's JSON, holding ``params``."""
    port, _ = tnn.from_json(jlayer.to_json(None))
    port.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return port


def _lstm(i, s, fused=None):
    return jnn.Lstm(i, s, has_bias=True, has_peep=True, fused=fused)


@pytest.mark.parametrize("name", ["window", "feed-forward", "birnn",
                                  "lstm-fused"])
def test_layer_matches_jax(name):
    jlayer = {"window": lambda: jnn.Window(4, 3),
              "feed-forward": lambda: jnn.FeedForward(6, 5, has_bias=True,
                                                      fun=jact.tanh),
              "birnn": lambda: jnn.birnn(_lstm(6, 8), _lstm(6, 8)),
              "lstm-fused": lambda: _lstm(6, 8, fused=True)}[name]()
    params = seeded_params(jlayer, 3)
    x = _x(13, 3, jlayer.insize)
    lengths = np.array([13, 5, 9])
    port = _port_of(jlayer, params)
    assert type(port).json_type == jlayer.json_type
    with torch.no_grad():
        got, glen = port.apply_with_lengths(torch.from_numpy(x),
                                            torch.from_numpy(lengths))
    ref, rlen = jlayer.apply_with_lengths(params, jnp.asarray(x),
                                          jnp.asarray(lengths))
    assert got.shape == ref.shape and np.array_equal(glen, rlen)
    m = (np.arange(13)[:, None] < lengths[None, :])[:, :, None]
    assert np.max(np.abs(got.numpy() - np.asarray(ref)) * m) <= ATOL
    if name == "window":
        with torch.no_grad():
            full = port(torch.from_numpy(x)).numpy()
        assert np.array_equal(full, np.asarray(jlayer.apply(params, x)))


def test_lstm_init_and_json_follow_jax():
    """The forget bias +2.0 on gate 2; ``peep`` in the JSON; without it the
    peepholes are a zero parameter that stays in the tree."""
    init = tnn.truncated_normal(0.5, np.random.RandomState(0))
    layer = tnn.Lstm(6, 8, init=init, has_bias=True, has_peep=False)
    b = layer.b.detach().numpy()
    assert np.all(b[2] > 0.9) and np.all(np.abs(b[[0, 1, 3]]) <= 1.0)
    assert not layer.p.detach().numpy().any()
    assert sorted(layer.param_tree()) == ["b", "iW", "p", "sW"]
    jl = jnn.Lstm(6, 8, has_bias=True, has_peep=False)
    assert layer.to_json() == jl.to_json(None)


@pytest.fixture(scope="module")
def baseline():
    """(JAX baseline_lstm at size 16 and klen 3, numpy-drawn params)"""
    layer = jfactory("baseline_lstm")(klen=KLEN, sd=0.5, size=SIZE)
    return layer, seeded_params(layer, 5)


def test_baseline_lstm_posterior_matches_jax(baseline):
    jlayer, params = baseline
    port = tmodels.network_factory("baseline_lstm")(klen=KLEN, sd=0.5,
                                                    size=SIZE)
    port.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    assert port.to_json() == jlayer.to_json(None)
    T, lengths = 37, np.array([37, 20, 3, 31])
    x = _x(T, 4, 4, seed=6)
    for b, n in enumerate(lengths):
        x[n:, b] = 0.0              # tail padding, as the basecaller pads
    with torch.no_grad():
        got, _ = port.apply_with_lengths(torch.from_numpy(x),
                                         torch.from_numpy(lengths))
    ref, _ = jlayer.apply_with_lengths(params, jnp.asarray(x),
                                       jnp.asarray(lengths))
    m = (np.arange(T)[:, None] < lengths[None, :])[:, :, None]
    assert got.shape == (T, 4, 4 ** KLEN + 1)
    assert np.max(np.abs(got.numpy() - np.asarray(ref)) * m) <= ATOL


def test_checkpoint_and_json_round_trip_jax_port_jax(baseline, tmp_path):
    jlayer, params = baseline
    params = jax.tree_util.tree_map(jnp.asarray, params)
    init, update = joptim.adamski()
    state = init(params)
    grads = jax.tree_util.tree_map(lambda p: 0.1 * p + 0.01, params)
    params, state = update(grads, state, params, jnp.float32(1e-3))
    first, back = str(tmp_path / "j.npz"), str(tmp_path / "back.npz")
    jser.save_checkpoint(first, jlayer, params, state)
    port, _, tstate = tser.load_checkpoint(first)
    tser.save_checkpoint(back, port, tstate)
    _, params2, state2 = jser.load_checkpoint(back)
    for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                    jax.tree_util.tree_leaves((params2, state2))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # model JSON with parameters: the same description and float values
    # back (JAX orders a tree's dict keys as it was last rebuilt, so the
    # comparison is of the parsed objects, not the bytes)
    j1, j2 = str(tmp_path / "j.json"), str(tmp_path / "back.json")
    jser.save_model_json(j1, jlayer, params)
    layer, tree = tser.load_model_json(j1)
    assert tree is not None
    tser.save_model_json(j2, layer)
    with open(j1) as f1, open(j2) as f2:
        assert json.load(f1) == json.load(f2)
