"""The port's layer zoo against the JAX package's layers (CPU).

Every layer the port gained with the pickle bridge: the recurrent cells
(``Recurrent``, ``LSTM-CIFG``, ``LSTM-O``, ``forget gate``, ``SCRN``,
``MUT1``-``3``, ``Genmut``, and a GRU and an LSTM with relu, which take the
scan route), ``identity``, ``studentise``, ``normaliseL1``, ``max_pool``,
``residual``, ``decode`` and ``Reverse`` over a feed-forward layer.  Each
runs with the JAX layer's tree (numpy draws at 1/sqrt(fan-in)), carried by
``load_param_tree``.  Tolerances, at T = 23:

* outputs within 1e-5 absolute, under the mask for ragged lengths (the
  output at a masked step is unspecified in both packages);
* the gradient of a masked scalar loss with respect to every parameter of
  a recurrent cell: max|port - jax| <= 1e-4 * max|jax| (float32 sums in
  another order); a parameter no output reads (MUT3's ``W_xu``, ``b_u``,
  and the peepholes of a cell without them) gets JAX's zero;
* model JSON from each package read by the other and written back equal
  as parsed objects.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sloika_tpu.nn as jnn
from sloika_tpu import activations as jact
from sloika_tpu_torch import activations as tact
from sloika_tpu_torch import nn as tnn
from sloika_tpu_torch.nn import rnn as trnn

T, B, I, S = 23, 3, 5, 7
LENGTHS = np.array([23, 9, 15])
ATOL, GRAD_RTOL = 1e-5, 1e-4

RNNS = {
    "recurrent": lambda: jnn.Recurrent(I, S, has_bias=True),
    "lstm-cifg": lambda: jnn.LstmCIFG(I, S, has_bias=True, has_peep=True),
    "lstm-cifg-nopeep": lambda: jnn.LstmCIFG(I, S, has_bias=True),
    "lstm-o": lambda: jnn.LstmO(I, S, has_bias=True, has_peep=True),
    "forget": lambda: jnn.Forget(I, S, has_bias=True),
    "scrn": lambda: jnn.Scrn(I, 4, 3, alpha=0.9),
    "mut1": lambda: jnn.Mut1(I, S, has_bias=True),
    "mut2": lambda: jnn.Mut2(I, S, has_bias=True),
    "mut3": lambda: jnn.Mut3(I, S, has_bias=True),
    "genmut": lambda: jnn.Genmut(I, S, has_bias=True),
    "gru-relu": lambda: jnn.Gru(I, S, has_bias=True, fun=jact.relu),
    "lstm-relu": lambda: jnn.Lstm(I, S, has_bias=True, has_peep=True,
                                  fun=jact.relu),
}
OTHERS = {
    "identity": lambda: jnn.Identity(I),
    "studentise": lambda: jnn.Studentise(I),
    "normaliseL1": lambda: jnn.NormaliseL1(I),
    "max_pool": lambda: jnn.MaxPool(I, 3, 2),
    "max_pool-valid": lambda: jnn.MaxPool(I, 4, 3, padding_mode="valid"),
    "residual": lambda: jnn.Residual(jnn.FeedForward(I, I, has_bias=True)),
    "residual-rnn": lambda: jnn.Residual(jnn.Mut2(I, I, has_bias=True)),
    "decode": lambda: jnn.Decode(3),
    "reverse-feed-forward": lambda: jnn.Reverse(
        jnn.FeedForward(I, S, has_bias=True)),
}


def seeded_params(layer, seed):
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(layer.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (rs.normal(size=s.shape) / np.sqrt(s.shape[-1])).astype(
            s.dtype), shapes)


def _port_of(jlayer, params):
    port, _ = tnn.from_json(jlayer.to_json(None))
    port.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return port


def _x(F, seed=1):
    return np.random.RandomState(seed).normal(size=(T, B, F)).astype(
        np.float32)


def _mask():
    return (np.arange(T)[:, None] < LENGTHS[None, :])


def _jax_run(jlayer, params, x, lengths):
    if lengths is None:
        return np.asarray(jlayer.apply(params, jnp.asarray(x)))
    out, _ = jlayer.apply_with_lengths(params, jnp.asarray(x),
                                       jnp.asarray(lengths))
    return np.asarray(out)


def _port_run(port, x, lengths):
    with torch.no_grad():
        if lengths is None:
            return port(torch.from_numpy(x)).numpy()
        out, _ = port.apply_with_lengths(torch.from_numpy(x),
                                         torch.from_numpy(lengths))
        return out.numpy()


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", sorted(RNNS))
def test_recurrent_cell_matches_jax(name, reverse, ragged):
    jlayer = RNNS[name]()
    if reverse:
        jlayer = jnn.Reverse(jlayer)
    params = seeded_params(jlayer, 3)
    port = _port_of(jlayer, params)
    x = _x(I)
    lengths = LENGTHS if ragged else None
    got = _port_run(port, x, lengths)
    ref = _jax_run(jlayer, params, x, lengths)
    assert got.shape == ref.shape == (T, B, jlayer.size)
    m = _mask()[:, :, None] if ragged else 1.0
    assert np.max(np.abs(got - ref) * m) <= ATOL


@pytest.mark.parametrize("name", sorted(RNNS))
def test_recurrent_cell_gradients_match_jax(name):
    jlayer = RNNS[name]()
    params = seeded_params(jlayer, 4)
    port = _port_of(jlayer, params)
    x = _x(I, seed=5)
    mask = _mask()
    sel = np.random.RandomState(6).normal(
        size=(T, B, jlayer.size)).astype(np.float32) * mask[:, :, None]

    def loss(p):
        out, _ = jlayer.apply_with_lengths(p, jnp.asarray(x),
                                           jnp.asarray(LENGTHS))
        return jnp.sum(out * sel)
    gref = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params))
    out, _ = port.apply_with_lengths(torch.from_numpy(x),
                                     torch.from_numpy(LENGTHS))
    (out * torch.from_numpy(sel)).sum().backward()
    for k, p in port.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        scale = max(float(np.abs(gref[k]).max()), 1e-30)
        assert np.max(np.abs(g - gref[k])) <= GRAD_RTOL * scale, k
        if not np.any(gref[k]):
            assert not np.any(g), k


@pytest.mark.parametrize("name", sorted(OTHERS))
def test_layer_matches_jax(name):
    jlayer = OTHERS[name]()
    params = seeded_params(jlayer, 7)
    port = _port_of(jlayer, params)
    assert type(port).json_type == jlayer.json_type
    x = _x(jlayer.insize)
    got = _port_run(port, x, None)
    ref = _jax_run(jlayer, params, x, None)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= ATOL


@pytest.mark.parametrize("name", ["identity", "normaliseL1", "max_pool",
                                  "max_pool-valid", "residual",
                                  "residual-rnn"])
def test_layer_with_lengths_matches_jax(name):
    jlayer = OTHERS[name]()
    params = seeded_params(jlayer, 8)
    port = _port_of(jlayer, params)
    x = _x(jlayer.insize) * _mask()[:, :, None]
    with torch.no_grad():
        got, glen = port.apply_with_lengths(torch.from_numpy(x),
                                            torch.from_numpy(LENGTHS))
    ref, rlen = jlayer.apply_with_lengths(params, jnp.asarray(x),
                                          jnp.asarray(LENGTHS))
    assert np.array_equal(glen.numpy(), np.asarray(rlen))
    m = (np.arange(got.shape[0])[:, None] < np.asarray(rlen)[None, :])
    assert np.max(np.abs(got.numpy() - np.asarray(ref)) * m[:, :, None]) \
        <= ATOL


@pytest.mark.parametrize("name", sorted(RNNS) + sorted(OTHERS))
def test_json_round_trips_through_the_jax_package(name):
    jlayer = (RNNS if name in RNNS else OTHERS)[name]()
    params = seeded_params(jlayer, 9)
    jjson = json.loads(json.dumps(jlayer.to_json(params)))
    port, ptree = tnn.from_json(jjson)
    pjson = json.loads(json.dumps(port.to_json(True)))
    assert pjson == jjson
    back, bparams = jnn.from_json(pjson)
    assert json.loads(json.dumps(back.to_json(bparams))) == jjson
    # structure alone, without parameters
    assert port.to_json(False) == json.loads(json.dumps(
        jlayer.to_json(None)))


@pytest.mark.parametrize("name", sorted(RNNS) + sorted(OTHERS))
def test_jax_checkpoint_loads_in_the_port(name, tmp_path):
    """``serialize.load_checkpoint`` reads the JAX package's ``.npz`` of
    each layer: the same tree, leaf for leaf."""
    from sloika_tpu import serialize as jser
    from sloika_tpu_torch import serialize as tser
    from sloika_tpu_torch.nn.core import tree_items
    jlayer = (RNNS if name in RNNS else OTHERS)[name]()
    params = seeded_params(jlayer, 10)
    path = str(tmp_path / "m.npz")
    jser.save_checkpoint(path, jlayer, params)
    port, tree, _ = tser.load_checkpoint(path)
    want = {k: np.asarray(v) for k, v in tree_items(
        jax.tree_util.tree_map(np.asarray, params))}
    got = dict(tree_items(port.param_tree()))
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_studentise_refuses_lengths_as_jax_does():
    port = tnn.Studentise(I)
    with pytest.raises(NotImplementedError, match="Studentise"):
        port.apply_with_lengths(torch.zeros(T, B, I),
                                torch.from_numpy(LENGTHS))


def test_reverse_over_a_feed_forward_refuses_lengths():
    port = tnn.Reverse(tnn.FeedForward(I, S))
    with pytest.raises(NotImplementedError, match="RNN sublayers"):
        port.apply_with_lengths(torch.zeros(T, B, I),
                                torch.from_numpy(LENGTHS))
    # and applies flip, layer, flip without them
    x = torch.from_numpy(_x(I))
    with torch.no_grad():
        assert torch.equal(port(x), port.layer(x.flip(0)).flip(0))


def test_max_pool_pads_with_zeros():
    """Padded positions compete as 0.0: on an all-negative input the edge
    windows that reach into the padding give 0 (F.max_pool1d's own
    padding would give the negative values)."""
    x = -1.0 - np.random.RandomState(2).uniform(size=(7, 2, 3)).astype(
        np.float32)
    jlayer = jnn.MaxPool(3, 3, 2)
    got = _port_run(_port_of(jlayer, {}), x, None)
    ref = _jax_run(jlayer, {}, x, None)
    assert np.array_equal(got, ref)
    assert np.all(got[0] == 0.0) and np.all(got[-1] == 0.0)
    assert np.all(got[1:-1] < 0.0)


@pytest.mark.parametrize("cls", [tnn.Gru, tnn.Lstm])
def test_non_tanh_cells_take_the_scan_route(cls):
    """A GRU or LSTM with relu runs the eager scan (counted in
    ``scan_route``); the tanh/sigmoid cell the kernels' route."""
    kernel, scan = cls(I, S), cls(I, S, fun=tact.relu)
    x = torch.from_numpy(_x(I))
    before = trnn.scan_route.calls
    with torch.no_grad():
        kernel(x)
    assert trnn.scan_route.calls == before
    with torch.no_grad():
        scan(x, reverse=True)
    assert trnn.scan_route.calls == before + 1


def test_scan_route_matches_the_kernel_route_on_the_cpu():
    """The tanh/sigmoid GRU through the scan equals it through the
    kernels' plain twin."""
    gru = tnn.Gru(I, S, init=tnn.truncated_normal(
        0.5, np.random.RandomState(3)), has_bias=True)
    x = torch.from_numpy(_x(I))
    mask = torch.from_numpy(_mask())
    with torch.no_grad():
        a = gru(x, reverse=True, mask=mask)
        b = gru.scan(x, reverse=True, mask=mask)
    m = mask[:, :, None]
    assert float(((a - b).abs() * m).max()) <= ATOL


def test_train_step_gives_unread_parameters_jaxs_zero_gradient():
    """MUT3's ``W_xu`` and ``b_u`` and an LSTM-CIFG's peepholes without
    ``has_peep`` feed no output: the training step gives them a zero
    gradient, as ``jax.grad`` does, and the optimiser leaves them."""
    from sloika_tpu_torch import optim, training
    init = tnn.truncated_normal(0.5, np.random.RandomState(4))
    layer = tnn.Serial([tnn.Mut3(I, S, init=init, has_bias=True),
                        tnn.LstmCIFG(S, S, init=init, has_bias=True),
                        tnn.Softmax(S, 4, init=init)])
    unread = [layer.layers[0].W_xu, layer.layers[0].b_u, layer.layers[1].p]
    before = [p.detach().clone() for p in unread]
    opt_init, opt_update = optim.adamski()
    step = training.make_train_step(layer, opt_update)
    x = torch.from_numpy(_x(I))
    labels = torch.from_numpy(np.random.RandomState(2).randint(
        0, 4, size=(T, B)))
    step(opt_init(layer), x, labels, torch.ones(T, B), 1e-2)
    for p, b in zip(unread, before):
        assert p.grad is not None and not torch.any(p.grad)
        assert torch.equal(p.detach(), b)
    assert torch.any(layer.layers[0].W_xz.grad)
