"""The port's Theano-pickle bridge against the JAX package's (CPU).

Pickles are written in the reference's layout by ``chip_smoke.py``'s
writer (``write_reference_pickle``: ``sloika.layers.*`` classes,
parameters in the storage of Theano shared-variable stubs in the
reference's flat layouts, ``sloika.activation.*`` globals, protocol 2,
numpy's reconstruction under ``numpy.core``) from port layers with numpy
weights, and the same bytes go to both loaders.  Trees must be equal
exactly (the conversions are reshapes and permutations); forwards within
1e-5 absolute.  The layouts themselves are held by stubs built by hand:
the LSTM interleave, LSTM-O's block layout, SCRN's alpha and the flags.
The unpickler's own guards (numpy's two module paths, refused globals)
are held in ``tests/test_torch_zoo_card.py``, which needs no jax.
"""
import io
import json
import warnings

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from sloika_tpu.compat import theano_pickle as jtp
from sloika_tpu_torch import activations as tact
from sloika_tpu_torch import models as tmodels
from sloika_tpu_torch import nn as tnn
from sloika_tpu_torch.compat import theano_pickle as tp
from sloika_tpu_torch.nn.core import tree_items

T, B, F, S = 19, 2, 4, 6
ATOL = 1e-5


def _seeded(layer, seed=3, sd=1.0):
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy((sd * rs.normal(size=tuple(p.shape))
                                      / np.sqrt(p.shape[-1])).astype(
                np.float32)))
    return layer


LAYERS = {
    "Convolution": lambda: tnn.Convolution(F, S, 3, stride=2,
                                           has_bias=True, fun=tact.elu),
    "Softmax": lambda: tnn.Softmax(F, S, has_bias=True),
    "SoftmaxTheano": lambda: tnn.SoftmaxTheano(F, S),
    "FeedForward": lambda: tnn.FeedForward(F, S, has_bias=True,
                                           fun=tact.retu),
    "Gru": lambda: tnn.Gru(F, S, has_bias=True),
    "Gru-relu": lambda: tnn.Gru(F, S, has_bias=True, fun=tact.relu),
    "Recurrent": lambda: tnn.Recurrent(F, S, has_bias=True,
                                       fun=tact.softplus),
    "Lstm": lambda: tnn.Lstm(F, S, has_bias=True, has_peep=True),
    "LstmCIFG": lambda: tnn.LstmCIFG(F, S, has_bias=True, has_peep=True),
    "LstmO": lambda: tnn.LstmO(F, S, has_bias=True, has_peep=True),
    "Window": lambda: tnn.Window(F, 3),
    "Identity": lambda: tnn.Identity(F),
    "Studentise": lambda: tnn.Studentise(F),
    "NormaliseL1": lambda: tnn.NormaliseL1(F),
    "MaxPool": lambda: tnn.MaxPool(F, 3, 2),
    "Scrn": lambda: tnn.Scrn(F, 4, 2, alpha=0.75),
    "Forget": lambda: tnn.Forget(F, S, has_bias=True),
    "Mut1": lambda: tnn.Mut1(F, S, has_bias=True),
    "Mut2": lambda: tnn.Mut2(F, S, has_bias=True),
    "Mut3": lambda: tnn.Mut3(F, S, has_bias=True),
    "Genmut": lambda: tnn.Genmut(F, S, has_bias=True),
    "Serial": lambda: tnn.Serial([tnn.Window(F, 3),
                                  tnn.FeedForward(3 * F, S)]),
    "Parallel": lambda: tnn.Parallel([tnn.Gru(F, S), tnn.Identity(F)]),
    "Reverse": lambda: tnn.Reverse(tnn.Lstm(F, S, has_peep=True)),
    "Residual": lambda: tnn.Residual(tnn.FeedForward(F, F)),
}


def _x(seed=1):
    return np.random.RandomState(seed).normal(size=(T, B, F)).astype(
        np.float32)


def _jax_load(blob):
    # numpy 2 warns on the reference's numpy.core path in the JAX loader
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return jtp.convert(jtp.load_raw(blob))


def _port_load(blob):
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        return tp.convert(tp.load_raw(blob))


def _flat(tree):
    return {k: np.asarray(v) for k, v in tree_items(
        jax.tree_util.tree_map(np.asarray, tree))}


def _same_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    return sorted(fa) == sorted(fb) and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k])
        for k in fa)


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_same_bytes_give_the_jax_tree_and_forward(kind):
    layer = _seeded(LAYERS[kind]())
    blob = cs.write_reference_pickle(layer)
    port, ptree = _port_load(blob)
    jlayer, jparams = _jax_load(blob)
    assert type(port).json_type == jlayer.json_type
    assert _same_trees(ptree, jparams)
    assert _same_trees(port.param_tree(), jparams)
    assert json.loads(json.dumps(port.to_json(True))) == \
        json.loads(json.dumps(jlayer.to_json(jparams)))
    x = _x()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        mine = layer(torch.from_numpy(x)).numpy()
    ref = np.asarray(jlayer.apply(jparams, x))
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= ATOL
    # the pickle carries the layer itself (Scrn's alpha through float32)
    assert np.max(np.abs(got - mine)) <= ATOL


def test_headline_graph_pickle_against_the_jax_conversion():
    """The stand-in's graph at full width (conv 1->128 stride 5, three
    GRUs, softmax over 1,025 states): the same tree as JAX's conversion,
    weights bit-identical to the stand-in's, forwards within 1e-5."""
    standin = tmodels.pretrained_standin(seed=2)
    blob = cs.write_reference_pickle(standin)
    port, ptree = _port_load(blob)
    jlayer, jparams = _jax_load(blob)
    assert _same_trees(ptree, jparams)
    assert all(torch.equal(a, b) for a, b in zip(standin.parameters(),
                                                 port.parameters()))
    x = np.random.RandomState(4).normal(size=(60, 2, 1)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    ref = np.asarray(jlayer.apply(jparams, x))
    assert np.max(np.abs(got - ref)) <= ATOL
    np.testing.assert_allclose(got.sum(axis=2), 1.0, rtol=1e-5)


def _stub(kind, **state):
    return cs.ref_object("sloika.layers", kind, **state)


def _dump(obj):
    buf = io.BytesIO()
    cs.RefPickler(buf).dump(obj)
    return buf.getvalue()


def _lstm_stub(kind, flat_iW, flat_sW, flat_b, p, **flags):
    return _stub(kind, iW=cs.ref_shared(flat_iW), sW=cs.ref_shared(flat_sW),
                 b=cs.ref_shared(flat_b), p=cs.ref_shared(p),
                 fun=cs.RefGlobal("sloika.activation", "tanh"),
                 gatefun=cs.RefGlobal("sloika.activation", "sigmoid"),
                 **flags)


@pytest.mark.parametrize("kind,G", [("Lstm", 4), ("LstmCIFG", 3),
                                    ("LstmO", 3)])
def test_lstm_gate_layouts(kind, G):
    """Lstm and LSTM-CIFG store row G*u + g for (unit u, gate g), the
    reference's interleaved in-step reshape; LSTM-O stores the gates
    block-wise.  Both loaders give the gate-major truth."""
    rs = np.random.RandomState(4)
    iW = rs.normal(size=(G, S, F)).astype(np.float32)
    sW = rs.normal(size=(G, S, S)).astype(np.float32)
    b = rs.normal(size=(G, S)).astype(np.float32)
    p = rs.normal(size=(3 if kind != "LstmCIFG" else 2, S)).astype(
        np.float32)
    if kind == "LstmO":
        src = np.arange(G * S)
    else:
        idx = np.arange(G * S)
        src = (idx % G) * S + idx // G       # flat row -> gate-major row
    blob = _dump(_lstm_stub(kind, iW.reshape(G * S, F)[src],
                            sW.reshape(G * S, S)[src], b.reshape(-1)[src], p,
                            has_bias=True, has_peep=True))
    port, ptree = _port_load(blob)
    _, jparams = _jax_load(blob)
    truth = {"iW": iW, "sW": sW, "b": b, "p": p}
    assert _same_trees(ptree, truth) and _same_trees(jparams, truth)
    assert type(port).__name__ == kind


def test_scrn_alpha_comes_from_the_decay_matrix():
    rs = np.random.RandomState(5)
    mats = {"isW": (2, F), "sfW": (4, 2), "ifW": (4, F), "ffW": (4, 4)}
    st = {k: cs.ref_shared(rs.normal(size=s)) for k, s in mats.items()}
    blob = _dump(_stub("Scrn", ssW=cs.ref_shared(0.7 * np.eye(2)), **st))
    port, _ = _port_load(blob)
    jlayer, _ = _jax_load(blob)
    assert port.alpha == jlayer.alpha == float(np.float32(0.7))
    assert (port.fast_size, port.slow_size) == (4, 2)
    assert port.fun is tact.sigmoid


@pytest.mark.parametrize("attr", [True, None])
def test_flag_reads_the_attribute_before_the_values(attr):
    """A fresh pickle's zero peepholes still say has_peep where the layer
    carries the attribute; without it the values decide, as in JAX."""
    G = 4
    flags = {} if attr is None else {"has_peep": True, "has_bias": False}
    blob = _dump(_lstm_stub("Lstm", np.ones((G * S, F)),
                            np.ones((G * S, S)), np.zeros(G * S),
                            np.zeros((3, S)), **flags))
    port, _ = _port_load(blob)
    jlayer, _ = _jax_load(blob)
    assert port.has_peep == jlayer.has_peep == (attr is True)
    assert port.has_bias == jlayer.has_bias is False


def test_unknown_layer_type_is_refused():
    blob = b"\x80\x02csloika.layers\nFrobnicate\nq\x00)\x81q\x01}q\x02b."
    with pytest.raises(NotImplementedError, match="Frobnicate"):
        tp.convert(tp.load_raw(blob))
    with pytest.raises(NotImplementedError, match="Frobnicate"):
        jtp.convert(jtp.load_raw(blob))
