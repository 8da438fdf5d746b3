"""Training K optimiser steps a group: the CUDA graph of a group against
the eager steps, and the pieces its replays are made of.

This file imports no jax, so the ``gpu``-marked tests run on a machine with
a CUDA card and without jax::

    python -m pytest tests/test_torch_train_graph.py -m gpu --noconftest -q

On a machine without a card they skip.  The CPU tests hold the resident
gather to the host sampler's batches and the optimisers' split update
(host step sizes, applied as 0-d tensors) to their one-call update, bit for
bit.
"""
import numpy as np
import pytest
import torch

from sloika_tpu_torch import models, optim, training
from sloika_tpu_torch.variables import nstate

KLEN = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _data(nchunk, chunk_len, nfeature, stride, seed=0):
    rs = np.random.RandomState(seed)
    chunks = rs.normal(size=(nchunk, chunk_len, nfeature)).astype(np.float32)
    labels = rs.randint(0, nstate(KLEN), size=(nchunk, chunk_len // stride)
                        ).astype(np.int32)
    return {"chunks": chunks, "labels": labels,
            "bad": np.zeros(labels.shape, bool),
            "weights": np.ones(nchunk) / nchunk, "attrs": {"kmer": KLEN}}


def test_resident_gather_is_the_samplers_batch():
    """:func:`gather_batch` on the resident set gives the elements
    ``ChunkSampler.materialise`` copies, for every draw."""
    data = _data(30, 120, 1, 5)
    lw = training.label_frequency_weights(data["labels"], data["weights"],
                                          True)
    sampler = training.ChunkSampler(data, 6, 60, 60, 5, lw, seed=3)
    resident = (torch.from_numpy(data["chunks"]),
                torch.from_numpy(data["labels"].astype(np.int64)),
                torch.from_numpy(lw))
    for _ in range(5):
        idx, start, chunk_len = sampler.sample_indices()
        x, labels, weights = sampler.materialise(idx, start, chunk_len)
        got = training.gather_batch(*resident, torch.from_numpy(idx),
                                    torch.tensor(start), chunk_len, 5)
        for g, r in zip(got, (x, labels, weights)):
            assert np.array_equal(g.numpy(), r)


@pytest.mark.parametrize("name", ["adamski", "sgd"])
def test_split_update_is_the_update(name):
    """``update.apply`` fed its host step sizes as 0-d tensors gives the
    bits of ``update`` (Python floats); ``_group_scalars`` of K steps gives
    each step's values and the state after them."""
    init, update = (optim.adamski() if name == "adamski"
                    else optim.sgd(0.9))
    layers = [models.network_factory("tiny_gru")(klen=KLEN, sd=0.5, size=4)
              for _ in range(2)]
    states = [init(layer) for layer in layers]
    rs = np.random.RandomState(0)
    lrs = [1e-3, 9e-4, 8.5e-4]
    scal, after = training._group_scalars(update, states[1], lrs)
    assert scal.shape == ((2 if name == "adamski" else 1), 3)
    for j, lr in enumerate(lrs):
        for a, b in zip(layers[0].parameters(), layers[1].parameters()):
            g = torch.from_numpy(rs.normal(size=a.shape).astype(np.float32))
            a.grad, b.grad = g.clone(), g.clone()
        states[0] = update(layers[0], states[0], lr)
        update.apply(layers[1], states[1],
                     *(torch.tensor(v[j]) for v in scal))
        for a, b in zip(layers[0].parameters(), layers[1].parameters()):
            assert torch.equal(a, b)
    if name == "adamski":
        assert float(after.count) == float(states[0].count) == 3.0
    for a, b in zip(optim.state_tensors(states[0]),
                    optim.state_tensors(states[1])):
        assert torch.equal(a, b)


#: the GPU cases: a tiny raw GRU model (convolution of stride 5, five GRUs
#: of 16) and a tiny event LSTM model (baseline_lstm of 16 over 4 features)
CASES = {"gru": ("raw_0.98_rgrgr", 1, 5, 200),
         "lstm": ("baseline_lstm", 4, 1, 60)}


def _train(name, dev, **kw):
    model, nfeature, stride, chunk_len = CASES[name]
    layer = models.network_factory(model)(klen=KLEN, sd=0.5, size=16,
                                          nfeature=nfeature, stride=stride)
    data = _data(40, chunk_len, nfeature, stride)
    stats = {}
    state, history = training.train(
        layer, data, batch_size=8, chunk_len_range=(1.0, 1.0), drop=2,
        niteration=10, seed=5, quiet=True, stats=stats, device=dev, **kw)
    torch.cuda.synchronize()
    return layer, state, history, stats


@pytest.mark.gpu
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_of_4_steps_is_the_eager_steps(cuda_device, monkeypatch, name,
                                             resident):
    """Two replays of a graph of 4 steps and a tail of 2 single steps give
    the eager loop's parameters, optimiser state and losses, bit for bit
    (cuDNN's deterministic algorithms: its convolution weight gradient may
    otherwise sum with atomics, in another order on every call)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    graph = _train(name, cuda_device, steps_per_dispatch=4,
                   data_on_device=resident)
    eager = _train(name, cuda_device)
    assert graph[3]["replays"] == 2 and eager[3]["replays"] == 0
    assert graph[3]["resident"] == resident
    assert np.array_equal(graph[2], eager[2])
    for a, b in zip(graph[0].parameters(), eager[0].parameters()):
        assert torch.equal(a, b)
    for a, b in zip(optim.state_tensors(graph[1]),
                    optim.state_tensors(eager[1])):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_replays_count_their_captured_launches(cuda_device, name):
    """A replay adds the launches captured into the graph: a run of 8
    steps in groups of 4 counts the warm-up group's launches and two
    replays', 12 steps' worth, where the eager loop counts 8."""
    wrappers = training.kernel_wrappers()
    kernels = (("gru_fwd", "gru_bwd", "gru_wgrad") if name == "gru" else
               ("lstm_fwd", "lstm_bwd", "lstm_wgrad"))
    model, nfeature, stride, chunk_len = CASES[name]

    def counted(**kw):
        for w in wrappers:
            w.launches = 0
        layer = models.network_factory(model)(klen=KLEN, sd=0.5, size=16,
                                              nfeature=nfeature,
                                              stride=stride)
        stats = {}
        training.train(layer, _data(40, chunk_len, nfeature, stride),
                       batch_size=8, chunk_len_range=(1.0, 1.0), drop=2,
                       niteration=8, seed=5, quiet=True, stats=stats,
                       device=cuda_device, **kw)
        torch.cuda.synchronize()
        return [w.launches for w in wrappers], stats

    graph, stats = counted(steps_per_dispatch=4)
    eager, _ = counted()
    assert stats["replays"] == 2
    captured = {w: n for (w, c), n in stats["captured"].items()
                if c == "launches"}
    assert sum(captured.values()) > 0
    for w, g, e in zip(wrappers, graph, eager):
        assert 2 * g == 3 * e
        assert g == 3 * captured.get(w, 0)
    used = {type(w).__name__ for w in captured}
    assert len(used) == len(kernels)


@pytest.mark.gpu
def test_the_learning_rate_is_not_frozen_into_the_graph(cuda_device,
                                                        monkeypatch):
    """The graph is captured at the first group, whose 4 iterations run at
    lr 0 (``lr_warmup``); the second group's rates reach the update
    through the device scalars, so its replay moves the parameters as the
    eager loop does.  Had the capture frozen the first group's rate, the
    parameters would not move."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model, nfeature, stride, chunk_len = CASES["gru"]
    data = _data(40, chunk_len, nfeature, stride)
    runs = []
    for K in (4, 1):
        layer = models.network_factory(model)(klen=KLEN, sd=0.5, size=16,
                                              nfeature=nfeature,
                                              stride=stride)
        start = [p.detach().clone() for p in layer.parameters()]
        training.train(layer, data, batch_size=8, chunk_len_range=(1.0, 1.0),
                       drop=2, seed=5, quiet=True, niteration=8,
                       lr_warmup=4, steps_per_dispatch=K, optimiser="sgd",
                       adam=(1e-3, 0.0, 0.999), device=cuda_device)
        runs.append(list(layer.parameters()))
    assert any(not torch.equal(a, b.cpu()) for a, b in zip(start, runs[0]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
