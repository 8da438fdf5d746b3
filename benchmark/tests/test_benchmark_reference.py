"""The plain reference against the program's plain twins at tiny sizes on
the CPU: the network, the Viterbi, the base emission, the training step
and the sampler's draws."""
import numpy as np
import pytest
import torch

from benchmark.harness import generators, port, spec
from benchmark.reference import model, train, viterbi

#: the training cell's weights: sloika's initialiser at sd 0.5
SCHEME = {"sd": 0.5, "bias_sd": 0.5, "softmax_gain": 1.0,
          "stay_logit": None}


def _config(name):
    return spec.load_json("{}/benchmark/configs/{}.json".format(
        spec.ROOT, name))


@pytest.mark.parametrize("name", ["sloika_pretrained", "raw_0.98_rgrgr"])
def test_benchmark_reference_network_equals_the_programs(name):
    cfg = _config(name)
    cpu = torch.device("cpu")
    params = generators.weights(cfg["layers"], SCHEME, 2 ** 31 + 3,
                                cpu)
    layer = port.load_weights(port.network(cfg), params)
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.normal(size=(120, 3, 1)).astype(np.float32))
    lengths = torch.tensor([120, 77, 31])
    with torch.no_grad():
        want, wn = layer.apply_with_lengths(x, lengths)
        got, gn = model.posterior(cfg["layers"], params, x, lengths)
    assert torch.equal(wn, gn)
    for b, n in enumerate(gn.tolist()):
        torch.testing.assert_close(got[:n, b], want[:n, b], rtol=1e-5,
                                   atol=1e-6)


def test_benchmark_reference_viterbi_equals_the_programs():
    from sloika_tpu_torch.ops import decode
    rs = np.random.RandomState(2)
    post = torch.softmax(torch.from_numpy(
        3.0 * rs.normal(size=(40, 3, 1025)).astype(np.float32)), dim=2)
    post = viterbi.floor(post, 1e-5, torch.tensor([40, 33, 12]))
    score, path, moved = viterbi.viterbi(post, 5, 5.0)
    s2, p2, m2 = decode.viterbi(post, 5, skip_pen=5.0)
    np.testing.assert_allclose(score, s2.double().numpy(), rtol=1e-6)
    assert np.array_equal(path, p2.numpy())
    assert np.array_equal(moved, m2.numpy())


def test_benchmark_reference_bases_equal_the_programs_records():
    from sloika_tpu_torch import basecall
    rs = np.random.RandomState(3)
    T, k = 50, 5
    path = np.empty(T, np.int64)
    path[0] = rs.randint(1024)
    moved = np.zeros(T, bool)
    for t in range(1, T):
        kind = rs.randint(3)            # stay, step, skip
        moved[t] = kind > 0
        path[t] = path[t - 1] if kind == 0 else (
            (path[t - 1] * 4 ** kind + rs.randint(4 ** kind)) % 1024)
    first, counts, packed = basecall._move_records(
        torch.from_numpy(path[None]), torch.from_numpy(moved[None]), k,
        (10, 40))
    recs = basecall._unpack_codes(packed.numpy())[0]
    lead = (int(first[0]) >> (2 * np.arange(k - 1, -1, -1))) & 3
    c = counts[0].numpy()
    want = np.concatenate([lead, recs[:c[2]]])
    assert np.array_equal(viterbi.window_bases(path, moved, k, 0, T, True),
                          want)
    assert np.array_equal(viterbi.window_bases(path, moved, k, 10, 40,
                                               False), recs[c[0]:c[1]])


def test_benchmark_reference_sampler_draws_equal_the_programs():
    from sloika_tpu_torch import training
    n, L = 30, 200
    w = np.full(n, 1.0 / n)
    data = {"chunks": np.zeros((n, L, 1), np.float32),
            "labels": np.zeros((n, L // 5), np.int32), "weights": w}
    s = training.ChunkSampler(data, 8, L, L, 5, np.ones(3, np.float32),
                              seed=77)
    want = [s.sample_indices() for _ in range(3)]
    got = train.sampler_draws(n, w, 8, L, L, 5, 77, 3)
    for (gi, gs), (wi, ws, wl) in zip(got, want):
        assert np.array_equal(gi, wi) and gs == ws and wl == L


def test_benchmark_reference_training_step_equals_the_programs():
    from sloika_tpu_torch import training
    cfg = _config("raw_0.98_rgrgr")
    cpu = torch.device("cpu")
    params = generators.weights(cfg["layers"], SCHEME, 5, cpu)
    layer = port.load_weights(port.network(cfg), params)
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.normal(size=(100, 4, 1)).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, 1025, size=(20, 4)))
    loss_fn = training.make_loss_fn(layer, min_prob=1e-30, drop=2,
                                    counts=True)
    want, _, _ = loss_fn(x, labels, torch.ones(20, 4))
    want.backward()
    grads = port.named_tree(layer, {"sublayers": tuple(
        {k: p.grad for k, p in sub.named_parameters(recurse=False)}
        if not hasattr(sub, "layer") else {"sublayer": {
            k: p.grad for k, p in sub.layer.named_parameters(
                recurse=False)}} for sub in layer.layers)})
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    got = train.loss(cfg["layers"], p, x, labels, 2, 1e-30)
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    for k, g in grads.items():
        torch.testing.assert_close(p[k].grad, g, rtol=1e-4, atol=1e-6)


def test_benchmark_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 3.0])
    assert model.round_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0, 3.0]

