"""The yardstick's arithmetic: the FLOP count of each configuration, the
roofline counts against hand-worked shapes, and the calls' edit distance
against the plain dynamic programme."""
import numpy as np
import pytest

from benchmark.harness import compare, roofline, spec
from benchmark.reference import model


def _layers(name):
    return spec.load_json("{}/benchmark/configs/{}.json".format(
        spec.ROOT, name))["layers"]


def test_benchmark_flops_of_the_standin():
    # conv 2*128*11/5 + (2 * (3*112*128 + 3*112^2) + 2 * (3*144*112 +
    # 3*144^2) + 2 * (3*112*144 + 3*112^2) + 2*1025*112) / 5
    assert roofline.flops_per_sample(_layers("sloika_pretrained")) == \
        pytest.approx(157382.4, rel=1e-12)


def test_benchmark_flops_of_rgrgr():
    per_frame = 5 * 2 * (3 * 96 * 96 + 3 * 96 * 96) + 2 * 1025 * 96
    assert roofline.flops_per_sample(_layers("raw_0.98_rgrgr")) == \
        pytest.approx(2 * 96 * 11 / 5 + per_frame / 5, rel=1e-12)


def test_benchmark_roofline_counts_by_hand():
    # gru_fwd, 10 steps at S = 4: 16 floats a step and 48 of weights
    assert roofline.gru_fwd_bound(10, 4) == (4 * (160 + 48), 6 * 16 * 10)
    fwd, bwd, wgrad = roofline.gru_train_bounds(10, 4)
    assert fwd == (4 * (280 + 48), 960)
    assert bwd == (4 * (360 + 48), 960)
    assert wgrad == (4 * (200 + 48), 960)
    # viterbi at T 3, B 2, K 4: 5 posterior floats, 4 codes a row-frame
    assert roofline.viterbi_fwd_bound(3, 2, K=4) == (
        3 * 2 * 5 * 4 + 3 * 2 * 4 + 2 * 4 * 4, 42 * 3 * 2 * 4)
    assert roofline.viterbi_back_bound(3, 2) == (3 * 2 * 6 + 8, 18)
    # the head at 10 frames, I 3, K 5: 50 floats written, 2*3*5 a frame
    assert roofline.output_head_bound(10, 3, 5) == (200, 300)
    assert roofline.remap_bytes(3, 2, 1, 4, 5) == (
        3 * 1025 * 4 + 45 + 8 + 2 * 4 * 2 + 16)


def test_benchmark_bound_takes_the_longer_side():
    assert roofline.bound(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_benchmark_frame_counts():
    layers = _layers("sloika_pretrained")
    assert model.stride(layers) == 5
    # 'same' padding of 11: 1 + (L - 1) // 5 frames
    got = model.out_lengths(layers, np.array([16384, 5, 6, 1]))
    assert list(got) == [3277, 1, 2, 1]


def _plain_edit_distance(a, b):
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


@pytest.mark.parametrize("seed", range(4))
def test_benchmark_edit_distance_equals_the_plain_dp(seed):
    rs = np.random.RandomState(seed)
    for _ in range(300):
        a = rs.randint(4, size=rs.randint(0, 70))
        b = a.copy()
        for _ in range(rs.randint(0, 10)):
            k = rs.randint(3)
            if k == 0 and len(b):
                b = np.delete(b, rs.randint(len(b)))
            elif k == 1:
                b = np.insert(b, rs.randint(len(b) + 1), rs.randint(4))
            elif len(b):
                b[rs.randint(len(b))] = rs.randint(4)
        if rs.rand() < 0.2:
            b = rs.randint(4, size=rs.randint(0, 70))
        assert compare.edit_distance(a, b) == _plain_edit_distance(a, b)


def test_benchmark_base_error_pools_the_reads():
    want = [np.zeros(90, np.uint8), np.ones(10, np.uint8)]
    got = [np.zeros(88, np.uint8), np.array([1] * 9 + [2], np.uint8)]
    # two deletions and one substitution over 100 bases
    assert compare.base_error(got, want) == pytest.approx(0.03)


def test_benchmark_output_head_reader_on_the_chunked_batch():
    """The head's share at PERF.md's chunked batch: 1,024 rows of 3,277
    frames, I 112, K 1,025, in 35.382 ms; the product bounds it at 11.499
    ms (the posterior's 13.76 GB at 3.35 TB/s is 4.11 ms)."""
    import importlib.util
    from types import SimpleNamespace
    path = "{}/benchmark/metrics/output_head_roofline.basecall.py".format(
        spec.ROOT)
    s = importlib.util.spec_from_file_location("head_reader", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    trace = SimpleNamespace(kernel_seconds=lambda *names: 0.035382 * (
        names == ("output_head_kernel",)))
    ctx = SimpleNamespace(trace=trace, work={"frames": 1024 * 3277},
                          layers=_layers("sloika_pretrained"))
    assert mod.read(ctx) == pytest.approx(100 * 11.499 / 35.382, rel=1e-3)
    ctx.trace = SimpleNamespace(kernel_seconds=lambda *names: 0.0)
    assert mod.read(ctx) is None
