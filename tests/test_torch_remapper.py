"""The port's Remapper and ``raw_remap`` chunkify against the JAX package's
(CPU).

The weights are made in JAX and carried to the port through a model JSON
and ``params_from_numpy``.  Their init sd is large, so the posteriors are
peaked: the two forwards differ by float32 round-off (and an ulp of
``log``), which could flip a path only where two paths score nearly the
same.  Paths and mapping tables must be equal, scores within 1e-5.

Band modes: ``band=None`` against the JAX package's CPU default (its exact
XLA DP); ``band=64`` against JAX with ``SLOIKA_TPU_REMAP_IMPL=pallas``,
which runs the block-quantised Pallas kernel in interpret mode, the
contract the port keeps on every device.
"""
import collections

import jax
import numpy as np
import pytest
import torch

import sloika_tpu.nn as jnn
from sloika_tpu import remap as jremap
from sloika_tpu_torch import remap as tremap
from sloika_tpu_torch import serialize as tser
from sloika_tpu_torch.basecall import gather_normalise_dac, normalise_dac_f32
from sloika_tpu_torch.data import raw_chunkify as traw

KLEN = 3
SD = 2.0
SCORE_RTOL = 1e-5
#: (samples, reference bases); the last read's reference is longer than
#: its frames, so its 64-band path misses the end and is re-run wider.
#: Both batches' references bucket to P = 384, so the JAX DP compiles once
#: for both
READS = [(1900, 270), (1500, 140), (1200, 110), (1000, 300)]


def _numpy_init(seed):
    """A layer initialiser drawing truncated normals of sd ``SD`` with
    numpy (JAX's ``truncated_normal`` compiles for every shape, which
    costs seconds); the layers scale them as usual."""
    rs = np.random.RandomState(seed)

    def init(key, shape):
        return (SD * np.clip(rs.normal(size=shape), -2.0, 2.0)) \
            .astype(np.float32)
    return init


def _jax_models():
    init = _numpy_init(5)
    conv = jnn.Serial([
        jnn.Convolution(1, 16, 5, 5, init=init, has_bias=True),
        jnn.Softmax(16, 4 ** KLEN + 1, init=init, has_bias=True),
    ])
    init = _numpy_init(3)
    gru = jnn.Serial([
        jnn.Convolution(1, 16, 11, 5, init=init, has_bias=True),
        jnn.Reverse(jnn.Gru(16, 12, init=init, has_bias=True)),
        jnn.Gru(12, 16, init=init, has_bias=True),
        jnn.Reverse(jnn.Gru(16, 12, init=init, has_bias=True)),
        jnn.Softmax(12, 4 ** KLEN + 1, init=init, has_bias=True),
    ])
    key = jax.random.PRNGKey(0)
    return {"conv": (conv, conv.init(key)), "gru": (gru, gru.init(key))}


def _port(layer, params):
    port, _ = tser.load_model_json(layer.to_json(None))
    return tser.params_from_numpy(
        port, jax.tree_util.tree_map(np.asarray, params))


def _reads(seed=7):
    rs = np.random.RandomState(seed)
    dacs, refs = [], []
    for n, rlen in READS:
        d = rs.randint(-400, 400, size=n).astype(np.int16)
        offset = np.float32(rs.uniform(-5, 5))
        scale = np.float32(rs.uniform(0.05, 0.2))
        s = (d.astype(np.float32) + offset) * scale
        med = np.float32(np.median(s))
        mad = np.float32(1.4826 * np.median(np.abs(s - med)))
        dacs.append((d, (offset, scale, med, mad)))
        refs.append(bytes(rs.choice([65, 67, 71, 84],
                                    size=rlen).astype(np.uint8)))
    sigs = [normalise_dac_f32(d, n4) for d, n4 in dacs]
    return dacs, sigs, refs


CONFIGS = [(model, band) for model in ("conv", "gru") for band in (None, 64)]


def _spy_dispatches(remapper):
    """Record the (read indices, band) of each batch a Remapper queues."""
    calls = []
    dispatch = remapper._dispatch_batch

    def spy(sigs, refs, idx, band, dac=False):
        calls.append((tuple(int(i) for i in idx), band))
        return dispatch(sigs, refs, idx, band, dac)
    remapper._dispatch_batch = spy
    return calls


@pytest.fixture(scope="module")
def remapped():
    """{(model, band): (JAX results, port results, JAX and port batches,
    the port Remapper)}, by wire; each JAX run made once.  JAX runs the
    signal wire only: its own tests/test_remap.py::
    test_dac_wire_matches_host_normalised shows its two wires
    bit-identical, so the port's DAC wire is held to JAX's signal wire."""
    dacs, sigs, refs = _reads()
    models = _jax_models()
    runs = {}
    mp = pytest.MonkeyPatch()
    try:
        for model, band in CONFIGS:
            layer, params = models[model]
            if band is None:
                mp.delenv("SLOIKA_TPU_REMAP_IMPL", raising=False)
            else:
                mp.setenv("SLOIKA_TPU_REMAP_IMPL", "pallas")
            kw = dict(slip=5.0, prior=(10.0, 10.0), batch_size=2, band=band)
            jr = jremap.Remapper(layer, params, KLEN, **kw)
            tr = tremap.Remapper(_port(layer, params), KLEN, device="cpu",
                                 **kw)
            j_calls, t_calls = _spy_dispatches(jr), _spy_dispatches(tr)
            ref = {"signals": jr.remap_signals(sigs, refs)}
            got = {"signals": tr.remap_signals(sigs, refs)}
            batches = (list(j_calls), list(t_calls))
            ref["dac"] = ref["signals"]
            got["dac"] = tr.remap_dac_signals(dacs, refs)
            runs[(model, band)] = (ref, got, batches, tr)
    finally:
        mp.undo()
    return sigs, runs


@pytest.mark.parametrize("wire", ["signals", "dac"])
@pytest.mark.parametrize("model,band", CONFIGS)
def test_remapper_matches_jax(remapped, model, band, wire):
    sigs, runs = remapped
    ref, got = (r[wire] for r in runs[(model, band)][:2])
    for sig, (s_j, m_j, p_j, q_j), (s_t, m_t, p_t, q_t) in zip(sigs, ref,
                                                                 got):
        assert s_t == pytest.approx(s_j, rel=SCORE_RTOL)
        np.testing.assert_array_equal(p_t, p_j)
        np.testing.assert_array_equal(q_t, q_j)
        assert m_t.dtype == m_j.dtype
        for field in m_j.dtype.names:
            np.testing.assert_array_equal(m_t[field], m_j[field])
        assert traw.mapping_table_is_registered(sig, m_t)


def test_remapper_wires_agree(remapped):
    """The DAC wire gathers and normalises on the device in the host's
    float32 order, bit for bit, so both wires give the same paths.  (Their
    scores are held to JAX above: PyTorch's multithreaded CPU forward may
    split a sum differently from one run to the next.)"""
    dacs, sigs, _ = _reads()
    lengths = np.array([len(d) for d, _ in dacs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    flat = np.concatenate([d for d, _ in dacs] + [np.zeros(2048, np.int16)])
    norms = np.array([n4 for _, n4 in dacs], np.float32)
    x = gather_normalise_dac(torch.from_numpy(flat), torch.from_numpy(offsets),
                             torch.from_numpy(lengths),
                             torch.from_numpy(norms), 2048)
    for b, sig in enumerate(sigs):
        np.testing.assert_array_equal(x[:len(sig), b, 0].numpy(), sig)
        assert not x[len(sig):, b].any()
    _, runs = remapped
    for model, band in CONFIGS:
        got = runs[(model, band)][1]
        for a, b in zip(got["signals"], got["dac"]):
            assert a[0] == pytest.approx(b[0], rel=SCORE_RTOL)
            np.testing.assert_array_equal(a[2], b[2])


def test_band_misses_rerun_as_in_jax(remapped):
    """Reads whose 64-band path misses a sequence end are re-run with a 4x
    band, then exact, in the same batches as the JAX package runs them;
    the last read (a reference longer than its frames) always misses.
    The Remapper counts the re-run reads and the DP windows of both
    wires' calls."""
    _, runs = remapped
    for model in ("conv", "gru"):
        (j_calls, t_calls), tr = runs[(model, 64)][2:]
        assert t_calls == j_calls
        assert any(3 in idx and band == 256 for idx, band in t_calls[2:])
        # each count is of both wires' calls; every batch's P buckets to
        # 384, the exact window
        reruns = collections.Counter()
        windows = collections.Counter({64: 4})
        for idx, band in t_calls[2:]:
            reruns[band] += 2 * len(idx)
            windows[band or 384] += 2
        assert tr.reruns == reruns
        assert tr.windows == windows
        exact = runs[(model, None)][3]
        assert not exact.reruns
        assert exact.windows == collections.Counter({384: 4})
    # the conv model's overlong read goes on from 256 to the exact DP
    assert ((3,), None) in runs[("conv", 64)][2][1]


def test_remapper_on_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    layer, params = _jax_models()["conv"]
    port = _port(layer, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tremap.Remapper(port, KLEN, device="cuda")
    assert all(p.device.type == "cpu" for p in port.parameters())


# ---------------------------------------------------------------------------
# The batch guards (sloika_tpu/remap.py:240-368), each against the JAX
# package: the conv model, exact DP, batches of 4
# ---------------------------------------------------------------------------

def _guarded_pair(batch_size=4):
    layer, params = _jax_models()["conv"]
    kw = dict(slip=5.0, prior=(10.0, 10.0), batch_size=batch_size, band=None)
    jr = jremap.Remapper(layer, params, KLEN, **kw)
    tr = tremap.Remapper(_port(layer, params), KLEN, device="cpu", **kw)
    return jr, tr


def _same_results(got, ref):
    for (s_t, m_t, p_t, q_t), (s_j, m_j, p_j, q_j) in zip(got, ref):
        assert s_t == pytest.approx(s_j, rel=SCORE_RTOL)
        np.testing.assert_array_equal(p_t, p_j)
        np.testing.assert_array_equal(q_t, q_j)
        for field in m_j.dtype.names:
            np.testing.assert_array_equal(m_t[field], m_j[field])


def test_dac_group_guard_halves_as_in_jax(monkeypatch):
    """A DAC batch whose flat sample buffer would pass _MAX_GROUP_SAMPLES
    is split in halves, recursively, in both packages alike (the limit
    monkeypatched below the 2^18-sample bucket floor, so every batch of
    two or more splits down to single reads)."""
    dacs, _, refs = _reads()
    monkeypatch.setattr(jremap, "_MAX_GROUP_SAMPLES", 1 << 17)
    monkeypatch.setattr(tremap, "_MAX_GROUP_SAMPLES", 1 << 17)
    jr, tr = _guarded_pair()
    j_calls, t_calls = _spy_dispatches(jr), _spy_dispatches(tr)
    ref = jr.remap_dac_signals(dacs, refs)
    got = tr.remap_dac_signals(dacs, refs)
    assert t_calls == j_calls
    assert all(len(idx) == 1 for idx, _ in t_calls) and len(t_calls) == 4
    _same_results(got, ref)
    assert not tr._oom_sizes


def test_out_of_memory_halves_as_in_jax():
    """A batch above 2 reads that exhausts device memory is re-run as two
    halves, in both packages at the same place (the port's dispatch raises
    ``torch.OutOfMemoryError``, the JAX one an error naming
    RESOURCE_EXHAUSTED); the shape is remembered, so a second call goes
    straight to halves; the results are the JAX package's."""
    _, sigs, refs = _reads()
    jr, tr = _guarded_pair()

    def failing(remapper, error):
        calls = []
        dispatch = remapper._dispatch_batch

        def spy(s, r, idx, band, dac=False):
            calls.append(tuple(int(i) for i in idx))
            if len(s) > 2:
                raise error("RESOURCE_EXHAUSTED: out of memory allocating "
                            "the traceback")
            return dispatch(s, r, idx, band, dac)
        remapper._dispatch_batch = spy
        return calls

    j_calls = failing(jr, RuntimeError)
    t_calls = failing(tr, torch.OutOfMemoryError)
    ref = jr.remap_signals(sigs, refs)
    got = tr.remap_signals(sigs, refs)
    assert t_calls == j_calls
    assert [len(c) for c in t_calls] == [4, 2, 2]
    _same_results(got, ref)
    key = tr._oom_key(sigs, refs, None, False)
    assert tr._oom_sizes == {key}
    del t_calls[:]
    tr.remap_signals(sigs, refs)
    assert [len(c) for c in t_calls] == [2, 2]


def test_a_non_oom_error_is_raised():
    _, sigs, refs = _reads()
    _, tr = _guarded_pair()

    def broken(s, r, idx, band, dac=False):
        raise RuntimeError("CUDA error: an illegal memory access")
    tr._dispatch_batch = broken
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tr.remap_signals(sigs, refs)
    assert not tr._oom_sizes


def test_out_of_memory_on_one_read_is_raised():
    _, sigs, refs = _reads()
    _, tr = _guarded_pair(batch_size=1)

    def oom(s, r, idx, band, dac=False):
        raise torch.OutOfMemoryError("out of memory")
    tr._dispatch_batch = oom
    with pytest.raises(torch.OutOfMemoryError):
        tr.remap_signals(sigs[:1], refs[:1])


def test_a_single_read_past_2_30_samples_is_refused():
    """One DAC read whose buffer would pass 2^30 samples is refused before
    any allocation, in both packages (a broadcast array of 6e8 samples
    takes no memory)."""
    dacs, _, refs = _reads()
    big = (np.broadcast_to(np.int16(0), (600_000_000,)), dacs[0][1])
    jr, tr = _guarded_pair()
    with pytest.raises(AssertionError, match=">2 GB device buffer"):
        jr.remap_dac_signals([big], refs[:1])
    with pytest.raises(ValueError, match=">2 GB device buffer"):
        tr.remap_dac_signals([big], refs[:1])
    # a read inside the limit passes the guard (its dispatch is replaced:
    # only the guard is under test)
    L = 200_000_000
    assert tremap.bucket_length(L + tremap.bucket_length(L),
                                min_len=1 << 18) <= 2 ** 30
    seen = []

    def dispatch(s, r, idx, band, dac=False):
        seen.append(len(s[0][0]))
        raise torch.OutOfMemoryError("out of memory")
    tr._dispatch_batch = dispatch
    with pytest.raises(torch.OutOfMemoryError):
        tr.remap_dac_signals([(np.broadcast_to(np.int16(0), (L,)),
                               dacs[0][1])], refs[:1])
    assert seen == [L]


def test_exact_window_of_the_22145_bucket_matches_jax():
    """A reference in the 22,145-position bucket remaps exactly at
    W = 22,272, the kernel's wide route on a card (here its plain twin),
    and gives the JAX package's path."""
    from sloika_tpu_torch.ops import remap_kernel as rk
    rs = np.random.RandomState(11)
    dacs, sigs, _ = _reads()
    ref = bytes(rs.choice([65, 67, 71, 84], size=15000).astype(np.uint8))
    jr, tr = _guarded_pair()
    got = tr.remap_signals(sigs[2:3], [ref])
    want = jr.remap_signals(sigs[2:3], [ref])
    assert tr.windows == collections.Counter({22272: 1})
    assert rk.kernel_route(22272) == "wide"
    _same_results(got, want)


def test_an_exact_window_past_32767_names_the_reference_length():
    rs = np.random.RandomState(12)
    _, sigs, _ = _reads()
    ref = bytes(rs.choice([65, 67, 71, 84], size=25000).astype(np.uint8))
    _, tr = _guarded_pair()
    with pytest.raises(ValueError, match="reference of 24998 k-mers"):
        tr.remap_signals(sigs[:1], [ref])
