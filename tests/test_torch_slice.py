"""The ported slice end to end against the JAX package (CPU).

A small rGr-shaped model (Convolution stride 5 -> Reverse(GRU) -> GRU ->
Reverse(GRU) -> Softmax, klen 3, widths <= 16) is built and initialised in
JAX and carried to the port through ``params_from_numpy``, a model JSON and
an ``.npz`` checkpoint.  The init sd is large (3.0) so the posteriors are
peaked: the port and JAX differ by float32 round-off in the forward (and
by an ulp in ``log``), which could flip the decoded path where two paths
score nearly the same; peaked posteriors leave no such near-ties, so the
FASTA must be identical.
"""
import io
import json

import jax
import numpy as np
import pytest
import torch

import sloika_tpu.nn as jnn
from sloika_tpu import basecall as jbc
from sloika_tpu import serialize as jser
from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch import models as tmodels
from sloika_tpu_torch import serialize as tser

KLEN = 3
SD = 3.0
CALL = dict(batch_size=4, chunk_size=1024, overlap=128)


@pytest.fixture(scope="module")
def jax_model():
    init = jnn.truncated_normal(SD)
    layer = jnn.Serial([
        jnn.Convolution(1, 16, 11, 5, init=init, has_bias=True),
        jnn.Reverse(jnn.Gru(16, 12, init=init, has_bias=True)),
        jnn.Gru(12, 16, init=init, has_bias=True),
        jnn.Reverse(jnn.Gru(16, 12, init=init, has_bias=True)),
        jnn.Softmax(12, 4 ** KLEN + 1, init=init, has_bias=True),
    ])
    return layer, layer.init(jax.random.PRNGKey(11))


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port(jax_model):
    layer, params = jax_model
    port, _ = tser.load_model_json(layer.to_json(None))
    return tser.params_from_numpy(port, _numpy_tree(params))


def _dac_reads(lens, seed=17):
    rs = np.random.RandomState(seed)
    reads = []
    for L in lens:
        dac = rs.randint(-2000, 2000, size=L).astype(np.int16)
        off = np.float32(rs.randint(-10, 10))
        sc = np.float32(rs.uniform(0.05, 0.2))
        scaled = (dac.astype(np.float32) + off) * sc
        med = np.float32(np.median(scaled))
        mad = np.float32(1.4826 * np.median(np.abs(scaled - med)))
        reads.append((dac, (off, sc, med, mad)))
    return reads


def _fasta(results, lens):
    fh = io.StringIO()
    printer = tbc.SeqPrinter(fh=fh)
    for i, ((score, codes), n) in enumerate(zip(results, lens)):
        printer.write_codes("read{}".format(i), score, codes, n)
    return fh.getvalue()


def _posteriors(layer_j, params, layer_t, T=300, B=4, seed=3):
    rs = np.random.RandomState(seed)
    x = rs.normal(size=(T, B, 1)).astype(np.float32)
    lengths = np.array([T, 211, 57, 290], np.int32)[:B]
    pj, lj = layer_j.apply_with_lengths(params, jax.numpy.asarray(x),
                                        jax.numpy.asarray(lengths))
    with torch.no_grad():
        pt, lt = layer_t.apply_with_lengths(torch.from_numpy(x),
                                            torch.from_numpy(lengths).long())
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    mask = np.arange(pt.shape[0])[:, None] < lt.numpy()[None, :]
    return np.asarray(pj), pt.numpy(), mask


def test_posteriors_match_under_mask(jax_model):
    layer, params = jax_model
    pj, pt, mask = _posteriors(layer, params, _port(jax_model))
    assert np.max(np.abs(pj - pt) * mask[:, :, None]) <= 1e-5


def test_json_and_checkpoint_round_trips(jax_model, tmp_path):
    layer, params = jax_model
    jpath, npath = str(tmp_path / "m.json"), str(tmp_path / "m.npz")
    jser.save_model_json(jpath, layer, params)
    jser.save_checkpoint(npath, layer, params)
    from_json, tree = tser.load_model_json(jpath)
    from_npz, _, _ = tser.load_checkpoint(npath)
    ref = jax.tree_util.tree_leaves(_numpy_tree(params))
    for port in (from_json, from_npz):
        got = jax.tree_util.tree_leaves(port.param_tree())
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    # port -> JSON -> JAX is exact as well
    back = str(tmp_path / "back.json")
    tser.save_model_json(back, from_npz)
    _, params_back = jser.load_model_json(back)
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(
        jax.tree_util.tree_leaves(params_back), ref))
    pj, pt, mask = _posteriors(layer, params, from_json)
    assert np.max(np.abs(pj - pt) * mask[:, :, None]) <= 1e-5


def test_dac_fasta_identical_to_jax(jax_model):
    layer, params = jax_model
    reads = _dac_reads((2500, 900, 4100))
    lens = [len(d) for d, _ in reads]
    ref = jbc.Basecaller(layer, params, KLEN, chunked=True, output="bases",
                         viterbi_impl="pallas", **CALL).basecall_dac_reads(
                             reads)
    caller = tbc.Basecaller(_port(jax_model), KLEN, output="bases",
                            device="cpu", **CALL)
    got = caller.basecall_dac_reads(reads)
    assert _fasta(got, lens) == _fasta(ref, lens)
    assert all(len(codes) > 10 for _, codes in got)
    for (s1, _), (s2, _) in zip(got, ref):
        assert s1 == pytest.approx(s2, rel=1e-5)
    # the host-normalised signal path gives the same calls
    sigs = [tbc.normalise_dac_f32(d, n) for d, n in reads]
    assert _fasta(caller.basecall_signals(sigs), lens) == _fasta(got, lens)


def test_raw_cli_fasta_identical_to_jax(jax_model, tmp_path):
    from sloika_tpu.cli import basecall as jcli
    from sloika_tpu.data import simulate
    from sloika_tpu_torch.cli import basecall as tcli
    layer, params = jax_model
    reads = str(tmp_path / "reads")
    simulate.simulate_read_set(reads, 3, genome_len=20000, read_len=500,
                               kmer_len=KLEN)
    ckpt = str(tmp_path / "model.npz")
    jser.save_checkpoint(ckpt, layer, params)
    common = ["raw", ckpt, reads, "--chunked", "--kmer_len", str(KLEN),
              "--batch", "4", "--chunk_size", "1024", "--overlap", "128"]
    jout, tout = str(tmp_path / "jax.fa"), str(tmp_path / "port.fa")
    assert jcli.main(common + ["--device_collapse", "on", "--dac", "on",
                               "--output", jout]) == 0
    assert tcli.main(common + ["--device", "cpu", "--output", tout]) == 0
    port_fa, jax_fa = open(tout).read(), open(jout).read()
    assert port_fa.count(">") == 3
    assert port_fa == jax_fa


def test_pretrained_standin_widths():
    """The headline stand-in is pretrained.pkl's graph at its widths:
    393,456 dense weights, 157,382.4 FLOP per input sample at stride 5."""
    layer = tmodels.pretrained_standin(seed=0)
    dense = sum(p.numel() for n, p in layer.named_parameters()
                if not n.endswith(".b"))
    assert dense == 393456
    assert 2 * dense / 5 == pytest.approx(157382.4)
    assert json.loads(json.dumps(layer.to_json()))["sublayers"][2]["size"] \
        == 144
    # seeded: the same seed gives the same weights
    again = tmodels.pretrained_standin(seed=0)
    assert all(torch.equal(a, b) for a, b in zip(layer.parameters(),
                                                 again.parameters()))


def test_cli_file_listing_follows_strand_list(tmp_path):
    from sloika_tpu_torch.cli import basecall as tcli
    for name in ("a.fast5", "b.fast5", "c.fast5", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    strands = tmp_path / "strands.tsv"
    strands.write_text("filename\tother\nc.fast5\t1\na.fast5\t2\n")
    names = lambda fs: [f.rsplit("/", 1)[-1] for f in fs]
    assert names(tcli.iterate_fast5(str(tmp_path))) == [
        "a.fast5", "b.fast5", "c.fast5"]
    assert names(tcli.iterate_fast5(str(tmp_path), limit=2)) == [
        "a.fast5", "b.fast5"]
    assert names(tcli.iterate_fast5(str(tmp_path),
                                    strand_list=str(strands))) == [
        "a.fast5", "c.fast5"]
