"""``raw_remap`` chunkify of the port against the JAX package's (CPU), with
and without ``--dac``, on simulated fast5 reads and one model JSON.

The chunks, labels, weights and bad flags in the HDF5 must be equal, and so
must the strand lists except the score column (within 1e-5: the two
forwards differ by float32 round-off).  The model's init sd is large so
its posteriors are peaked, as in tests/test_torch_remapper.py.
"""
import os

import h5py
import jax
import numpy as np
import pytest

import sloika_tpu.nn as jnn
from sloika_tpu import serialize as jser
from sloika_tpu.cli import chunkify as jcli
from sloika_tpu.data import simulate
from sloika_tpu_torch.cli import chunkify as tcli
from tests.test_torch_remapper import _numpy_init

KLEN = 3
SCORE_RTOL = 1e-5


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Three simulated reads of ~2,000 samples, their references, and a
    conv + softmax model JSON."""
    root = tmp_path_factory.mktemp("remap_cli")
    reads = root / "reads"
    reads.mkdir()
    genome = simulate.random_genome(20000, seed=0)
    rs = np.random.RandomState(1)
    levels = simulate.pore_model(KLEN)
    with open(root / "refs.fa", "w") as fh:
        for i in range(3):
            read = simulate.simulate_read(genome, rs, read_len=230,
                                          kmer_len=KLEN, levels=levels)
            name = "synth_{:04d}".format(i)
            simulate.write_fast5(str(reads / (name + ".fast5")), read, i)
            fh.write(">{}\n{}\n".format(name, read["sequence"].decode()))
    init = _numpy_init(5)
    layer = jnn.Serial([
        jnn.Convolution(1, 16, 5, 5, init=init, has_bias=True),
        jnn.Softmax(16, 4 ** KLEN + 1, init=init, has_bias=True),
    ])
    jser.save_model_json(str(root / "model.json"), layer,
                         layer.init(jax.random.PRNGKey(0)))
    return root


def _run(main, root, tag, extra):
    out = str(root / "{}.hdf5".format(tag))
    strands = str(root / "{}.txt".format(tag))
    rc = main(["raw_remap", str(root / "reads"), out, str(root / "model.json"),
               str(root / "refs.fa"), "--kmer_len", str(KLEN),
               "--chunk_len", "500", "--min_length", "500", "--batch", "2",
               "--jobs", "1", "--output_strand_list", strands,
               "--overwrite"] + extra)
    assert rc == 0
    with h5py.File(out, "r") as h5:
        data = {k: h5[k][:] for k in ("chunks", "labels", "bad", "weights")}
        data["attrs"] = dict(h5["/"].attrs)
    with open(strands) as fh:
        rows = [line.rstrip("\n").split("\t") for line in fh]
    return data, rows


@pytest.mark.parametrize("wire", [[], ["--dac"]], ids=["signal", "dac"])
def test_raw_remap_cli_matches_jax(workspace, wire):
    ref, ref_rows = _run(jcli.main, workspace, "jax" + "".join(wire), wire)
    got, got_rows = _run(tcli.main, workspace, "torch" + "".join(wire),
                         wire + ["--device", "cpu"])
    for k in ("chunks", "labels", "bad", "weights"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert len(got["chunks"]) >= 6
    assert set(got["attrs"]) == set(ref["attrs"])
    for k, v in ref["attrs"].items():
        np.testing.assert_array_equal(got["attrs"][k], v, err_msg=k)
    assert len(got_rows) == len(ref_rows) == 4
    assert got_rows[0] == ref_rows[0]
    for g, r in zip(got_rows[1:], ref_rows[1:]):
        assert g[:2] + g[3:] == r[:2] + r[3:]
        assert float(g[2]) == pytest.approx(float(r[2]), rel=SCORE_RTOL)
    assert os.path.basename(got_rows[1][0]) == "synth_0000.fast5"
