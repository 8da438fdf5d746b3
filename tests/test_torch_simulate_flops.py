"""The port's read simulator and FLOP count against the JAX package's (CPU).

Simulation: the same seeds give bit-identical levels, genomes and reads; a
read the port writes with ``write_fast5`` reads back through the port's
readers (and the JAX package's ``Fast5``) to the signal and reference it
was made from.  FLOPs: every registered model, and the headline stand-in
at 157,382.4 per sample, counted from the port's own parameters, equal the
JAX package's count from its parameters (exact: both sum the same integer
shapes).
"""
import json
import os

import h5py
import jax
import numpy as np
import pytest

from sloika_tpu import basecall as jbc
from sloika_tpu import models as jmodels
from sloika_tpu import serialize as jser
from sloika_tpu.data import simulate as jsim
from sloika_tpu.data.fast5 import Fast5
from sloika_tpu.nn import flops as jflops
from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch import models as tmodels
from sloika_tpu_torch.data import fast5
from sloika_tpu_torch.data import simulate as tsim
from sloika_tpu_torch.nn import flops as tflops

READ_LEN = 500


@pytest.mark.parametrize("kmer_len,seed", [(5, 101), (3, 7)])
def test_pore_model_equals_jax(kmer_len, seed):
    np.testing.assert_array_equal(tsim.pore_model(kmer_len, seed),
                                  jsim.pore_model(kmer_len, seed))


@pytest.mark.parametrize("seed", (0, 3))
def test_simulate_read_equals_jax(seed):
    genome = tsim.random_genome(5000, seed=seed)
    assert genome == jsim.random_genome(5000, seed=seed)
    kw = dict(read_len=READ_LEN, noise_sd=0.3, dwell_min=4, dwell_mean=8.0)
    got = tsim.simulate_read(genome, np.random.RandomState(seed + 1), **kw)
    ref = jsim.simulate_read(genome, np.random.RandomState(seed + 1), **kw)
    assert sorted(got) == sorted(ref)
    for key in got:
        if isinstance(got[key], bytes):
            assert got[key] == ref[key]
        else:
            assert got[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(got[key], ref[key])
    assert got["sequence"] in genome and len(got["sequence"]) == READ_LEN


def test_write_fast5_round_trip(tmp_path):
    """The port's file through the port's readers and the JAX ``Fast5``:
    the quantised signal back to its levels, the reference, the events,
    and ``load_raw_signal`` equal to the JAX package's."""
    genome = tsim.random_genome(5000, seed=2)
    read = tsim.simulate_read(genome, np.random.RandomState(4),
                              read_len=READ_LEN)
    path = str(tmp_path / "sim_0003.fast5")
    tsim.write_fast5(path, read, read_number=3)
    assert fast5.filename_short(path) == "sim_0003"
    assert fast5.read_reference_fasta(path) == read["sequence"]
    sig = fast5.read_raw_signal(path)
    # 1 level unit = 300 counts about 2,000, range == digitisation
    np.testing.assert_allclose((sig - 2000.0) / 300.0, read["signal"],
                               atol=0.5 / 300 + 1e-6)
    with Fast5(path) as f5:
        np.testing.assert_array_equal(f5.get_read(raw=True), sig)
        assert f5.get_reference_fasta() == read["sequence"]
        table, attrs = f5.get_any_mapping_data("template")
    assert len(table) == len(read["dwells"]) and attrs["direction"] == "+"
    name, got = tbc.load_raw_signal(path)
    ref_name, ref = jbc.load_raw_signal(path)
    assert name == ref_name
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="No reference"):
        fast5.read_reference_fasta(path, section="complement")


def test_simulate_read_set_writes_the_jax_packages_files(tmp_path):
    kw = dict(genome_len=8000, read_len=READ_LEN, genome_seed=1, read_seed=2)
    g1, ours = tsim.simulate_read_set(str(tmp_path / "port"), 3, **kw)
    g2, theirs = jsim.simulate_read_set(str(tmp_path / "jax"), 3, **kw)
    assert g1 == g2
    assert [os.path.basename(f) for f in ours] == \
        [os.path.basename(f) for f in theirs]
    for a, b in zip(ours, theirs):
        with h5py.File(a, "r") as ha, h5py.File(b, "r") as hb:
            items = []
            ha.visititems(lambda n, o: items.append(n))
            for name in items:
                if isinstance(ha[name], h5py.Dataset):
                    np.testing.assert_array_equal(ha[name][()], hb[name][()])
                assert dict(ha[name].attrs).keys() == \
                    dict(hb[name].attrs).keys()


def _jax_flops(name, **kw):
    layer = jmodels.network_factory(name)(**kw)
    params = layer.init(jax.random.PRNGKey(0))
    return (jflops.flops_per_input_frame(layer, params),
            jflops.training_flops_per_input_frame(layer, params),
            jflops.downsample(layer))


@pytest.mark.parametrize("name", sorted(set(jmodels.REGISTRY)))
def test_flops_of_every_registered_model_equal_jax(name):
    layer = tmodels.network_factory(name)(klen=5, sd=0.5)
    fwd, train, stride = _jax_flops(name, klen=5, sd=0.5)
    assert tflops.flops_per_input_frame(layer) == fwd
    assert tflops.training_flops_per_input_frame(layer) == train
    assert tflops.downsample(layer) == stride
    assert fwd > 0


def test_flops_of_the_standin(tmp_path):
    """The headline model's stand-in: 2 x 393,456 dense weights over a
    stride of 5, the JAX package's count of the same graph read from the
    port's model JSON."""
    layer = tmodels.pretrained_standin()
    fwd = tflops.flops_per_input_frame(layer)
    assert fwd == pytest.approx(157382.4, abs=1e-6)
    path = str(tmp_path / "standin.json")
    with open(path, "w") as fh:
        json.dump(layer.to_json(params=True), fh)
    jlayer, jparams = jser.load_model_json(path)
    assert fwd == jflops.flops_per_input_frame(jlayer, jparams)
    assert tflops.training_flops_per_input_frame(layer) == \
        jflops.training_flops_per_input_frame(jlayer, jparams) == 3 * fwd
    # the parameters given explicitly count the same
    assert tflops.flops_per_input_frame(layer, layer.param_tree()) == fwd
