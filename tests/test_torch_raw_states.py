"""The port's default raw basecall path against the JAX package (CPU):
whole raw reads, normalised on the host, decoded in "states" mode.

One small JAX model (a convolution of stride 5, one GRU and a softmax over
the 65 states of k = 3) is carried to the port through a checkpoint.  Its
numpy-made weights are large (sd 3 / sqrt(fan-in)), so the posteriors are
peaked and float32 round-off in the forwards cannot flip a near-tie: calls
and FASTA must be identical, scores within 1e-5 relative.  The JAX ``Basecaller`` pads each batch to a
bucketed length; a padded frame is a one-hot stay, which adds nothing.
"""
import jax
import numpy as np
import pytest

import sloika_tpu.nn as jnn
from sloika_tpu import basecall as jbc
from sloika_tpu import serialize as jser
from sloika_tpu.cli import basecall as jcli
from sloika_tpu.data import simulate
from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch import serialize as tser
from sloika_tpu_torch.cli import basecall as tcli

KLEN = 3
NREADS = 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("raw_states")
    layer = jnn.Serial([
        jnn.Convolution(1, 8, 11, 5, has_bias=True),
        jnn.Gru(8, 12, has_bias=True),
        jnn.Softmax(12, 4 ** KLEN + 1, has_bias=True),
    ])
    # numpy-made weights at sd 3 / sqrt(fan-in): large enough for peaked
    # posteriors, scaled so that the GRU does not amplify round-off
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda a: (3.0 * rs.normal(size=a.shape)
                   / np.sqrt(a.shape[-1])).astype(a.dtype),
        jax.eval_shape(layer.init, jax.random.PRNGKey(0)))
    ckpt = str(tmp / "model.npz")
    jser.save_checkpoint(ckpt, layer, params)
    reads = str(tmp / "reads")
    _, files = simulate.simulate_read_set(reads, NREADS, genome_len=20000,
                                          read_len=400, kmer_len=KLEN)
    return {"layer": layer, "params": params, "ckpt": ckpt, "reads": reads,
            "files": sorted(files), "tmp": tmp}


def test_raw_parser_defaults_equal_jax(setup):
    argv = ["raw", setup["ckpt"], setup["reads"]]
    ours = vars(tcli.make_parser().parse_args(argv))
    ref = vars(jcli.make_parser().parse_args(argv))
    assert ours["chunked"] is False
    for key in ("chunked", "batch", "chunk_size", "overlap", "kmer_len",
                "limit", "min_prob", "skip", "trim", "open_pore_fraction"):
        assert ours[key] == ref[key], key


def test_load_raw_signal_equals_jax(setup):
    for path in setup["files"]:
        name, sig = tbc.load_raw_signal(path)
        ref_name, ref = jbc.load_raw_signal(path)
        assert name == ref_name
        assert sig.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(sig, ref)
    # trimmed to nothing: both give None
    assert tbc.load_raw_signal(setup["files"][0], trim=(10 ** 6, 0)) is None
    assert jbc.load_raw_signal(setup["files"][0], trim=(10 ** 6, 0)) is None


def test_whole_read_basecall_equals_jax(setup):
    sigs = [tbc.load_raw_signal(f)[1] for f in setup["files"]]
    ref = jbc.Basecaller(setup["layer"], setup["params"], KLEN,
                         batch_size=2).basecall_signals(sigs)
    port, _, _ = tser.load_checkpoint(setup["ckpt"])
    caller = tbc.Basecaller(port, KLEN, batch_size=2, device="cpu")
    assert caller.output == "states"
    got = caller.basecall_signals(sigs)
    for (s1, c1), (s2, c2) in zip(got, ref):
        assert s1 == pytest.approx(s2, rel=1e-5)
        np.testing.assert_array_equal(c1, c2)
        assert len(c1) > 10
    # DAC windows are the chunked mode's: a "states" caller refuses them
    with pytest.raises(ValueError):
        caller.basecall_dac_reads([(np.zeros(500, np.int16),
                                    (0.0, 1.0, 0.0, 1.0))])


def test_raw_cli_default_fasta_equals_jax(setup):
    common = ["raw", setup["ckpt"], setup["reads"], "--kmer_len", str(KLEN),
              "--batch", "2"]
    jout = str(setup["tmp"] / "jax.fa")
    tout = str(setup["tmp"] / "port.fa")
    assert jcli.main(common + ["--output", jout]) == 0
    assert tcli.main(common + ["--device", "cpu", "--output", tout]) == 0
    port_fa, jax_fa = open(tout).read(), open(jout).read()
    assert port_fa.count(">") == NREADS
    assert " samples to " in port_fa
    assert port_fa == jax_fa
