"""The port's CLIs on two ranks (CPU, gloo), run in process through
``main(argv)``: ``basecall raw --devices 2``, ``chunkify raw_remap
--devices 2``, ``chunkify raw_identity`` under a launcher (it has no
``--devices``: the ranks are started by ``parallel.spawn.run``, as
``torchrun`` would start them) and ``train --ndevice 2``.  Each merged
output must equal one process's byte for byte (the CPU forwards of a
read do not depend on the other reads of its batch here: the model's
weights are large, sd 3 / sqrt(fan-in), so its posteriors are peaked),
and the FASTA the JAX CLI's.  ``raw_remap`` remaps a read a batch: the
remap's float32 scores move with the reads that share a batch (tests/
test_multihost.py:236-239 allows for it), and one read a batch makes the
shares' batches those of one process.  The basecall parser equals the JAX
parser flag for flag, plus ``--device``.

One shared shape: 5 reads from ``sloika_tpu.data.simulate`` (kmer length
3), uneven shares of 3 and 2, and one raw model (a convolution of stride
5, a GRU and a softmax) carried to the port through a checkpoint.
"""
import h5py
import jax
import numpy as np
import pytest

import sloika_tpu.nn as jnn
from sloika_tpu import serialize as jser
from sloika_tpu.cli import basecall as jbcli
from sloika_tpu.data import simulate
from sloika_tpu_torch.cli import basecall as tbcli
from sloika_tpu_torch.cli import chunkify as tccli
from sloika_tpu_torch.cli import train as ttcli
from sloika_tpu_torch.parallel import spawn

KLEN = 3
NREADS = 5
SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_cli")
    reads = str(root / "reads")
    _, files = simulate.simulate_read_set(reads, NREADS, genome_len=20000,
                                          read_len=400, kmer_len=KLEN)
    with open(root / "refs.fa", "w") as fh:
        for f in sorted(files):
            with h5py.File(f, "r") as h5:
                fasta = h5["Analyses/Alignment_000/Aligned_template/Fasta"][()]
            fh.write(fasta.decode() if isinstance(fasta, bytes) else fasta)
    layer = jnn.Serial([
        jnn.Convolution(1, 8, 11, 5, has_bias=True),
        jnn.Gru(8, 12, has_bias=True),
        jnn.Softmax(12, 4 ** KLEN + 1, has_bias=True),
    ])
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda a: (3.0 * rs.normal(size=a.shape)
                   / np.sqrt(a.shape[-1])).astype(a.dtype),
        jax.eval_shape(layer.init, jax.random.PRNGKey(0)))
    jser.save_checkpoint(str(root / "model.npz"), layer, params)
    return root


#: strings each flag's type is applied to (as tests/test_torch_chunkify.py)
PROBES = ("0", "1", "2", "-1", "0.5", "2.5", "100", "None", "ACGT", "x")


def _probe(kind):
    out = []
    for text in PROBES:
        try:
            out.append(repr(kind(text)))
        except Exception as e:
            out.append(type(e).__name__)
    return out


def _flags(parser):
    """{subcommand: {dest: (default, nargs, choices, the type's results on
    PROBES, the action's class)}}"""
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {name: {a.dest: (a.default, a.nargs, a.choices,
                            None if a.type is None else _probe(a.type),
                            type(a).__name__)
                   for a in p._actions if a.dest not in ("help", "version")}
            for name, p in sub.choices.items()}


def test_basecall_parser_flags_equal_jax():
    """Every flag of ``basecall raw`` and ``events`` takes the JAX parser's
    default, type (its results on probe strings), nargs, choices and
    action, ``--devices`` among them; the port adds ``--device``."""
    ours, ref = _flags(tbcli.make_parser()), _flags(jbcli.make_parser())
    assert set(ours) == set(ref) == {"raw", "events"}
    for name in ref:
        assert set(ours[name]) == set(ref[name]) | {"device"}, name
        for dest, row in ref[name].items():
            assert ours[name][dest] == row, (name, dest)
        assert ours[name]["devices"][0] == 1
    probe = ["raw", __file__, ".", "--devices", "3"]
    assert (tbcli.make_parser().parse_args(probe).devices
            == jbcli.make_parser().parse_args(probe).devices == 3)


def test_basecall_devices_2_equals_one_process_and_jax(ws):
    argv = ["raw", str(ws / "model.npz"), str(ws / "reads"), "--kmer_len",
            str(KLEN)]
    outs = {}
    for tag, extra in (("one", []), ("two", ["--devices", "2"])):
        outs[tag] = str(ws / "calls.{}.fa".format(tag))
        assert tbcli.main(argv + extra + ["--device", "cpu", "--output",
                                          outs[tag]]) == 0
    outs["jax"] = str(ws / "calls.jax.fa")
    assert jbcli.main(argv + ["--output", outs["jax"]]) == 0
    text = {k: open(v).read() for k, v in outs.items()}
    assert text["one"].count(">") == NREADS
    assert text["two"] == text["one"] == text["jax"]


def _chunks(path):
    with h5py.File(path, "r") as h5:
        return {k: h5[k][:] for k in ("chunks", "labels", "bad", "weights")}


def _chunkify(ws, command, tag, extra, main):
    out = str(ws / "{}.{}.hdf5".format(command, tag))
    argv = [command, str(ws / "reads"), out]
    if command == "raw_remap":
        argv += [str(ws / "model.npz"), str(ws / "refs.fa"),
                 "--output_strand_list", out + ".txt", "--batch", "1",
                 "--device", "cpu"]
    argv += ["--kmer_len", str(KLEN), "--chunk_len", "500", "--min_length",
             "500", "--jobs", "2", "--overwrite"] + extra
    assert main(argv) == 0
    return out


def _under_launcher(argv):
    """``chunkify`` on two ranks, each started as ``torchrun`` would."""
    return spawn.run(tccli.main, argv, 2, timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("command,extra,main", [
    ("raw_remap", ["--devices", "2"], tccli.main),
    ("raw_identity", [], _under_launcher),
], ids=["raw_remap_devices_2", "raw_identity_launched"])
def test_chunkify_two_ranks_equal_one_process(ws, command, extra, main):
    one = _chunkify(ws, command, "one", [], tccli.main)
    two = _chunkify(ws, command, "two", extra, main)
    a, b = _chunks(one), _chunks(two)
    assert len(a["chunks"]) >= NREADS
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    if command == "raw_remap":
        rows = open(one + ".txt").read()
        assert rows.count("\n") == NREADS + 1
        assert open(two + ".txt").read() == rows


def test_train_ndevice_2(ws):
    """``train --ndevice 2`` trains as one process does and only rank 0
    writes; with a resident chunk set it fails, as the JAX package refuses
    one over several processes."""
    from sloika_tpu_torch import serialize
    chunks = _chunkify(ws, "raw_identity", "train", [], tccli.main)
    argv = ["raw", "raw_0.98_rgrgr", None, chunks, "--niteration", "2",
            "--batch_size", "4", "--chunk_len_range", "1", "1", "--drop",
            "5", "--seed", "2", "--quiet", "--overwrite", "--device", "cpu"]
    finals = []
    for tag, extra in (("one", []), ("two", ["--ndevice", "2"])):
        argv[2] = str(ws / "train.{}".format(tag))
        assert ttcli.main(argv + extra) == 0
        finals.append(serialize.load_checkpoint(
            str(ws / "train.{}".format(tag) / "model_final.npz"))[0])
    log = open(ws / "train.two" / "model.log").read()
    assert "2 ranks, backend gloo, devices rank 0 cpu, rank 1 cpu" in log
    for (n, p), q in zip(finals[0].named_parameters(),
                         finals[1].parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=0, atol=1e-5, err_msg=n)
    argv[2] = str(ws / "train.resident")
    assert ttcli.main(argv + ["--ndevice", "2", "--steps_per_dispatch", "2",
                              "--data_on_device", "on"]) != 0
