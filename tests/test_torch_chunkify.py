"""The chunkify subcommands ``identity``, ``raw_identity`` and ``remap`` of
the port against the JAX package's CLI (CPU), run in process through
``main(argv)``, and the parser's flags.

One shared shape: reads from ``sloika_tpu.data.simulate.simulate_read_set``
(kmer length 3), each copy given a ``Basecall_1D_000/BaseCalled_template/
Events`` table (the mapping table's blocks, with a seeded spread) for
``remap``, and a seeded ``baseline_lstm`` event transducer (size 16, klen 3)
carried to the port through a model JSON.  Its weights are large (sd 3 /
sqrt(fan-in)), so the posteriors are peaked and the two forwards' float32
round-off cannot flip a path.  Chunks, labels, bad flags, weights and attrs
must be equal; strand lists equal but the score column, within 1e-5 (as in
tests/test_torch_remap_cli.py).  A malformed read in each subcommand's
input is reported and skipped by both packages alike.
"""
import os
import shutil

import h5py
import jax
import numpy as np
import pytest

from sloika_tpu import serialize as jser
from sloika_tpu.cli import chunkify as jcli
from sloika_tpu.data import simulate
from sloika_tpu.models import network_factory as jfactory
from sloika_tpu_torch.cli import chunkify as tcli

KLEN, SIZE = 3, 16
NREADS = 4
SCORE_RTOL = 1e-5
EVENTS = "Analyses/Basecall_1D_000/BaseCalled_template/Events"
MAPPING = "Analyses/AlignToRef_000/CurrentSpaceMapped_template/Events"


def _add_events(path, seed):
    """The read's event table: the mapping table's blocks with a seeded
    spread (the simulator writes stdv 0)."""
    rs = np.random.RandomState(seed)
    with h5py.File(path, "r+") as h5:
        mt = h5[MAPPING][:]
        ev = np.zeros(len(mt), dtype=[("mean", "f8"), ("stdv", "f8"),
                                      ("start", "f8"), ("length", "f8")])
        ev["mean"] = mt["mean"] + 0.05 * rs.normal(size=len(mt))
        ev["stdv"] = rs.uniform(0.5, 3.0, size=len(mt))
        ev["start"] = mt["start"]
        ev["length"] = mt["length"]
        h5[EVENTS] = ev


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("chunkify")
    reads = str(root / "reads")
    _, files = simulate.simulate_read_set(reads, NREADS, genome_len=20000,
                                          read_len=400, kmer_len=KLEN)
    with open(root / "refs.fa", "w") as fh:
        for i, f in enumerate(sorted(files)):
            _add_events(f, i)
            with h5py.File(f, "r") as h5:
                fasta = h5["Analyses/Alignment_000/Aligned_template/Fasta"][()]
            fh.write(fasta.decode() if isinstance(fasta, bytes) else fasta)
    # the malformed reads: a copy whose mapping table holds a letter outside
    # the alphabet, and one with no mapping table and no events
    bad = str(root / "bad_reads")
    shutil.copytree(reads, bad)
    foreign = os.path.join(bad, "synth_0100.fast5")
    shutil.copy(sorted(files)[0], foreign)
    with h5py.File(foreign, "r+") as h5:
        mt = h5[MAPPING][:]
        mt["kmer"][len(mt) // 2] = b"N" * KLEN
        del h5[MAPPING]
        h5[MAPPING] = mt
    empty = os.path.join(bad, "synth_0101.fast5")
    shutil.copy(sorted(files)[1], empty)
    with h5py.File(empty, "r+") as h5:
        del h5["Analyses"]
    layer = jfactory("baseline_lstm")(klen=KLEN, sd=0.5, size=SIZE)
    rs = np.random.RandomState(7)
    params = jax.tree_util.tree_map(
        lambda s: (3.0 * rs.normal(size=s.shape)
                   / np.sqrt(s.shape[-1])).astype(s.dtype),
        jax.eval_shape(layer.init, jax.random.PRNGKey(0)))
    jser.save_model_json(str(root / "model.json"), layer, params)
    return root


#: each subcommand's arguments beyond input and output
ARGS = {
    "identity": ["--chunk_len", "100", "--min_length", "200", "--trim", "5",
                 "5"],
    "raw_identity": ["--chunk_len", "500", "--min_length", "500"],
    "remap": ["--chunk_len", "100", "--min_length", "200", "--trim", "5",
              "5", "--batch", "2"],
}


def _run(main, root, command, reads, tag, extra=()):
    out = str(root / "{}.{}.hdf5".format(command, tag))
    argv = [command, str(root / reads), out]
    if command == "remap":
        strands = str(root / "{}.{}.txt".format(command, tag))
        argv += [str(root / "model.json"), str(root / "refs.fa"),
                 "--output_strand_list", strands]
    argv += ["--kmer_len", str(KLEN), "--jobs", "2", "--overwrite"]
    assert main(argv + ARGS[command] + list(extra)) == 0
    with h5py.File(out, "r") as h5:
        data = {k: h5[k][:] for k in ("chunks", "labels", "bad", "weights")}
        data["attrs"] = dict(h5["/"].attrs)
    rows = None
    if command == "remap":
        with open(strands) as fh:
            rows = [line.rstrip("\n").split("\t") for line in fh]
    return data, rows


def _same(got, ref):
    (gd, grows), (rd, rrows) = got, ref
    for k in ("chunks", "labels", "bad", "weights"):
        np.testing.assert_array_equal(gd[k], rd[k], err_msg=k)
    assert len(gd["chunks"]) > 0
    assert set(gd["attrs"]) == set(rd["attrs"])
    for k, v in rd["attrs"].items():
        np.testing.assert_array_equal(gd["attrs"][k], v, err_msg=k)
    if rrows is not None:
        assert len(grows) == len(rrows)
        assert grows[0] == rrows[0]
        for g, r in zip(grows[1:], rrows[1:]):
            assert g[:2] + g[3:] == r[:2] + r[3:]
            assert float(g[2]) == pytest.approx(float(r[2]), rel=SCORE_RTOL)


@pytest.mark.parametrize("command", sorted(ARGS))
def test_chunkify_matches_jax(workspace, command):
    extra = ["--device", "cpu"] if command == "remap" else []
    ref = _run(jcli.main, workspace, command, "reads", "jax")
    got = _run(tcli.main, workspace, command, "reads", "torch", extra)
    _same(got, ref)
    if command == "remap":
        assert len(got[1]) == NREADS + 1


@pytest.mark.parametrize("command", sorted(ARGS))
def test_chunkify_skips_malformed_reads_as_jax(workspace, command, capfd):
    """A mapping table with a letter outside the alphabet (identity and
    raw_identity fail to chunk it; remap finds no reference for its name)
    and a file with no analyses (no mapping table, no events) are reported
    on stderr and skipped; the run goes on, and its outputs are the JAX
    package's and those of the reads without them."""
    extra = ["--device", "cpu"] if command == "remap" else []
    ref = _run(jcli.main, workspace, command, "bad_reads", "jax_bad")
    capfd.readouterr()
    got = _run(tcli.main, workspace, command, "bad_reads", "torch_bad",
               extra)
    err = capfd.readouterr().err
    _same(got, ref)
    assert "synth_0101" in err and "synth_0100" in err
    clean = _run(tcli.main, workspace, command, "reads", "torch_clean",
                 extra)
    _same(got, clean)


#: strings each flag's type is applied to
PROBES = ("0", "1", "2", "-1", "0.5", "2.5", "100", "None", "ACGT", "x")


def _flag_table(parser):
    """{subcommand: {dest: (default, nargs, choices, type's results on
    PROBES, action's class name)}}"""
    table = {}
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    for name, p in sub.choices.items():
        flags = {}
        for a in p._actions:
            if a.dest == "help":
                continue
            probed = None
            if a.type is not None:
                probed = []
                for s in PROBES:
                    try:
                        probed.append(repr(a.type(s)))
                    except Exception as e:
                        probed.append(type(e).__name__)
            flags[a.dest] = (a.default, a.nargs, a.choices, probed,
                             a.__class__.__name__.split("_")[0]
                             if a.dest != "version" else "version")
        table[name] = flags
    return table


def test_parser_flags_equal_jax():
    """Every flag of every subcommand takes the JAX parser's default, type
    (its results on probe strings), nargs and choices, ``--devices`` of the
    remap subcommands among them; the port adds ``--device`` to those."""
    ours = _flag_table(tcli.make_parser())
    ref = _flag_table(jcli.make_parser())
    assert set(ours) == set(ref) == {"identity", "remap", "raw_identity",
                                     "raw_remap"}
    for name in ref:
        port_only = {"device"} if "remap" in name else set()
        assert set(ours[name]) == set(ref[name]) | port_only, name
        for dest, row in ref[name].items():
            assert ours[name][dest][:4] == row[:4], (name, dest)
    assert ours["remap"]["device"][0] == "cuda"


def test_remap_flags_parse_as_jax(workspace):
    argv = ["remap", str(workspace / "reads"), "out.hdf5", "model.json",
            str(workspace / "refs.fa"), "--section", "complement",
            "--use_scaled", "--segmentation", "Seg_2", "--slip", "None",
            "--prior", "None", "3"]
    ours = vars(tcli.make_parser().parse_args(argv))
    ref = vars(jcli.make_parser().parse_args(argv))
    for key, v in ref.items():
        if key != "command_action":
            assert ours[key] == v, key
