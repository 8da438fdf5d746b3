"""Every basecall route and flag of the port against the JAX package (CPU):
non-transducer models with and without a bad state (the host decoder), a
5-letter transducer (the Viterbi's general route on the card), the chunked
"states" route, ``basecall_to_sequences``, and the ``raw`` CLI's flags.

One shared shape: a convolution of stride 5 (1 -> 8), a GRU of 12 and a
softmax over the model's states at kmer length 3, with numpy-made weights
large enough (sd 3 / sqrt(fan-in)) that the posteriors are peaked and
float32 round-off in the two forwards cannot flip a near-tie.  So calls and
FASTA must be identical and scores within 1e-5 relative.  The reads are
written by the port's ``simulate.write_fast5``; both CLIs run in process
through ``main(argv)``.
"""
import jax
import numpy as np
import pytest
import torch

import sloika_tpu.nn as jnn
from sloika_tpu import basecall as jbc
from sloika_tpu import serialize as jser
from sloika_tpu.cli import basecall as jcli
from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch import config
from sloika_tpu_torch import serialize as tser
from sloika_tpu_torch.cli import basecall as tcli
from sloika_tpu_torch.data import simulate
from sloika_tpu_torch.ops import viterbi_kernel as vk

KLEN = 3
NREADS = 3
SCORE_RTOL = 1e-5
CHUNK, OVERLAP = 1000, 100
#: (transducer, bad, alphabet) of each model
MODELS = {"transducer": (True, False, b"ACGT"),
          "nontransducer": (False, False, b"ACGT"),
          "nontransducer_bad": (False, True, b"ACGT"),
          "nbase5": (True, False, b"ACGTX")}


def _nstate(transducer, bad, alphabet):
    return len(alphabet) ** KLEN + (transducer or bad)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("basecall_surface")
    rs = np.random.RandomState(7)
    models = {}
    for name, (transducer, bad, alphabet) in MODELS.items():
        layer = jnn.Serial([
            jnn.Convolution(1, 8, 11, 5, has_bias=True),
            jnn.Gru(8, 12, has_bias=True),
            jnn.Softmax(12, _nstate(transducer, bad, alphabet),
                        has_bias=True),
        ])
        params = jax.tree_util.tree_map(
            lambda a: (3.0 * rs.normal(size=a.shape)
                       / np.sqrt(a.shape[-1])).astype(a.dtype),
            jax.eval_shape(layer.init, jax.random.PRNGKey(0)))
        ckpt = str(tmp / "{}.npz".format(name))
        jser.save_checkpoint(ckpt, layer, params)
        models[name] = (layer, params, ckpt)
    reads = str(tmp / "reads")
    _, files = simulate.simulate_read_set(reads, NREADS, genome_len=20000,
                                          read_len=400, kmer_len=KLEN)
    sigs = [tbc.load_raw_signal(f)[1] for f in sorted(files)]
    return {"models": models, "reads": reads, "sigs": sigs, "tmp": tmp}


def _callers(setup, name, **kw):
    """The JAX and the port's (CPU) Basecaller of one model."""
    transducer, bad, alphabet = MODELS[name]
    layer, params, ckpt = setup["models"][name]
    kw = dict(transducer=transducer, bad=bad, alphabet=alphabet,
              batch_size=2, **kw)
    port = tser.load_checkpoint(ckpt)[0]
    return (jbc.Basecaller(layer, params, KLEN, **kw),
            tbc.Basecaller(port, KLEN, device="cpu", **kw))


def _same_calls(got, ref):
    assert len(got) == len(ref)
    for (s1, c1), (s2, c2) in zip(got, ref):
        assert s1 == pytest.approx(s2, rel=SCORE_RTOL)
        np.testing.assert_array_equal(c1, c2)
        assert len(c1) > 10


@pytest.mark.parametrize("name,chunked", [("nontransducer", False),
                                          ("nontransducer_bad", False),
                                          ("nbase5", False),
                                          ("nbase5", True),
                                          ("transducer", True)])
def test_basecaller_equals_jax(setup, name, chunked):
    """Whole reads of each model, and the chunked "states" route (windows of
    1,000 samples, overlap 100, stitched at their core frames): the same
    calls and scores as the JAX package's.  A non-transducer's calls are
    one state an event, from the host decoder; its scores are the legacy
    decoder's."""
    jax_caller, caller = _callers(setup, name, chunked=chunked,
                                  chunk_size=CHUNK, overlap=OVERLAP)
    assert caller.output == "states" and caller.chunked == chunked
    sigs = setup["sigs"]
    if chunked:
        # several windows a read
        assert all(len(s) > 3 * CHUNK for s in sigs)
    _same_calls(caller.basecall_signals(sigs),
                jax_caller.basecall_signals(sigs))


def test_studentise_nontransducer_equals_jax(setup, tmp_path):
    """A non-transducer with a Studentise layer runs one unpadded read at a
    time and decodes it on the host from the raw posterior
    (``prepare_post``: the bad frames dropped, then the floor), as the JAX
    package's per-read route does (sloika_tpu/basecall.py:445-469)."""
    layer = jnn.Serial([
        jnn.Convolution(1, 8, 11, 5, has_bias=True),
        jnn.Studentise(8),
        jnn.Gru(8, 12, has_bias=True),
        jnn.Softmax(12, 4 ** KLEN + 1, has_bias=True),
    ])
    rs = np.random.RandomState(8)
    params = jax.tree_util.tree_map(
        lambda a: (3.0 * rs.normal(size=a.shape)
                   / np.sqrt(a.shape[-1])).astype(a.dtype),
        jax.eval_shape(layer.init, jax.random.PRNGKey(0)))
    ckpt = str(tmp_path / "studentise.npz")
    jser.save_checkpoint(ckpt, layer, params)
    kw = dict(transducer=False, bad=True, batch_size=2)
    ref = jbc.Basecaller(layer, params, KLEN, **kw).basecall_signals(
        setup["sigs"])
    caller = tbc.Basecaller(tser.load_checkpoint(ckpt)[0], KLEN,
                            device="cpu", **kw)
    assert caller.studentise
    _same_calls(caller.basecall_signals(setup["sigs"]), ref)


def test_nontransducer_posterior_stays_float32(setup, monkeypatch):
    """Under bf16 a transducer's posterior streams at bf16, a
    non-transducer's stays float32 (sloika_tpu/basecall.py:284)."""
    monkeypatch.setattr(config, "compute_dtype", torch.bfloat16)
    _, caller = _callers(setup, "nontransducer_bad")
    assert caller.post_dtype == torch.float32
    _, caller = _callers(setup, "transducer")
    assert caller.post_dtype == torch.bfloat16


@pytest.mark.parametrize("name,chunked", [("nontransducer_bad", False),
                                          ("nbase5", False),
                                          ("transducer", True)])
def test_basecall_to_sequences_equals_jax(setup, name, chunked):
    """Base codes indexing the alphabet, as the JAX package gives them."""
    jax_caller, caller = _callers(setup, name, chunked=chunked,
                                  chunk_size=CHUNK, overlap=OVERLAP)
    got = caller.basecall_to_sequences(setup["sigs"])
    ref = jax_caller.basecall_to_sequences(setup["sigs"])
    for (s1, c1), (s2, c2) in zip(got, ref):
        assert s1 == pytest.approx(s2, rel=SCORE_RTOL)
        assert c1.dtype == np.uint8
        np.testing.assert_array_equal(c1, c2)
        assert c1.max() < len(MODELS[name][2])


def test_basecall_to_sequences_of_the_bases_route(setup):
    """In "bases" mode the codes are the route's own output."""
    caller = tbc.Basecaller(
        tser.load_checkpoint(setup["models"]["transducer"][2])[0], KLEN,
        chunked=True, output="bases", chunk_size=CHUNK, overlap=OVERLAP,
        device="cpu")
    assert caller.chunked
    got = caller.basecall_to_sequences(setup["sigs"])
    ref = caller.basecall_signals(setup["sigs"])
    for (s1, c1), (s2, c2) in zip(got, ref):
        assert s1 == s2
        np.testing.assert_array_equal(c1, c2)


def test_a_failed_read_gives_none(setup, monkeypatch):
    """Per-read fault masking of the one-read-at-a-time route
    (sloika_tpu/basecall.py:466-468): a read that fails gives None, the
    others their calls."""
    _, caller = _callers(setup, "nontransducer_bad")
    good = caller._call_one_read
    calls = []

    def flaky(s):
        calls.append(len(calls))
        if len(calls) == 2:
            raise RuntimeError("bad read")
        return good(s)

    monkeypatch.setattr(caller, "_call_one_read", flaky)
    out = caller._basecall_per_read(setup["sigs"])
    assert out[1] is None and out[0] is not None and out[2] is not None


@pytest.mark.parametrize("name,kw,error", [
    ("nontransducer", dict(chunked=True, output="bases", transducer=False),
     "requires chunked"),
    ("nbase5", dict(chunked=True, output="bases", alphabet=b"ACGTX"),
     "requires chunked"),
    ("transducer", dict(output="bases", chunked=False), "requires chunked"),
    ("transducer", dict(transducer=False), "model emits"),
    ("transducer", dict(alphabet=b"ACGTX"), "model emits")])
def test_basecaller_refuses_what_the_jax_package_asserts(setup, name, kw,
                                                         error):
    layer = tser.load_checkpoint(setup["models"][name][2])[0]
    with pytest.raises(ValueError, match=error):
        tbc.Basecaller(layer, KLEN, device="cpu", **kw)


def test_decode_post_host_refuses_modified_bases_for_the_old_decoder():
    post = np.full((5, 1, 5 ** KLEN), 1.0 / 5 ** KLEN, np.float32)
    with pytest.raises(ValueError, match="Modified bases"):
        tbc.decode_post_host(post, KLEN, False, 1e-5, nbase=5)


#: (model, extra CLI arguments) of each CLI case
CLI_CASES = {
    "nontransducer_bad": ("nontransducer_bad", ["--no-transducer", "--bad"]),
    "nontransducer": ("nontransducer", ["--no-transducer"]),
    "alphabet": ("nbase5", ["--alphabet", "ACGTX"]),
    "chunked_states": ("transducer", ["--chunked", "--device_collapse", "off",
                                      "--chunk_size", str(CHUNK),
                                      "--overlap", str(OVERLAP)]),
    "chunked_dac": ("transducer", ["--chunked", "--device_collapse", "on",
                                   "--dac", "on", "--chunk_size", str(CHUNK),
                                   "--overlap", str(OVERLAP)]),
    "chunked_bases_host": ("transducer", [
        "--chunked", "--device_collapse", "on", "--dac", "off",
        "--chunk_size", str(CHUNK), "--overlap", str(OVERLAP)]),
}


def _cli_argv(setup, case):
    name, extra = CLI_CASES[case]
    return ["raw", setup["models"][name][2], setup["reads"], "--kmer_len",
            str(KLEN), "--batch", "2"] + extra


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_raw_cli_fasta_equals_jax(setup, case):
    """The port's ``raw`` CLI on the CPU writes the JAX CLI's FASTA for each
    flag set; ``--jobs 1`` and ``--jobs 3`` give the same file."""
    argv = _cli_argv(setup, case)
    tmp = setup["tmp"]
    jout = str(tmp / "{}.jax.fa".format(case))
    assert jcli.main(argv + ["--output", jout]) == 0
    outs = []
    for jobs in (1, 3):
        tout = str(tmp / "{}.port{}.fa".format(case, jobs))
        assert tcli.main(argv + ["--device", "cpu", "--jobs", str(jobs),
                                 "--output", tout]) == 0
        outs.append(open(tout).read())
    jax_fa = open(jout).read()
    assert outs[0].count(">") == NREADS
    assert outs[0] == outs[1] == jax_fa


def test_raw_cli_parser_matches_jax(setup):
    """The new flags take the JAX CLI's defaults and choices."""
    argv = ["raw", setup["models"]["transducer"][2], setup["reads"]]
    ours = vars(tcli.make_parser().parse_args(argv))
    ref = vars(jcli.make_parser().parse_args(argv))
    for key in ("alphabet", "bad", "transducer", "trans", "device_collapse",
                "dac", "jobs"):
        assert ours[key] == ref[key], key
    extra = ["--trans", "0.3", "0.6", "0.1", "--alphabet", "ACGTX",
             "--device_collapse", "off", "--dac", "on", "--jobs", "2"]
    ours = vars(tcli.make_parser().parse_args(argv + extra))
    ref = vars(jcli.make_parser().parse_args(argv + extra))
    for key in ("alphabet", "trans", "device_collapse", "dac", "jobs"):
        assert ours[key] == ref[key], key
    with pytest.raises(SystemExit):
        tcli.make_parser().parse_args(argv + ["--dac", "maybe"])


def test_raw_cli_dac_on_needs_device_collapse(setup):
    """``--dac on`` without device collapse is refused, as the JAX CLI's
    assert does (sloika_tpu/cli/basecall.py:175-180)."""
    argv = _cli_argv(setup, "chunked_states") + ["--dac", "on", "--device",
                                                 "cpu"]
    with pytest.raises(ValueError, match="--dac on"):
        tcli.main(argv)


def test_raw_cli_device_collapse_auto_follows_the_device(setup, monkeypatch):
    """"auto" collapses on the device for a chunked 4-letter transducer on a
    CUDA device (where the JAX package's TPU stands) and stitches states on
    the CPU."""
    seen = []
    real = tbc.Basecaller

    def spy(*args, **kw):
        seen.append((kw["output"], kw["chunked"]))
        if kw.get("device") != "cpu":
            raise RuntimeError("stop here")
        return real(*args, **kw)

    monkeypatch.setattr(tbc, "Basecaller", spy)
    # "cuda" resolves without a card here; the spy stops before any launch
    monkeypatch.setattr(config, "resolve_device", torch.device)
    argv = ["raw", setup["models"]["transducer"][2], setup["reads"],
            "--kmer_len", str(KLEN), "--chunked", "--chunk_size", str(CHUNK),
            "--overlap", str(OVERLAP),
            "--output", str(setup["tmp"] / "auto.fa")]
    with pytest.raises(RuntimeError, match="stop here"):
        tcli.main(argv + ["--device", "cuda"])
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    with pytest.raises(RuntimeError, match="stop here"):
        tcli.main(argv + ["--device", "cuda", "--alphabet", "ACGTX"])
    assert seen == [("bases", True), ("states", True), ("states", True)]


def test_viterbi_general_plan_at_nbase_5_klen_5():
    """The 5-letter transducer's shape (K = 3,125, whole reads in batches of
    8) takes the general route: 125 skip groups, so no cluster of 2-16
    blocks divides them and a row is one block of 640 threads, its arrays
    in shared memory with a ring of 8 slots of one row each."""
    K = 5 ** 5
    assert vk.kernel_route(K, 5, 5) == "general"
    plan = vk.viterbi_general_plan(8, K, 5)
    assert plan == {"C": 1, "threads": 640, "shared": True, "nslots": 8,
                    "slot_bytes": 12528, "work_floats": 0, "smem": 125376}
    assert plan["slot_bytes"] >= 4 * (K + 1)
    assert plan["smem"] <= vk.SMEM_OPTIN
    # one wave: the card runs 132 clusters of one block
    assert 8 <= vk.H100_CLUSTERS[1]
    # the bf16 posterior halves the slots
    plan16 = vk.viterbi_general_plan(8, K, 5, esize=2)
    assert plan16["C"] == 1 and plan16["slot_bytes"] < plan["slot_bytes"]


# ---------------------------------------------------------------------------
# The ``events`` CLI: the same models over 4 event features (a convolution
# of 4 -> 8 in place of 1 -> 8), on copies of the reads given an event
# table (the mapping table's blocks, with a seeded spread)
# ---------------------------------------------------------------------------

EVENTS = "Analyses/Basecall_1D_000/BaseCalled_template/Events"
MAPPING = "Analyses/AlignToRef_000/CurrentSpaceMapped_template/Events"


@pytest.fixture(scope="module")
def event_setup(setup):
    import glob
    import shutil
    import h5py
    tmp = setup["tmp"]
    reads = str(tmp / "event_reads")
    shutil.copytree(setup["reads"], reads)
    rs = np.random.RandomState(17)
    for f in sorted(glob.glob(reads + "/*.fast5")):
        with h5py.File(f, "r+") as h5:
            mt = h5[MAPPING][:]
            ev = np.zeros(len(mt), dtype=[("mean", "f8"), ("stdv", "f8"),
                                          ("start", "f8"), ("length", "f8")])
            ev["mean"] = mt["mean"] + 0.05 * rs.normal(size=len(mt))
            ev["stdv"] = rs.uniform(0.5, 3.0, size=len(mt))
            ev["start"], ev["length"] = mt["start"], mt["length"]
            h5[EVENTS] = ev
    models = {}
    for name, (transducer, bad, alphabet) in MODELS.items():
        layer = jnn.Serial([
            jnn.Convolution(4, 8, 11, 5, has_bias=True),
            jnn.Gru(8, 12, has_bias=True),
            jnn.Softmax(12, _nstate(transducer, bad, alphabet),
                        has_bias=True),
        ])
        params = jax.tree_util.tree_map(
            lambda a: (3.0 * rs.normal(size=a.shape)
                       / np.sqrt(a.shape[-1])).astype(a.dtype),
            jax.eval_shape(layer.init, jax.random.PRNGKey(0)))
        ckpt = str(tmp / "events_{}.npz".format(name))
        jser.save_checkpoint(ckpt, layer, params)
        models[name] = ckpt
    return {"models": models, "reads": reads, "tmp": tmp}


#: (model, extra CLI arguments) of each events CLI case
EVENT_CASES = {
    "nontransducer": ("nontransducer", ["--no-transducer"]),
    "nontransducer_bad": ("nontransducer_bad", ["--no-transducer", "--bad"]),
    "alphabet": ("nbase5", ["--alphabet", "ACGTX"]),
    "chunked_states": ("transducer", ["--chunked", "--device_collapse", "off",
                                      "--chunk_size", "200", "--overlap",
                                      "40"]),
    "chunked_states_alphabet": ("nbase5", [
        "--chunked", "--device_collapse", "off", "--alphabet", "ACGTX",
        "--chunk_size", "200", "--overlap", "40"]),
}


@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_events_cli_fasta_equals_jax(event_setup, case):
    """The port's ``events`` CLI on the CPU writes the JAX CLI's FASTA for
    each flag set; ``--jobs 1`` and ``--jobs 3`` give the same file."""
    name, extra = EVENT_CASES[case]
    argv = ["events", event_setup["models"][name], event_setup["reads"],
            "--kmer_len", str(KLEN), "--batch", "2", "--trim", "5",
            "5"] + extra
    tmp = event_setup["tmp"]
    jout = str(tmp / "events_{}.jax.fa".format(case))
    assert jcli.main(argv + ["--output", jout]) == 0
    outs = []
    for jobs in (1, 3):
        tout = str(tmp / "events_{}.port{}.fa".format(case, jobs))
        assert tcli.main(argv + ["--device", "cpu", "--jobs", str(jobs),
                                 "--output", tout]) == 0
        outs.append(open(tout).read())
    jax_fa = open(jout).read()
    assert outs[0].count(">") == NREADS
    assert outs[0] == outs[1] == jax_fa
