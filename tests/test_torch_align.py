"""The port's scoring tools against the JAX package's (CPU): the native
aligner (the port's own g++ build) and its numpy fallbacks, the per-read
metric rows and the summary, the SAM parser, ``get_refs_from_sam``, and the
``extract_reference`` and ``align`` CLIs' files.

One shared shape: 6 reads of 400 bases simulated by the port, and calls
made from their references with planted errors (a 5% mix of substitutions,
insertions and deletions, numpy seeded; one reverse-complemented, one too
short to map, one unrelated).  Both packages' aligners are the same C++
code, so every row, report and file must be identical.
"""
import io
import os

import numpy as np
import pytest

from sloika_tpu import align as jalign
from sloika_tpu import native as jnative
from sloika_tpu.cli import align as jcli_align
from sloika_tpu.cli import extract_reference as jcli_extract
from sloika_tpu.cli import get_refs_from_sam as jcli_refs
from sloika_tpu.data import sam as jsam
from sloika_tpu_torch import align as talign
from sloika_tpu_torch import bio, native
from sloika_tpu_torch.cli import align as tcli_align
from sloika_tpu_torch.cli import extract_reference as tcli_extract
from sloika_tpu_torch.cli import get_refs_from_sam as tcli_refs
from sloika_tpu_torch.data import fast5, sam as tsam
from sloika_tpu_torch.data import simulate

NREADS = 6
ERROR_RATE = 0.05


def mutate(seq, rs, rate=ERROR_RATE):
    """``seq`` with substitutions, insertions and deletions at ``rate``."""
    out = []
    for c in seq:
        u = rs.uniform()
        if u < rate / 3:
            out.append(rs.choice([b for b in "ACGT" if b != c]))
        elif u < 2 * rate / 3:
            out += [c, rs.choice(list("ACGT"))]
        elif u >= rate:
            out.append(c)
    return "".join(out)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("align")
    reads = str(tmp / "reads")
    genome, files = simulate.simulate_read_set(reads, NREADS,
                                               genome_len=20000,
                                               read_len=400)
    refs = {fast5.filename_short(f): fast5.read_reference_fasta(f).decode()
            for f in files}
    rs = np.random.RandomState(17)
    names = sorted(refs)
    calls = {n: mutate(refs[n], rs) for n in names}
    calls[names[1]] = bio.reverse_complement(calls[names[1]])
    calls[names[2]] = calls[names[2]][:10]                  # too short
    calls[names[3]] = simulate.random_genome(400, seed=99).decode()
    return {"tmp": tmp, "reads": reads, "refs": refs, "calls": calls,
            "genome": genome.decode()}


def test_the_port_builds_its_own_library():
    assert native.available()
    assert os.path.exists(native._LIB)
    assert "sloika_tpu_torch" in native._LIB
    assert not native._LIB.startswith(os.path.dirname(jnative._LIB))


@pytest.mark.parametrize("scoring", [(1, -1, -2, -1), (2, -3, 0, -4),
                                     (5, -4, -10, -1)])
def test_align_semiglobal_scoring_equals_jax(setup, scoring):
    """The port's build bit-equal to the JAX package's under other match,
    mismatch, gap-open and gap-extend scores, banded and widened."""
    match, mismatch, gap_open, gap_extend = scoring
    for name, call in setup["calls"].items():
        ref = setup["refs"][name]
        for band in (None, 24):
            kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
                      gap_extend=gap_extend, band=band, auto_widen=True)
            a = native.align_semiglobal(call, ref, **kw)
            b = jnative.align_semiglobal(call, ref, **kw)
            assert (a is None) == (b is None)
            if a is not None:
                assert [getattr(a, f) for f in a.__slots__] == \
                    [getattr(b, f) for f in b.__slots__]


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
def test_the_build_against_its_numpy_fallback(seed, monkeypatch):
    """With no gap-open cost the C++ kernel's affine gaps are the fallback's
    linear ones: the same optimal score, and on a substitution-only pair
    the same counts and spans."""
    rs = np.random.RandomState(seed)
    ref = simulate.random_genome(300, seed=seed).decode()
    query = mutate(ref[50:250], rs, rate=0.1)
    subs = "".join(c if rs.uniform() > 0.1 else "ACGT"[(("ACGT".index(c))
                                                      + 1) % 4]
                   for c in ref[40:240])
    kw = dict(match=2, mismatch=-2, gap_open=0, gap_extend=-3)
    built = [native.align_semiglobal(q, ref, auto_widen=True, **kw)
             for q in (query, subs)]
    monkeypatch.setattr(native, "_lib", False)
    assert not native.available()
    twins = [native.align_semiglobal(q, ref, auto_widen=True, **kw)
             for q in (query, subs)]
    assert built[0].score == twins[0].score
    fields = ("score", "match", "mismatch", "insertion", "deletion",
              "qstart", "qend", "rstart", "rend")
    assert [getattr(built[1], f) for f in fields] == \
        [getattr(twins[1], f) for f in fields]


def test_align_semiglobal_equals_jax(setup):
    for name, call in setup["calls"].items():
        ref = setup["refs"][name]
        for widen in (False, True):
            for band in (None, 16):
                a = native.align_semiglobal(call, ref, band=band,
                                            auto_widen=widen)
                b = jnative.align_semiglobal(call, ref, band=band,
                                             auto_widen=widen)
                assert (a is None) == (b is None)
                if a is not None:
                    assert [getattr(a, f) for f in a.__slots__] == \
                        [getattr(b, f) for f in b.__slots__]
    assert native.default_band(400, 1000) == jnative.default_band(400, 1000)
    assert native.widen_cap(10 ** 6, 10) == jnative.widen_cap(10 ** 6, 10)


@pytest.mark.parametrize("genome", (False, True))
def test_evaluate_basecalls_equals_jax(setup, genome):
    """Per-read rows against per-read records, and in genome mode against
    the genome's one contig and an unrelated one; the reverse-complemented
    call maps to '-', the short one does not map, and the unrelated one maps
    (a semiglobal alignment covers the whole call) at a low accuracy."""
    refs = ({"chr": setup["genome"],
             "junk": simulate.random_genome(2000, seed=5).decode()}
            if genome else setup["refs"])
    got = talign.evaluate_basecalls(setup["calls"], refs, genome=genome)
    ref = jalign.evaluate_basecalls(setup["calls"], refs, genome=genome)
    assert got == ref
    assert len(got) == NREADS - 1
    assert {r["strand"] for r in got} == {"+", "-"}
    unrelated = sorted(setup["calls"])[3]
    assert all((r["accuracy"] > 0.85) == (r["query"] != unrelated)
               for r in got)
    assert talign.summary(got, "set") == jalign.summary(ref, "set")
    assert talign.summary([], "none") == jalign.summary([], "none")


def test_local_alignment_equals_jax(setup):
    for name, call in list(setup["calls"].items())[:3]:
        ref = setup["refs"][name]
        assert talign.local_alignment_counts(call, ref) == \
            jalign.local_alignment_counts(call, ref)
        assert talign.local_accuracy_metrics(name, call, name, ref) == \
            jalign.local_accuracy_metrics(name, call, name, ref)


def test_write_samacc_and_plot(setup, tmp_path):
    rows = talign.evaluate_basecalls(setup["calls"], setup["refs"])
    talign.write_samacc(str(tmp_path / "port.samacc"), rows)
    jalign.write_samacc(str(tmp_path / "jax.samacc"), rows)
    assert open(tmp_path / "port.samacc").read() == \
        open(tmp_path / "jax.samacc").read()
    assert talign.save_acc_plot(str(tmp_path / "acc.png"), rows)
    assert os.path.getsize(tmp_path / "acc.png") > 0
    assert not talign.save_acc_plot(str(tmp_path / "none.png"), [])


SAM = ("@HD\tVN:1.6\n@SQ\tSN:chr\tLN:20000\n"
       "r1\t0\tchr\t101\t60\t5S90M2I3D100M4S\t*\t0\t0\t*\t*\tNM:i:7\n"
       "r2\t16\tchr\t5001\t60\t3H150M\t*\t0\t0\t*\t*\tAS:i:280\tXF:f:0.5\n"
       "r3\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*\n"
       "r4\t0\tchr\t9001\t60\t10S20M170S\t*\t0\t0\t*\t*\n"
       "short\t0\tchr\n")


def test_sam_parser_equals_jax():
    props = ("qname", "flag", "rname", "pos", "mapq", "cigar", "seq", "tags",
             "query_length", "query_alignment_start", "query_alignment_end",
             "query_alignment_length", "reference_start", "reference_end")
    got = list(tsam.read_sam(io.StringIO(SAM)))
    ref = list(jsam.read_sam(io.StringIO(SAM)))
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert [getattr(a, p) for p in props] == [getattr(b, p) for p in props]
        assert a.cigar_bins() == b.cigar_bins()
    assert got[0].tags == {"NM": 7} and got[1].tags["XF"] == 0.5


def test_get_refs_from_sam_equals_jax(setup, tmp_path, capsys):
    sam_path = str(tmp_path / "reads.sam")
    with open(sam_path, "w") as fh:
        fh.write(SAM)
    genome = {"chr": setup["genome"]}
    got = list(tcli_refs.get_refs(sam_path, genome, 0.6, 50))
    ref = list(jcli_refs.get_refs(sam_path, genome, 0.6, 50))
    assert got == ref and [n for n, _ in got] == ["r1.fast5", "r2.fast5"]
    fa = str(tmp_path / "genome.fa")
    with open(fa, "w") as fh:
        fh.write(">chr\n{}\n".format(setup["genome"]))
    outs = []
    for cli, tag in ((tcli_refs, "port"), (jcli_refs, "jax")):
        strands = str(tmp_path / "{}.txt".format(tag))
        assert cli.main([fa, sam_path, "--output_strand_list",
                         strands]) == 0
        outs.append((capsys.readouterr().out, open(strands).read()))
    assert outs[0] == outs[1]
    assert outs[0][0].count(">") == 2


def test_extract_reference_and_align_clis_equal_jax(setup, tmp_path):
    """extract_reference's FASTA, then align's .samacc and .summary (and its
    report on stdout) on calls against them: the same files from both
    packages."""
    fas = {}
    for cli, tag in ((tcli_extract, "port"), (jcli_extract, "jax")):
        fas[tag] = str(tmp_path / "{}_refs.fa".format(tag))
        assert cli.main([setup["reads"], "--output", fas[tag],
                         "--jobs", "3"]) == 0
    text = open(fas["port"]).read()
    assert text == open(fas["jax"]).read() and text.count(">") == NREADS
    for name, seq in setup["refs"].items():
        assert ">{}\n{}\n".format(name, seq) in text

    files = {}
    for tag in ("port", "jax"):
        os.makedirs(str(tmp_path / tag))
        files[tag] = str(tmp_path / tag / "calls.fa")
        with open(files[tag], "w") as fh:
            for name, seq in setup["calls"].items():
                fh.write(">{}\n{}\n".format(name, seq))
    argv = ["--reference", fas["port"], "--data_set_name", "sim"]
    assert tcli_align.main(argv + [files["port"]]) == 0
    assert jcli_align.main(argv + [files["jax"]]) == 0
    for ext in (".samacc", ".summary"):
        port = open(files["port"].replace(".fa", ext)).read()
        assert port == open(files["jax"].replace(".fa", ext)).read()
    assert "Number of mapped reads:  {}".format(NREADS - 1) in open(
        files["port"].replace(".fa", ".summary")).read()


def test_extract_reference_skips_a_file_without_one(setup, tmp_path, capsys):
    assert tcli_extract.reference_extraction_worker(
        str(tmp_path / "missing.fast5"), "template") is None
    assert "Failure reading reference" in capsys.readouterr().err
