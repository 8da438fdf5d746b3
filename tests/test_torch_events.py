"""The port's event basecall path against the JAX package (CPU): event
tables from fast5 files, their feature matrices, whole-read basecalling in
"states" mode with ``baseline_lstm`` (size 16, klen 3: 65 states), the
FASTA writer, and the ``events`` CLI.

The JAX ``Basecaller(chunked=False)`` pads each batch to a bucketed length
(>= 2,048 frames) and a power-of-two batch; the port runs each batch at its
own size.  A padded frame is a one-hot stay, which adds nothing to the
score and leaves the path alone, so the calls must be the same: scores
within 1e-5 relative (float32 forwards summed in another order), FASTA
identical.  At these seeds no random-weight near-tie flips a call; where
one did, the decoders' agreement on one posterior is held bit for bit by
``tests/test_torch_viterbi.py``.
"""
import io
import os

import h5py
import jax
import numpy as np
import pytest

from sloika_tpu import basecall as jbc
from sloika_tpu.data import features as jfeatures
from sloika_tpu.data.fast5 import Fast5
from sloika_tpu.models import network_factory as jfactory
from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch import models as tmodels
from sloika_tpu_torch import serialize as tser
from sloika_tpu_torch.cli import basecall as tcli
from sloika_tpu_torch.data import features as tfeatures
from sloika_tpu_torch.data.fast5 import read_section_events

KLEN, SIZE = 3, 16
EVENTS = "Analyses/Basecall_1D_{:03d}/BaseCalled_{}/Events"


def event_table(n, seed):
    """A seeded event table: levels around 90 pA, a spread, a duration."""
    rs = np.random.RandomState(seed)
    ev = np.zeros(n, dtype=[("mean", "f8"), ("stdv", "f8"),
                            ("start", "f8"), ("length", "f8")])
    ev["mean"] = 90 + 12 * rs.normal(size=n)
    ev["stdv"] = rs.uniform(0.5, 3.0, size=n)
    ev["length"] = rs.geometric(0.1, size=n) / 4000.0
    ev["start"] = np.cumsum(ev["length"])
    return ev


def write_event_fast5(path, ev, section="template"):
    """A fast5 file with an older, shorter analysis beside the table the
    readers must take (the latest Basecall_1D)."""
    with h5py.File(path, "w") as h5:
        h5[EVENTS.format(0, section)] = ev[:10]
        h5[EVENTS.format(1, section)] = ev


def _seeded_params(layer, seed):
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(layer.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (0.5 * rs.normal(size=s.shape)
                   / np.sqrt(s.shape[-1])).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def models():
    """(JAX layer, its params, the port's model with the same weights)"""
    layer = jfactory("baseline_lstm")(klen=KLEN, sd=0.5, size=SIZE)
    params = _seeded_params(layer, 7)
    port = tmodels.network_factory("baseline_lstm")(klen=KLEN, sd=0.5,
                                                    size=SIZE)
    port.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return layer, params, port


def test_event_reader_and_features_match_jax(tmp_path):
    path = str(tmp_path / "read.fast5")
    write_event_fast5(path, event_table(300, 0))
    with Fast5(path) as f5:
        ref = f5.get_section_events("template")
    got = read_section_events(path, "template")
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert len(got) == 300
    for kw in ({"tag": ""}, {"tag": "", "nanonet": True},
               {"tag": "", "normalise": False}):
        assert np.array_equal(tfeatures.from_events(got, **kw),
                              jfeatures.from_events(ref, **kw))
    assert tbc.load_event_features(path)[1].shape == (240, 4)
    with pytest.raises(ValueError, match="complement"):
        read_section_events(path, "complement")


def _fasta(printer_cls, results, names, lens, **kw):
    fh = io.StringIO()
    printer = printer_cls(fh=fh, **kw)
    for name, (score, call), n in zip(names, results, lens):
        printer.write(name, score, call, n)
    return fh.getvalue()


def test_states_basecall_matches_jax(models):
    layer, params, port = models
    rs = np.random.RandomState(11)
    lens = [240, 61, 173, 300, 97, 128]
    sigs = [rs.normal(size=(n, 4)).astype(np.float32) for n in lens]
    ref = jbc.Basecaller(layer, params, KLEN, batch_size=4).basecall_signals(
        sigs)
    got = tbc.Basecaller(port, KLEN, batch_size=4, output="states",
                         device="cpu").basecall_signals(sigs)
    for (gs, gc), (rs_, rc) in zip(got, ref):
        assert gs == pytest.approx(rs_, rel=1e-5)
        assert np.array_equal(gc, rc)
    names = ["read{}".format(i) for i in range(len(sigs))]
    assert _fasta(tbc.SeqPrinter, got, names, lens, datatype="events",
                  kmer_len=KLEN) == \
        _fasta(jbc.SeqPrinter, ref, names, lens, kmer_len=KLEN,
               transducer=True)


def test_events_cli_writes_the_in_process_fasta(models, tmp_path):
    _, _, port = models
    reads = tmp_path / "reads"
    reads.mkdir()
    for i, n in enumerate((260, 150)):
        write_event_fast5(str(reads / "read{}.fast5".format(i)),
                          event_table(n, 20 + i))
    model = str(tmp_path / "model.json")
    tser.save_model_json(model, port)
    out = str(tmp_path / "calls.fa")
    assert tcli.main(["events", model, str(reads), "--device", "cpu",
                      "--kmer_len", str(KLEN), "--output", out]) == 0
    loaded = [tbc.load_event_features(str(reads / f))
              for f in sorted(os.listdir(reads))]
    caller = tbc.Basecaller(port, KLEN, output="states", device="cpu")
    results = caller.basecall_signals([f for _, f in loaded])
    want = _fasta(tbc.SeqPrinter, results, [n for n, _ in loaded],
                  [len(f) for _, f in loaded], datatype="events",
                  kmer_len=KLEN)
    with open(out) as fh:
        text = fh.read()
    assert text == want and text.count(">") == 2


def test_events_cli_chunked_matches_jax(models, tmp_path):
    """``events --chunked`` runs the chunked "bases" path over the feature
    matrices and writes the JAX package's chunked FASTA."""
    layer, params, port = models
    reads = tmp_path / "reads"
    reads.mkdir()
    for i, n in enumerate((330, 170)):
        write_event_fast5(str(reads / "read{}.fast5".format(i)),
                          event_table(n, 30 + i))
    model = str(tmp_path / "model.json")
    tser.save_model_json(model, port)
    out = str(tmp_path / "calls.fa")
    assert tcli.main(["events", model, str(reads), "--device", "cpu",
                      "--kmer_len", str(KLEN), "--chunked", "--chunk_size",
                      "128", "--overlap", "16", "--output", out]) == 0
    loaded = [jbc.load_event_features(str(reads / f))
              for f in sorted(os.listdir(reads))]
    ref = jbc.Basecaller(layer, params, KLEN, chunked=True, output="bases",
                         chunk_size=128, overlap=16).basecall_signals(
        [f for _, f in loaded])
    fh = io.StringIO()
    printer = jbc.SeqPrinter(KLEN, fh=fh)
    for (name, f), (score, codes) in zip(loaded, ref):
        printer.write_codes(name, score, codes, len(f))
    with open(out) as got:
        assert got.read() == fh.getvalue()
