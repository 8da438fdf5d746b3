"""The port's model zoo, model files and model CLIs against the JAX
package (CPU).

* ``tiny_gru``, ``baseline_gru``, ``baseline_raw_gru`` and
  ``bigger_raw_gru`` at small widths: the same graph (model JSON equal as
  parsed objects), the same parameter shapes, and with the JAX model's
  tree (numpy draws at 1/sqrt(fan-in)) posteriors within 1e-5 absolute
  under the mask of ragged lengths;
* every name of the JAX registry builds in the port;
* a ``.py`` model file written against ``sloika_tpu_torch.module_tools``
  builds through ``network_factory`` and trains through the ``train`` CLI,
  which copies it into its output;
* ``verify`` reports the JAX ``verify``'s network line (its random
  inputs come from a ``torch.Generator``, so its batches differ); ``dump_json`` of
  a reference ``.pkl`` gives the JAX ``dump_json``'s JSON as parsed
  objects; ``model_convert`` of a ``.pkl`` writes a ``.npz`` the JAX
  package loads to the same tree;
* a Studentise events model's whole-read fallback, from the chunked mode
  (``Basecaller(chunked=True, output="bases")``), calls what
  the JAX ``Basecaller(chunked=True)``'s fallback calls on synthetic event
  features: states equal, scores within 1e-5 relative.
"""
import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import sloika_tpu.nn as jnn
from sloika_tpu import basecall as jbc
from sloika_tpu import models as jmodels
from sloika_tpu import serialize as jser
from sloika_tpu.cli import dump_json as jdump_json
from sloika_tpu.cli import verify as jverify
from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch import models as tmodels
from sloika_tpu_torch import nn as tnn
from sloika_tpu_torch.cli import dump_json as tdump_json
from sloika_tpu_torch.cli import model_convert as tmodel_convert
from sloika_tpu_torch.cli import train as tcli_train
from sloika_tpu_torch.cli import verify as tverify
from sloika_tpu_torch.compat import theano_pickle as tp
from sloika_tpu_torch.nn.core import tree_items

KLEN, ATOL = 3, 1e-5
MODELS = {"tiny_gru": ({"size": 4}, 4), "baseline_gru": ({"size": 8}, 4),
          "baseline_raw_gru": ({"size": 8}, 1),
          "bigger_raw_gru": ({"size": (4, 8, 6)}, 1)}

MODEL_PY = '''
import numpy as np

import sloika_tpu_torch.module_tools as smt


def network(klen, sd, nbase=smt.DEFAULT_NBASE, nfeature=4, winlen=3,
            stride=1, seed=0):
    init = smt.truncated_normal(sd, np.random.RandomState(seed))
    return smt.Serial([
        smt.Window(nfeature, winlen),
        smt.Reverse(smt.Recurrent(nfeature * winlen, 8, init=init,
                                  has_bias=True, fun=smt.fair)),
        smt.Softmax(8, smt.nstate(klen, nbase=nbase), init=init,
                    has_bias=True)])
'''


def seeded_params(layer, seed, sd=1.0):
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(layer.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (sd * rs.normal(size=s.shape)
                   / np.sqrt(s.shape[-1])).astype(s.dtype), shapes)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_model_matches_jax(name):
    kw, nfeature = MODELS[name]
    port = tmodels.network_factory(name)(klen=KLEN, sd=0.5, **kw)
    jlayer = jmodels.network_factory(name)(klen=KLEN, sd=0.5, **kw)
    assert port.to_json(False) == json.loads(json.dumps(
        jlayer.to_json(None)))
    shapes = jax.eval_shape(jlayer.init, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in tree_items(port.param_tree())} \
        == {k: tuple(v.shape) for k, v in tree_items(shapes)}
    params = seeded_params(jlayer, 2)
    port.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    T = 48 if nfeature == 1 else 21
    lengths = np.array([T, T // 2 + 1, T - 6])
    x = np.random.RandomState(3).normal(size=(T, 3, nfeature)).astype(
        np.float32)
    x *= (np.arange(T)[:, None] < lengths[None, :])[:, :, None]
    with torch.no_grad():
        got, glen = port.apply_with_lengths(torch.from_numpy(x),
                                            torch.from_numpy(lengths))
    ref, rlen = jlayer.apply_with_lengths(params, jnp.asarray(x),
                                          jnp.asarray(lengths))
    assert np.array_equal(glen.numpy(), np.asarray(rlen))
    m = (np.arange(got.shape[0])[:, None] < np.asarray(rlen)[None, :])
    assert np.max(np.abs(got.numpy() - np.asarray(ref)) * m[:, :, None]) \
        <= ATOL
    assert tbc._infer_stride(port) == jbc._infer_stride(jlayer)


def test_every_jax_model_name_builds_in_the_port():
    # and bonito's CRF-LSTM, which the JAX package lacks
    assert set(tmodels.REGISTRY) == set(jmodels.REGISTRY) | {"bonito_crf"}
    for name in jmodels.REGISTRY:
        layer = tmodels.network_factory(name)(klen=KLEN, sd=0.5)
        assert layer.size == 4 ** KLEN + 1


def test_stride_of_pooled_and_parallel_graphs_matches_jax():
    j = jnn.Serial([jnn.Convolution(1, 4, 3, stride=2),
                    jnn.Residual(jnn.MaxPool(4, 3, 3)),
                    jnn.Parallel([jnn.MaxPool(4, 2, 2), jnn.Identity(4)])])
    port, _ = tnn.from_json(j.to_json(None))
    assert tbc._infer_stride(port) == jbc._infer_stride(j) == 12


def test_py_model_file_builds_and_trains(tmp_path):
    from sloika_tpu_torch.data.hdf5 import create_labelled_chunks_hdf5
    path = str(tmp_path / "mymodel.py")
    with open(path, "w") as fh:
        fh.write(MODEL_PY)
    layer = tmodels.network_factory(path)(klen=KLEN, sd=0.5, seed=4)
    assert [l.json_type for l in layer.layers] == ["window", "reverse",
                                                   "softmax_old"]
    assert layer.layers[1].layer.fun.__name__ == "fair"
    with pytest.raises(ValueError, match="Unknown model"):
        tmodels.network_factory(str(tmp_path / "missing.py"))
    rs = np.random.RandomState(5)
    h5 = str(tmp_path / "chunks.hdf5")
    create_labelled_chunks_hdf5(
        h5, 0.5, {"kmer": KLEN}, [rs.normal(size=(6, 30, 4)).astype(
            np.float32)], [rs.randint(1, 65, size=(6, 30)).astype(np.int32)],
        [np.zeros((6, 30), bool)])
    out = str(tmp_path / "run")
    assert tcli_train.main(["events", path, out, h5, "--device", "cpu",
                            "--niteration", "2", "--batch_size", "3",
                            "--drop", "2", "--quiet"]) == 0
    with open(os.path.join(out, "model.py")) as fh:
        assert fh.read() == MODEL_PY
    assert os.path.exists(os.path.join(out, "model_final.npz"))


def test_verify_reports_the_jax_network(capsys):
    args = ["baseline_raw_gru", "--stride", "2", "--nbatch", "2"]
    assert tverify.main(args + ["--device", "cpu"]) == 0
    port_out = capsys.readouterr().out.splitlines()
    assert jverify.main(args) == 0
    jax_out = capsys.readouterr().out.splitlines()
    assert port_out[0] == jax_out[0]
    assert port_out[-1] == jax_out[-1] == "* OK"
    assert len(port_out) == len(jax_out) == 4


@pytest.fixture
def zoo_pkl(tmp_path):
    layer = cs.zoo_graph()
    path = str(tmp_path / "zoo.pkl")
    with open(path, "wb") as fh:
        fh.write(cs.write_reference_pickle(layer))
    return path


def test_dump_json_of_a_pkl_equals_the_jax_dump(zoo_pkl, tmp_path):
    outs = [str(tmp_path / n) for n in ("port.json", "jax.json")]
    assert tdump_json.main(["--device", "cpu", "--out_file", outs[0],
                            zoo_pkl]) == 0
    assert jdump_json.main(["--out_file", outs[1], zoo_pkl]) == 0
    dumped = []
    for o in outs:
        with open(o) as fh:
            dumped.append(json.load(fh))
    assert dumped[0] == dumped[1]
    assert tdump_json.main(["--device", "cpu", "--no-params", "--out_file",
                            outs[0], zoo_pkl]) == 0
    with open(outs[0]) as fh:
        assert "params" not in json.dumps(json.load(fh))


def test_model_convert_pkl_to_npz_loads_in_jax(zoo_pkl, tmp_path):
    npz = str(tmp_path / "zoo.npz")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tmodel_convert.main(["--device", "cpu", zoo_pkl, npz]) == 0
    assert buf.getvalue().startswith("Wrote " + npz)
    jlayer, jparams, _ = jser.load_checkpoint(npz)
    port, ptree = tp.load_model(zoo_pkl)
    a = {k: np.asarray(v) for k, v in tree_items(
        jax.tree_util.tree_map(np.asarray, jparams))}
    b = dict(tree_items(ptree))
    assert sorted(a) == sorted(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert jlayer.to_json(None) == json.loads(json.dumps(port.to_json()))
    with pytest.raises(SystemExit):
        tmodel_convert.main(["--device", "cpu", zoo_pkl,
                             str(tmp_path / "zoo.pt")])


def _event_features(n, seed):
    rs = np.random.RandomState(seed)
    return [np.stack([90 + 12 * rs.normal(size=L), rs.uniform(0.5, 3, L),
                      rs.normal(size=L), rs.uniform(size=L)], axis=1)
            .astype(np.float32) for L in (120, 75, 160)[:n]]


def test_studentise_fallback_calls_what_the_jax_fallback_calls():
    jlayer = jnn.Serial([
        jnn.Studentise(4), jnn.Window(4, 3),
        jnn.birnn(jnn.Gru(12, 8, has_bias=True),
                  jnn.Gru(12, 8, has_bias=True)),
        jnn.Softmax(16, 4 ** KLEN + 1, has_bias=True)])
    params = seeded_params(jlayer, 6, sd=2.0)
    port, _ = tnn.from_json(jlayer.to_json(None))
    port.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    feats = _event_features(3, 7)
    ref = jbc.Basecaller(jlayer, params, KLEN, chunked=True,
                         batch_size=4).basecall_signals(feats)
    caller = tbc.Basecaller(port, KLEN, chunked=True, output="bases",
                            batch_size=4, device="cpu")
    assert caller.output == "states" and caller.studentise
    got = caller.basecall_signals(feats)
    for (gs, gc), (rs_, rc) in zip(got, ref):
        assert np.array_equal(np.asarray(gc), np.asarray(rc))
        assert abs(gs - rs_) <= 1e-5 * abs(rs_)


def test_a_non_transducer_model_is_refused_clearly():
    """A model whose states are no decoder's is refused with its count and
    the decoder's; a non-transducer is decoded on the host when it is
    declared (``transducer=False``), and refused when it is not."""
    layer = tnn.Serial([tnn.Window(4, 3), tnn.Softmax(12, 4 ** KLEN + 2)])
    with pytest.raises(ValueError, match="model emits {} states, decode "
                       "expects {}".format(4 ** KLEN + 2, 4 ** KLEN + 1)):
        tbc.Basecaller(layer, KLEN, device="cpu")
    layer = tnn.Serial([tnn.Window(4, 3), tnn.Softmax(12, 4 ** KLEN)])
    with pytest.raises(ValueError, match="model emits"):
        tbc.Basecaller(layer, KLEN, device="cpu")
    assert not tbc.Basecaller(layer, KLEN, transducer=False,
                              device="cpu").transducer
