"""The port stands without jax, h5py and the JAX package, and never drops
to the CPU on its own."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from sloika_tpu_torch import basecall as tbc
from sloika_tpu_torch import models as tmodels

_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["h5py"] = None
sys.modules["sloika_tpu"] = None
import sloika_tpu_torch
import sloika_tpu_torch.basecall
import sloika_tpu_torch.serialize
import sloika_tpu_torch.models
import sloika_tpu_torch.cli.basecall
import sloika_tpu_torch.nn.fused_gru
import sloika_tpu_torch.ops.viterbi_kernel
import sloika_tpu_torch.training
import sloika_tpu_torch.optim
import sloika_tpu_torch.data.hdf5
import sloika_tpu_torch.cli.train
import sloika_tpu_torch.cli.validate
import sloika_tpu_torch.profile_train
import sloika_tpu_torch.remap
import sloika_tpu_torch.ops.remap
import sloika_tpu_torch.ops.remap_banded
import sloika_tpu_torch.ops.remap_kernel
import sloika_tpu_torch.data.batching
import sloika_tpu_torch.data.chunkify_tools
import sloika_tpu_torch.data.fast5
import sloika_tpu_torch.data.fileio
import sloika_tpu_torch.data.raw_chunkify
import sloika_tpu_torch.cli.chunkify
import sloika_tpu_torch.nn.fused_lstm
import sloika_tpu_torch.models.baseline_lstm
import sloika_tpu_torch.data.features
import sloika_tpu_torch.scripts
import sloika_tpu_torch.scripts.bench_gru_unroll
import sloika_tpu_torch.scripts.bench_viterbi_parts
import sloika_tpu_torch.scripts.bench_dma
import sloika_tpu_torch.scripts.bench_gru
import sloika_tpu_torch.scripts.bench_lstm
import sloika_tpu_torch.activations
import sloika_tpu_torch.compat.theano_pickle
import sloika_tpu_torch.module_tools
import sloika_tpu_torch.nn.decode_layer
import sloika_tpu_torch.models.tiny_gru
import sloika_tpu_torch.models.baseline_gru
import sloika_tpu_torch.models.baseline_raw_gru
import sloika_tpu_torch.models.bigger_raw_gru
import sloika_tpu_torch.cli.verify
import sloika_tpu_torch.cli.dump_json
import sloika_tpu_torch.cli.model_convert
import sloika_tpu_torch.ops.decode_np
import sloika_tpu_torch.ops.olddecode
import sloika_tpu_torch.native
import sloika_tpu_torch.align
import sloika_tpu_torch.data.sam
import sloika_tpu_torch.data.simulate
import sloika_tpu_torch.nn.flops
import sloika_tpu_torch.cli.align
import sloika_tpu_torch.cli.extract_reference
import sloika_tpu_torch.cli.get_refs_from_sam
import sloika_tpu_torch.scripts.bench_remap
import sloika_tpu_torch.scripts.bench_viterbi
import sloika_tpu_torch.iterators
import sloika_tpu_torch.parallel
import sloika_tpu_torch.parallel.imap
import sloika_tpu_torch.parallel.mesh
import sloika_tpu_torch.parallel.multihost
import sloika_tpu_torch.parallel.spawn
import sloika_tpu_torch.models.bonito_crf
import sloika_tpu_torch.models.bonito_crf_reference
import sloika_tpu_torch.ops.crf_decode
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "h5py", "sloika_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("ok")
"""


def test_port_imports_with_jax_and_h5py_blocked():
    cp = subprocess.run([sys.executable, "-c", _BLOCKED],
                        capture_output=True, text=True, timeout=120)
    assert cp.returncode == 0, cp.stderr
    assert cp.stdout.strip() == "ok"


_DEVICE_PARTS = """
import sys
sys.modules["jax"] = None
sys.modules["h5py"] = None
sys.modules["sloika_tpu"] = None
import argparse
import numpy as np
from sloika_tpu_torch import models
from sloika_tpu_torch.data import chunkify_tools
from sloika_tpu_torch.remap import Remapper
rs = np.random.RandomState(0)
args = argparse.Namespace(chunk_len=100, kmer_len=3, use_scaled=False,
                          normalisation="per-read", alphabet=b"ACGT",
                          downsample_factor=1, interpolation=False,
                          dac=False)
refs = [bytes(rs.choice(list(b"ACGT"), 90).astype(np.uint8))
        for _ in range(2)]
ev = np.zeros(300, dtype=[("mean", "f8"), ("stdv", "f8"), ("start", "f8"),
                          ("length", "f8")])
ev["mean"], ev["stdv"] = rs.normal(size=300), rs.uniform(1, 2, size=300)
ev["length"] = 0.01
lstm = models.network_factory("baseline_lstm")(klen=3, sd=0.5, size=8)
rec = chunkify_tools.remap_event_records(
    Remapper(lstm, 3, device="cpu"), ["a", "b"], [ev, ev[:250]], refs, args)
assert [len(r["chunks"]) for r in rec] == [3, 2], rec
gru = models.network_factory("raw_1_00_rGr")(
    klen=3, sd=0.5, sizes=(8, 8, 8, 8), stride=5)
sig = [rs.normal(size=500).astype(np.float32) for _ in range(2)]
args.chunk_len = 200
rec = chunkify_tools.remap_raw_records(
    Remapper(gru, 3, device="cpu"), [("a", sig[0]), ("b", sig[1])], refs,
    args)
assert len(rec) == 2 and all(r["strand"].startswith(n + ".fast5")
                             for r, n in zip(rec, "ab")), rec
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "h5py", "sloika_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("ok")
"""


def test_chunkify_device_parts_run_without_h5py():
    """The remap mains' device parts take reads in memory: they run where
    h5py is missing, as on the card's machine."""
    cp = subprocess.run([sys.executable, "-c", _DEVICE_PARTS],
                        capture_output=True, text=True, timeout=300)
    assert cp.returncode == 0, cp.stderr
    assert cp.stdout.strip().splitlines()[-1] == "ok"


def test_chip_smoke_imports_nothing_of_jax_or_the_jax_package():
    """Every import in chip_smoke.py, at any depth, names the port or a
    package the card's machine has."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "sloika_tpu_torch" in roots
    assert not roots & {"sloika_tpu", "jax", "jaxlib", "h5py"}, roots


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_cuda_basecaller_raises_without_a_gpu(device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    layer = tmodels.network_factory("raw_1_00_rGr")(
        klen=3, sd=0.5, sizes=(8, 8, 8, 8), stride=5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbc.Basecaller(layer, 3, device=device)
    # nothing was moved: the layer stays on the CPU it was built on
    assert all(p.device.type == "cpu" for p in layer.parameters())


def test_cli_device_cuda_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sloika_tpu_torch import serialize
    from sloika_tpu_torch.cli import basecall as tcli
    layer = tmodels.network_factory("raw_1_00_rGr")(
        klen=3, sd=0.5, sizes=(8, 8, 8, 8), stride=5)
    model = str(tmp_path / "m.json")
    serialize.save_model_json(model, layer)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["raw", model, str(tmp_path), "--kmer_len", "3"])


def test_train_on_cuda_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sloika_tpu_torch import training
    from sloika_tpu_torch.cli import train as tcli
    layer = tmodels.network_factory("raw_0_98_rgrgr")(klen=3, sd=0.5,
                                                      size=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        training.train(layer, {}, device="cuda")
    assert all(p.device.type == "cpu" for p in layer.parameters())
    h5 = tmp_path / "chunks.hdf5"
    h5.write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["raw", "raw_0.98_rgrgr", str(tmp_path / "out"), str(h5),
                   "--device", "cuda"])
    assert not (tmp_path / "out").exists()


def test_train_and_validate_default_to_the_card():
    """Called as library functions without ``device``, ``train`` and
    ``validate`` ask for the card, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sloika_tpu_torch import training
    layer = tmodels.network_factory("baseline_lstm")(klen=3, sd=0.5,
                                                     size=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        training.train(layer, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        training.validate(layer, {})
    assert all(p.device.type == "cpu" for p in layer.parameters())


@pytest.mark.parametrize("cli,argv", [
    ("verify", ["tiny_gru"]),
    ("dump_json", ["MODEL"]),
    ("model_convert", ["MODEL", "OUT.npz"])])
def test_model_clis_default_to_the_card(cli, argv, tmp_path):
    """``verify``, ``dump_json`` and ``model_convert`` run on the card
    unless given ``--device cpu``, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib
    from sloika_tpu_torch import serialize
    mod = importlib.import_module("sloika_tpu_torch.cli." + cli)
    model = str(tmp_path / "m.npz")
    serialize.save_checkpoint(model, tmodels.network_factory("tiny_gru")(
        klen=3, sd=0.5))
    argv = [a.replace("MODEL", model).replace("OUT", str(tmp_path / "o"))
            for a in argv]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert not (tmp_path / "o.npz").exists()
