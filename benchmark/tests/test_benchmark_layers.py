"""Layer kinds found by name (``benchmark/reference/layers/<type>.py``): a
kind the harness has never seen, added as files alone to a copy of the
tree, gives a cell, its weights, its reference logits and its FLOPs; a
kind without a file names the file to add; and what the configurations'
kinds give is pinned, bit for bit, to what the harness gave while every
kind was written into its loops (the values below were computed by the
harness of that tree, on the CPU)."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import generators, roofline, spec
from benchmark.reference import model
from benchmark.reference.layers import kind

ROOT = spec.ROOT
CONFIGS = ["sloika_pretrained", "raw_0.98_rgrgr"]
#: each configuration's weights as its cells draw them
SCHEMES = {
    "sloika_pretrained": {"sd": 3.0, "bias_sd": 0.0, "softmax_gain": 5.0,
                          "stay_logit": 4.6},
    "raw_0.98_rgrgr": {"sd": 0.5, "bias_sd": 0.5, "softmax_gain": 1.0,
                       "stay_logit": None}}
SEED = 2 ** 31 + 3
FLOPS = {"sloika_pretrained": 157382.4, "raw_0.98_rgrgr": 150374.4}
#: sha256 of the seed's weights (each name, then its float32 bytes, in
#: draw order) and of the reference's logits of :func:`_batch`
PINS = {
    ("sloika_pretrained", "weights"):
        "3a00292b6e9fd212ad44ff2dbf16630ceb0f3975a97fddaafc4d79c78f84a926",
    ("sloika_pretrained", "float32"):
        "b8597cc34d19c503309d62bb2f9909558658237fe5ad03874d64f493ed7f47a5",
    ("sloika_pretrained", "tf32"):
        "f67844b7be716c74dcbaf3bda7b99cf2b05fcdda6ce371bc02dd07787492e3be",
    ("raw_0.98_rgrgr", "weights"):
        "ee5606aa19291d00355bb73194adafdf5b519a6f1c71b7ac7a8275a52df6ce58",
    ("raw_0.98_rgrgr", "float32"):
        "abb4ead989dba01c3533df769055f370d2f09c255f4cdaef7c0665c8396ac859",
    ("raw_0.98_rgrgr", "tf32"):
        "9495e2ea740449146d74f9bbc75842847b6b5b8bf39f37357e344e35227840cf"}


def _layers(name):
    return spec.load_json("{}/benchmark/configs/{}.json".format(
        ROOT, name))["layers"]


def _weights(name):
    return generators.weights(_layers(name), SCHEMES[name], SEED,
                              torch.device("cpu"))


def _batch():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.normal(size=(60, 3, 1)).astype(np.float32))
    return x, torch.tensor([60, 37, 11])


@pytest.mark.parametrize("name", CONFIGS)
def test_benchmark_layers_flops_are_pinned(name):
    assert roofline.flops_per_sample(_layers(name)) == FLOPS[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_benchmark_layers_weights_are_pinned(name):
    h = hashlib.sha256()
    for k, v in _weights(name).items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == PINS[name, "weights"]


@pytest.mark.parametrize("precision", ["float32", "tf32"])
@pytest.mark.parametrize("name", CONFIGS)
def test_benchmark_layers_logits_are_pinned(name, precision):
    x, lengths = _batch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            z, n = model.logits(_layers(name), _weights(name), x, lengths,
                                precision)
    finally:
        torch.set_num_threads(threads)
    assert n.tolist() == [12, 8, 3]
    assert hashlib.sha256(z.numpy().tobytes()).hexdigest() == \
        PINS[name, precision]


def test_benchmark_layers_a_kind_without_a_file_names_it():
    layers = _layers("raw_0.98_rgrgr")
    layers[1] = dict(layers[1], type="lstm")
    want = "add benchmark/reference/layers/lstm.py"
    with pytest.raises(ValueError, match=want):
        kind("lstm")
    with pytest.raises(ValueError, match=want):
        model.param_shapes(layers)
    with pytest.raises(ValueError, match=want):
        roofline.flops_per_sample(layers)
    with pytest.raises(ValueError, match=want):
        model.out_lengths(layers, np.array([100]))
    with pytest.raises(ValueError, match="not a module name"):
        kind("../gru")


#: a layer kind no configuration of the benchmark has
SWISH = '''"""A feed-forward layer with swish: ``y * sigmoid(y)``,
``y = x W^T + b``, W (S, I)."""
import math

import torch


def param_shapes(spec, i):
    S, I = spec["size"], spec["insize"]
    return [("{}.W".format(i), (S, I), math.sqrt(S + I)),
            ("{}.b".format(i), (S,), 1.0)]


def flops(spec):
    return 2.0 * spec["size"] * spec["insize"]


def stride(spec):
    return 1


def out_lengths(spec, lengths):
    return lengths


def forward(spec, p, i, x, lengths, prec):
    y = torch.matmul(prec.operand(x), prec.operand(p["{}.W".format(i)]).t())
    y = y + p["{}.b".format(i)]
    return y * torch.sigmoid(y)
'''

#: what the copy's harness gives for the new configuration
PROBE = '''
import json, sys
from types import SimpleNamespace
sys.path.insert(0, %r)
import numpy as np, torch
import benchmark
from benchmark import run
from benchmark.harness import generators, spec
from benchmark.reference import model
cell = spec.Cell("basecall_chunked.sloika_swish", root=%r)
layers = cell.config["layers"]
p = generators.weights(layers, cell.traffic["weights"], 7, torch.device("cpu"))
x = torch.from_numpy(np.random.RandomState(1).normal(size=(60, 2, 1))
                     .astype(np.float32))
z, n = model.logits(layers, p, x, torch.tensor([60, 33]))
ctx = run.Context(cell, SimpleNamespace(work={}),
                  SimpleNamespace(window_s=1.0))
print(json.dumps({"package": benchmark.__file__,
                  "shapes": {k: list(v.shape) for k, v in p.items()},
                  "logits": list(z.shape), "frames": n.tolist(),
                  "finite": bool(torch.isfinite(z).all()),
                  "flops": ctx.flops_per_sample,
                  "per_layer": sorted(m["name"] for m in cell.per_layer)}))
'''


def test_benchmark_layers_a_new_kind_is_added_as_files(tmp_path):
    """A configuration with a layer kind the harness has never seen, added
    to a copy of the tree as its configuration file, the kind's module and
    ``BENCHMARK.json`` entries, with no file already there edited."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench_dir = tmp_path / "benchmark"
    (bench_dir / "reference" / "layers" / "swish_ff.py").write_text(SWISH)
    cfg = json.loads((bench_dir / "configs"
                      / "sloika_pretrained.json").read_text())
    cfg["name"] = "sloika_swish"
    cfg["layers"].insert(1, {"type": "swish_ff", "insize": 128,
                             "size": 128})
    (bench_dir / "configs" / "sloika_swish.json").write_text(
        json.dumps(cfg))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="sloika_swish",
                                 file="benchmark/configs/sloika_swish.json"))
    base = "basecall_chunked.sloika_pretrained"
    cell = dict(bench["workloads"][0], name="basecall_chunked.sloika_swish",
                config="sloika_swish")
    assert bench["workloads"][0]["name"] == base
    bench["workloads"].append(cell)
    # a new cell joins a metric by its name in that metric's workloads
    for m in bench["end_to_end"] + bench["per_layer"]:
        if base in m.get("workloads", []):
            m["workloads"].append(cell["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for dirpath, _, files in os.walk(bench_dir):
        for f in files:
            here = os.path.join(dirpath, f)
            there = os.path.join(ROOT, os.path.relpath(here, tmp_path))
            if os.path.exists(there):
                with open(here, "rb") as a, open(there, "rb") as b:
                    assert a.read() == b.read(), here

    proc = subprocess.run(
        [sys.executable, "-c", PROBE % (str(tmp_path), str(tmp_path))],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["package"].startswith(str(tmp_path))
    assert got["shapes"]["1.W"] == [128, 128]
    assert got["shapes"]["2.iW"] == [3, 112, 128]
    assert got["logits"] == [12, 2, 1025] and got["frames"] == [12, 7]
    assert got["finite"]
    # the stand-in's count and the new layer's 2 * 128^2 at the frame rate
    assert got["flops"] == pytest.approx(157382.4 + 2 * 128 * 128 / 5,
                                         rel=1e-12)
    assert "output_head_roofline.basecall" in got["per_layer"]
