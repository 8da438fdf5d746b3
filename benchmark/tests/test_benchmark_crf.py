"""The CRF cell (``basecall_crf_chunked.bonito_crf_hac_v3.3``), added as
files and entries alone: the new layer kinds' FLOPs and parameter names
against the program's layers, the benchmark's CRF decode against the
program's plain twin, the roofline readers, and a tiny run of the cell on
the CPU (its own tiny configuration, written here), judged correct, with
the TF32 control and the two CRF faults planted here (the Viterbi run on
the raw scores, one LSTM's direction flipped) judged not correct."""
import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import generators, port, roofline, spec
from benchmark.reference import crf, model

ROOT = spec.ROOT
CELL = "basecall_crf_chunked.bonito_crf_hac_v3.3"
CONFIG = "bonito_crf_hac_v3.3"
SEED = 2 ** 31 + 3
#: the cell's configuration at features 32 (every other size as published)
TINY_FEATURES = 32
#: the cell's traffic cut to a size the CPU runs in seconds (25 windows in
#: batches of 7: a short one of 4 last), with weights that give the tiny
#: network ~0.6 bases a frame, as the cell's give the published one
TINY_TRAFFIC = dict(reads=4, min_samples=2000, max_samples=4000,
                    batch_size=7, chunk_size=600, overlap=50,
                    check_reads=4, reference_block=8,
                    weights={"sd": 4.0, "bias_sd": 0.0, "crf_gain": 4.0,
                             "crf_bias": -0.6})


def _config():
    return spec.load_json(os.path.join(ROOT, "benchmark", "configs",
                                       CONFIG + ".json"))


def _traffic():
    return spec.load_json(os.path.join(ROOT, "benchmark", "traffic",
                                       "basecall_crf_chunked.json"))


def tiny_config(features=TINY_FEATURES):
    cfg = _config()
    for spec_ in cfg["layers"]:
        for key in ("insize", "size"):
            if spec_.get(key) == 384:
                spec_[key] = features
    cfg["port_model"]["args"]["features"] = features
    return cfg


def test_benchmark_crf_flops_of_the_new_kinds():
    layers = _config()["layers"]
    assert roofline.flops_per_sample(layers) == pytest.approx(2563956.8,
                                                              abs=1e-6)
    assert _config()["flops_per_sample"] == 2563956.8
    lstm = [l for l in layers if l["type"] == "lstm_cell"]
    assert sum(roofline.flops_per_sample([l]) for l in lstm) / 5 == \
        pytest.approx(2359296.0)
    assert model.stride(layers) == 5
    assert model.out_lengths(layers, np.array([10000, 9999, 1]))\
        .tolist() == [2000, 2000, 1]


def test_benchmark_crf_parameter_names_are_the_programs():
    """Every parameter the benchmark draws is the program's, by name and
    shape, at the published widths; the peepholes are zero."""
    cfg = _config()
    params = generators.weights(cfg["layers"], _traffic()["weights"], SEED,
                                torch.device("cpu"))
    layer = port.network(cfg)
    want = {}
    for i, sub in enumerate(port._sublayers(layer)):
        for name, p in sub.named_parameters(recurse=False):
            want["{}.{}".format(i, name)] = tuple(p.shape)
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    assert want["3.iW"] == (4, 384, 384) and want["8.W"] == (1024, 384)
    assert all(float(params["{}.p".format(i)].abs().max()) == 0.0
               for i in range(3, 8))
    port.load_weights(layer, params)


def test_benchmark_crf_reference_network_equals_the_programs():
    cfg = tiny_config()
    cpu = torch.device("cpu")
    params = generators.weights(cfg["layers"], _traffic()["weights"], SEED,
                                cpu)
    layer = port.load_weights(port.network(cfg), params)
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.normal(size=(400, 3, 1)).astype(np.float32))
    lengths = torch.tensor([400, 257, 31])
    x[torch.arange(400)[:, None] >= lengths[None, :]] = 0.0
    with torch.no_grad():
        want, wn = layer.apply_with_lengths(x, lengths)
        got, gn = model.logits(cfg["layers"], params, x, lengths)
    assert torch.equal(wn, gn)
    for b, n in enumerate(gn.tolist()):
        torch.testing.assert_close(got[:n, b], want[:n, b], rtol=1e-5,
                                   atol=2e-5)


def test_benchmark_crf_transitions_are_seqdists():
    """The reference's transitions at N = 256 are seqdist's ``CTC_CRF.idx``
    as seqdist builds it, and each state's incoming pairs lead into it."""
    N = 256
    idx, into_s, into_k = crf.transitions(N, "cpu")
    want = torch.cat([torch.arange(N)[:, None],
                      torch.arange(N).repeat_interleave(4).reshape(4, -1).T],
                     dim=1)
    assert torch.equal(idx, want)
    for s in range(N):
        pairs = {(int(a), int(k)) for a, k in zip(into_s[s], into_k[s])}
        assert pairs == {(a, k) for a in range(N) for k in range(5)
                         if int(idx[a, k]) == s}


@pytest.mark.parametrize("N", [4, 256])
def test_benchmark_crf_decode_equals_the_programs(N):
    from sloika_tpu_torch.ops import crf_decode
    rs = np.random.RandomState(N)
    T, B = 45, 4
    scores = torch.from_numpy(
        (np.tanh(rs.normal(size=(T, B, 5 * N))) * 5).astype(np.float32))
    frames = torch.tensor([45, 0, 17, 1])
    score, labels = crf.decode(scores, frames)
    s2, l2 = crf_decode.crf_decode_plain(scores, frames)
    assert np.array_equal(labels, l2.long().numpy())
    np.testing.assert_allclose(score, s2.double().numpy(), rtol=2e-6,
                               atol=1e-6)


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    s = importlib.util.spec_from_file_location("reader_" + name.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_benchmark_crf_roofline_readers():
    """Each reader on a hand-built trace: the least time of the window's
    work over its kernels' device time; None where no kernel of its name
    ran or the traffic runs no LSTM."""
    lstm = _reader("lstm_fwd_roofline.basecall")
    dec = _reader("crf_decode_roofline.basecall")
    layers = _config()["layers"]
    steps = 2000 * 512
    work = {"lstm_steps": [(384, steps)] * 5, "frames": steps}
    t = SimpleNamespace(kernel_seconds=lambda *p: 0.65 if "lstm_fwd_kernel"
                        in p else 0.0105)
    ctx = SimpleNamespace(trace=t, work=work, layers=layers)
    least = 5 * 8 * 384 ** 2 * steps / roofline.F32_FLOP_PER_S
    assert lstm.read(ctx) == pytest.approx(100 * least / 0.65)
    assert lstm.lstm_fwd_bound(steps, 384)[1] == 8 * 384 ** 2 * steps
    assert dec.read(ctx) == pytest.approx(
        100 * steps * (4 * 1280 + 1) / roofline.HBM_BYTES_PER_S / 0.0105)
    none = SimpleNamespace(kernel_seconds=lambda *p: 0.0)
    assert lstm.read(SimpleNamespace(trace=none, work=work)) is None
    assert dec.read(SimpleNamespace(trace=none, work=work,
                                    layers=layers)) is None
    assert lstm.read(SimpleNamespace(trace=t, work={"frames": 1})) is None


@contextlib.contextmanager
def viterbi_on_scores():
    """The CRF decode's Viterbi run on the raw scores, the posterior step
    skipped: each row's best path through the scores themselves."""
    from sloika_tpu_torch.ops import crf_decode as cd

    def decode(scores, lengths):
        T, B, C = scores.shape
        N = C // 5
        M = scores.reshape(T, B, N, 5)
        idx = cd.crf_idx(N, scores.device)
        n = lengths.to(scores.device)
        v = scores.new_zeros((B, N))
        back = torch.zeros((T, B, N), dtype=torch.uint8,
                           device=scores.device)
        for t in range(T):
            best, k = torch.max(v[:, idx] + M[t], dim=2)
            v = torch.where((t < n)[:, None], best - best[:, :1], v)
            back[t] = k.to(torch.uint8)
        rows = torch.arange(B, device=scores.device)
        s = torch.argmax(v, dim=1)
        labels = torch.zeros((B, T), dtype=torch.uint8,
                             device=scores.device)
        for t in range(T - 1, -1, -1):
            live = t < n
            k = back[t, rows, s].long()
            labels[:, t] = torch.where(live, k, 0).to(torch.uint8)
            s = torch.where(live & (k > 0), (k - 1) * (N // 4) + s // 4, s)
        return v[rows, s], labels

    old = cd.crf_decode
    cd.crf_decode = decode
    try:
        yield
    finally:
        cd.crf_decode = old


@contextlib.contextmanager
def lstm_direction_flipped():
    """The network's first reversed LSTM run forwards."""
    from sloika_tpu_torch import basecall, nn
    cls = basecall.Basecaller
    init = cls.__init__

    def flipped(self, layer, *args, **kwargs):
        for i, sub in enumerate(layer.layers):
            if isinstance(sub, nn.Reverse):
                layer.layers[i] = sub.layer
                break
        init(self, layer, *args, **kwargs)

    cls.__init__ = flipped
    try:
        yield
    finally:
        cls.__init__ = init


#: the faults of this cell, by name (``faults.FAULTS`` holds the others)
CRF_FAULTS = {"viterbi_on_scores": viterbi_on_scores,
              "lstm_direction_flipped": lstm_direction_flipped}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A checkout of the benchmark with the cell at its tiny size."""
    dest = tmp_path_factory.mktemp("crf")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "benchmark"), dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "benchmark" / "configs" / (CONFIG + ".json")).write_text(
        json.dumps(tiny_config()))
    path = dest / "benchmark" / "traffic" / "basecall_crf_chunked.json"
    traffic = json.loads(path.read_text())
    traffic.update(TINY_TRAFFIC)
    path.write_text(json.dumps(traffic))
    return str(dest)


#: one run of the tiny cell in a process of its own (the program's
#: basecaller, once imported, would stay in this one), a fault planted or
#: the TF32 control put in the program's place; its result line last
RUN = """
import contextlib, json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {root!r} + "/benchmark")
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
import run as bench_run
from benchmark.harness import compare, faults, spec
from benchmark.harness import trace as tr
from test_benchmark_crf import CRF_FAULTS
planted = CRF_FAULTS.get({fault!r}) or faults.FAULTS.get({fault!r})
with (planted() if planted else contextlib.nullcontext()):
    if {control!r}:
        c = spec.Cell({cell!r}, root={tree!r})
        d = c.driver.Driver(c, 2 ** 31 + 13, torch.device("cpu"),
                            tr.Spans(False))
        d.setup()
        d.run_window(0.0)
        ok, checks = compare.judge(d.control())
        out = {{"correct": ok, "checks": checks}}
    else:
        out = bench_run.run({cell!r}, 2 ** 31 + 11, 0.2, {trace!r},
                            device=torch.device("cpu"),
                            t_start=time.perf_counter(), root={tree!r})
print(json.dumps(out))
"""


def _run(tree, fault=None, trace=0, control=False):
    code = RUN.format(root=ROOT, tests=os.path.dirname(
        os.path.abspath(__file__)), tree=tree, cell=CELL, fault=fault,
        trace=trace, control=control)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=tree)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_benchmark_crf_cell_parts_are_found_by_name():
    c = spec.Cell(CELL)
    assert c.workload["chips"] == 1
    assert {m["name"] for m in c.end_to_end} == {"basecall_samples_per_s",
                                                 "setup_s"}
    assert set(c.readers) == {
        "idle_pct.basecall", "mfu.basecall", "idle_host_pct.basecall",
        "h2d_bytes_per_sample.basecall", "d2h_bytes_per_sample.basecall",
        "lstm_fwd_roofline.basecall", "crf_decode_roofline.basecall"}


def test_benchmark_crf_cell_runs_correct_on_the_cpu(tree):
    out = _run(tree)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"basecall_samples_per_s", "setup_s"}


def test_benchmark_crf_traced_run_reads_the_trace(tree):
    out = _run(tree, trace=1)
    assert out["correct"], out["checks"]
    # no kernels on the CPU: the rooflines read nothing
    assert set(out["metrics"]) <= {"idle_pct.basecall", "mfu.basecall",
                                   "idle_host_pct.basecall",
                                   "h2d_bytes_per_sample.basecall",
                                   "d2h_bytes_per_sample.basecall"}
    assert "mfu.basecall" in out["metrics"]


@pytest.mark.parametrize("fault", ["answer_altered", "tail_batch_altered",
                                   "viterbi_on_scores",
                                   "lstm_direction_flipped"])
def test_benchmark_crf_planted_fault_comes_out_not_correct(tree, fault):
    out = _run(tree, fault=fault)
    assert not out["correct"], out["checks"]


def test_benchmark_crf_control_comes_out_not_correct(tree):
    out = _run(tree, control=True)
    assert not out["correct"], out["checks"]
