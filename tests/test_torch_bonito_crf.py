"""bonito's CRF-LSTM (``models/bonito_crf.py``) against its plain reference
(``models/bonito_crf_reference.py``) and ``torch.nn.LSTM`` on seeded random
weights at small widths on the CPU: swish, the peephole-free LSTM in both
directions on ragged rows, the CRF head, the CRF decode's posteriors and
Viterbi against brute-force enumeration, the whole model's bases through
``Basecaller`` and the ``basecall`` CLI, and the model's JSON.  On the card
(``-m gpu``): ``lstm_fwd``'s wide route (a cluster of blocks, S 257-384)
and the CRF kernels against their plain twins, its clocked build, and one
launch of each a batch.

This file imports no jax, so its ``gpu``-marked tests run on a machine with
a CUDA card and without jax::

    python -m pytest tests/test_torch_bonito_crf.py -m gpu --noconftest -q
"""
import json

import numpy as np
import pytest
import torch

from sloika_tpu_torch import activations, basecall, models, nn, serialize
from sloika_tpu_torch.models import bonito_crf_reference as ref
from sloika_tpu_torch.nn import fused_lstm
from sloika_tpu_torch.ops import crf_decode as cd

#: the CPU tests' widths: features, state_len 4 (256 states, as published)
F = 16
#: the window split of the Basecaller tests (samples): C, overlap, batch
C, V, BATCH = 600, 50, 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def bonito_state_dict(features=F, seed=1, sd=0.3):
    """A bonito state dict of ``dna_r9.4.1_e8_hac@v3.3``'s shape at
    ``features``, under bonito's own module names, from a numpy seed."""
    rs = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy((rs.normal(size=s) * sd)
                                    .astype(np.float32))
    out = {"encoder.0.conv.weight": t(4, 1, 5), "encoder.0.conv.bias": t(4),
           "encoder.1.conv.weight": t(16, 4, 5), "encoder.1.conv.bias": t(16),
           "encoder.2.conv.weight": t(features, 16, 19),
           "encoder.2.conv.bias": t(features)}
    for i in range(5):
        pre = "encoder.{}.rnn.".format(4 + i)
        out[pre + "weight_ih_l0"] = t(4 * features, features)
        out[pre + "weight_hh_l0"] = t(4 * features, features)
        out[pre + "bias_ih_l0"] = t(4 * features)
        out[pre + "bias_hh_l0"] = t(4 * features)
    out["encoder.9.linear.weight"] = t(1024, features)
    out["encoder.9.linear.bias"] = t(1024)
    return out


def port_model(features=F, seed=1):
    layer = models.network_factory("bonito_crf")(features=features)
    layer.load_param_tree(ref.from_bonito_state_dict(
        bonito_state_dict(features, seed)))
    return layer.eval()


def _signal(T, B, seed=5):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.normal(size=(T, B, 1)).astype(np.float32))
    lengths = torch.from_numpy(rs.randint(T // 3, T + 1, size=B))
    lengths[0] = T
    x[torch.arange(T)[:, None] >= lengths[None, :]] = 0.0
    return x, lengths


def test_swish():
    x = torch.linspace(-30, 30, 61, requires_grad=True)
    y = activations.swish(x)
    assert torch.equal(y, x * torch.sigmoid(x))
    assert torch.equal(y, ref.swish(x))
    y.sum().backward()
    s = torch.sigmoid(x.detach())
    assert torch.allclose(x.grad, s + x.detach() * s * (1 - s), atol=1e-6)
    assert activations.by_name("swish") is activations.swish


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_without_peepholes_is_torch_lstm(reverse):
    """The port's ``Lstm(has_peep=False)``, loaded from a ``torch.nn.LSTM``
    by the reference's gate map, on ragged rows (a reversed one from its
    own last frame): each row as torch's LSTM gives it alone."""
    torch.manual_seed(3)
    S, I, T, B = 12, 7, 30, 5
    cell = torch.nn.LSTM(I, S)
    port = nn.Lstm(I, S, has_bias=True, has_peep=False)
    port.load_param_tree(ref.lstm_cell_params(
        *(p.detach() for p in (cell.weight_ih_l0, cell.weight_hh_l0,
                               cell.bias_ih_l0, cell.bias_hh_l0))))
    x = torch.randn(T, B, I)
    lengths = torch.tensor([30, 1, 17, 29, 8])
    mask = torch.arange(T)[:, None] < lengths[None, :]
    with torch.no_grad():
        got = port(x, reverse=reverse, mask=mask)
        for b in range(B):
            n = int(lengths[b])
            row = x[:n, b:b + 1]
            want = cell(row.flip(0) if reverse else row)[0]
            want = want.flip(0) if reverse else want
            assert torch.allclose(got[:n, b], want[:, 0], atol=2e-6), b
            # and the reference's explicit loop
            loop = ref.lstm(x, cell.weight_ih_l0, cell.weight_hh_l0,
                            cell.bias_ih_l0, cell.bias_hh_l0, reverse, mask)
            assert torch.allclose(loop[:n, b], want[:, 0], atol=2e-6)


def test_linear_crf_head_and_blank_expansion():
    rs = np.random.RandomState(2)
    W = torch.from_numpy(rs.normal(size=(1024, F)).astype(np.float32))
    b = torch.from_numpy(rs.normal(size=1024).astype(np.float32))
    head = nn.LinearCRF(F)
    head.load_param_tree({"W": W.numpy(), "b": b.numpy()})
    x = torch.from_numpy(rs.normal(size=(9, 3, F)).astype(np.float32))
    with torch.no_grad():
        got = head(x)
    assert head.size == got.shape[2] == 1280
    assert torch.equal(got, ref.crf_scores(x, W, b))
    groups = got.reshape(9, 3, 256, 5)
    assert torch.all(groups[..., 0] == 2.0)
    assert torch.equal(groups[..., 1:].reshape(9, 3, 1024),
                       torch.tanh(x @ W.t() + b) * 5.0)
    assert torch.equal(cd.crf_idx(256), ref.crf_idx(256))


def seqdist_idx(N):
    """seqdist's ``CTC_CRF.idx`` for 4 bases and N states, as it builds it:
    the stay, then the four states each transition comes from."""
    return torch.cat([torch.arange(N)[:, None],
                      torch.arange(N).repeat_interleave(4).reshape(4, -1).T],
                     dim=1)


def _brute_force(M):
    """Every path of a (T, N, 5) score frame set, its transitions taken
    from :func:`seqdist_idx`: the transition posteriors, and the path that
    maximises the sum of log(P + 1e-8) with its score and labels."""
    T, N = M.shape[:2]
    idx = seqdist_idx(N).numpy()
    # (state, transition) pairs entered from each state
    into = {p: [(s, k) for s in range(N) for k in range(5) if idx[s, k] == p]
            for p in range(N)}
    # from any state at the start
    paths = [((s,), (k,)) for p in range(N) for s, k in into[p]]
    for _ in range(T - 1):
        paths = [(ss + (s,), ks + (k,)) for ss, ks in paths
                 for s, k in into[ss[-1]]]
    w = np.array([sum(M[t, s, k] for t, (s, k) in enumerate(zip(*p)))
                  for p in paths], np.float64)
    prob = np.exp(w - w.max())
    prob /= prob.sum()
    post = np.zeros((T, N, 5))
    for p, pr in zip(paths, prob):
        for t, (s, k) in enumerate(zip(*p)):
            post[t, s, k] += pr
    lp = np.log(post + 1e-8)
    best = max(paths, key=lambda p: sum(lp[t, s, k]
                                        for t, (s, k) in enumerate(zip(*p))))
    score = sum(lp[t, s, k] for t, (s, k) in enumerate(zip(*best)))
    return post, score, list(best[1])


def test_crf_idx_is_seqdist_construction():
    for N in (4, 16, 64, 256):
        assert torch.equal(cd.crf_idx(N), seqdist_idx(N))
        assert torch.equal(ref.crf_idx(N), seqdist_idx(N))


@pytest.mark.parametrize("seed,state_len,T", [(0, 1, 4), (1, 1, 4),
                                              (2, 1, 4), (3, 2, 3),
                                              (4, 2, 3)])
def test_crf_posteriors_and_viterbi_against_brute_force(seed, state_len, T):
    rs = np.random.RandomState(seed)
    N = 4 ** state_len
    M = rs.uniform(-5, 5, size=(T, N, 5))
    M[:, :, 0] = 2.0
    scores = torch.from_numpy(M.reshape(T, 1, 5 * N).astype(np.float32))
    frames = torch.tensor([T])
    post, score, labels = _brute_force(M.astype(np.float32).astype(np.float64))
    got = ref.posteriors(scores, frames)[:, 0].double().numpy()
    assert np.allclose(got.sum(axis=(1, 2)), 1.0, atol=1e-6)
    assert np.allclose(got, post, atol=2e-6)
    s, lab = cd.crf_decode_plain(scores, frames)
    assert lab[0].tolist() == labels
    assert float(s[0]) == pytest.approx(score, rel=1e-5)
    rs_, rl = ref.decode(scores, frames)
    assert rl[0].tolist() == labels
    assert float(rs_[0]) == pytest.approx(score, rel=1e-5)


def test_crf_posteriors_sum_to_one_at_full_state_len():
    rs = np.random.RandomState(4)
    T, B = 40, 2
    scores = torch.from_numpy(
        (np.tanh(rs.normal(size=(T, B, 1280))) * 5).astype(np.float32))
    scores.view(T, B, 256, 5)[..., 0] = 2.0
    frames = torch.tensor([40, 23])
    post = ref.posteriors(scores, frames)
    sums = post.sum(dim=(2, 3))
    assert torch.allclose(sums[:23], torch.ones(23, B), atol=1e-5)
    assert torch.all(sums[23:, 1] == 0)


@pytest.mark.parametrize("state_len", [1, 2, 4])
def test_crf_decode_twin_equals_the_reference(state_len):
    """The port's plain twin (the CPU route of ``crf_decode``) against the
    reference's posteriors and Viterbi, rows ragged, one of no frames."""
    N = 4 ** state_len
    rs = np.random.RandomState(state_len)
    T, B = 57, 4
    scores = torch.from_numpy(
        (np.tanh(rs.normal(size=(T, B, 5 * N))) * 5).astype(np.float32))
    frames = torch.tensor([57, 0, 31, 1])
    score, labels = cd.crf_decode(scores, frames)
    assert labels.dtype == torch.uint8 and score.dtype == torch.float32
    want_score, want_labels = ref.decode(scores, frames)
    assert torch.equal(labels.long(), want_labels)
    assert torch.allclose(score.double(), want_score, rtol=2e-6, atol=1e-6)
    assert float(score[1]) == 0.0 and int(labels[1].sum()) == 0


def test_label_records_pack_the_emitted_codes():
    rs = np.random.RandomState(7)
    B, Tp = 5, 23
    labels = torch.from_numpy(rs.randint(0, 5, size=(B, Tp)).astype(np.uint8))
    labels[1] = 0
    first, counts, packed = cd.label_records(labels, (4, 19))
    assert first.dtype == torch.int16 and not first.any()
    codes = basecall._unpack_codes(packed.numpy())
    for b in range(B):
        lab = labels[b].numpy()
        want = lab[lab > 0] - 1
        assert np.array_equal(codes[b, :len(want)], want)
        assert counts[b].tolist() == [int((lab[:4] > 0).sum()),
                                      int((lab[:19] > 0).sum()), len(want)]


def _dac_reads(n=3, seed=11):
    rs = np.random.RandomState(seed)
    out = []
    for L in rs.randint(700, 1900, size=n):
        levels = rs.normal(size=L // 9 + 1)
        sig = np.repeat(levels, 9)[:L] + rs.normal(scale=0.1, size=L)
        dac = np.round(sig * 300 + 2000).astype(np.int16)
        scaled = (dac.astype(np.float32) + np.float32(10.0)) * np.float32(
            0.15)
        med = np.float32(np.median(scaled))
        mad = np.float32(1.4826 * np.median(np.abs(scaled - med)))
        out.append((dac, (np.float32(10.0), np.float32(0.15), med, mad)))
    return out


def _reference_calls(sd, reads):
    """Each read's (score, bases) by the reference: its windows of C
    samples (overlap V), the network and the decode a window, the bases of
    each window's core frames joined."""
    out = []
    for dac, norm in reads:
        sig = basecall.normalise_dac_f32(dac, norm)
        jobs = basecall._window_jobs([len(sig)], C, V)
        x = torch.zeros((C, len(jobs), 1))
        lengths = torch.tensor([j[3] for j in jobs])
        for b, (_, _, start, ln, _) in enumerate(jobs):
            x[:ln, b, 0] = torch.from_numpy(sig[start:start + ln])
        with torch.no_grad():
            scores, frames = ref.network(sd, x, lengths)
        score, labels = ref.decode(scores, frames)
        parts, total = [], 0.0
        for b, (_, w, _, _, nwin) in enumerate(jobs):
            total += float(np.float32(score[b]))
            lo = 0 if w == 0 else V // ref.STRIDE
            hi = int(frames[b]) if w == nwin - 1 else (C - V) // ref.STRIDE
            lab = labels[b, lo:hi]
            parts.append((lab[lab > 0] - 1).numpy().astype(np.uint8))
        out.append((total, np.concatenate(parts)))
    return out


def test_basecaller_calls_bases_as_the_reference():
    """``Basecaller``'s DAC and signal routes for a CRF model on the CPU: each read's bases as the reference's windows give them, and
    its score within float32's rounding of theirs."""
    sd = bonito_state_dict()
    reads = _dac_reads()
    caller = basecall.Basecaller(port_model(), None, batch_size=BATCH,
                                 chunk_size=C, overlap=V, device="cpu")
    got = caller.basecall_dac_reads(reads)
    sigs = caller.basecall_signals([basecall.normalise_dac_f32(*r)
                                    for r in reads])
    want = _reference_calls(sd, reads)
    for g, s, w in zip(got, sigs, want):
        assert np.array_equal(g[1], w[1])
        assert np.array_equal(s[1], w[1])
        assert g[0] == pytest.approx(w[0], rel=1e-5)
        assert 0.2 * len(w[1]) < len(g[1])


def test_basecaller_takes_a_crf_model_only_chunked_to_bases():
    """Whatever ``chunked``, ``output``, ``transducer`` and ``kmer_len``
    ask, a CRF model basecalls chunked to bases; an alphabet other than
    ACGT is refused."""
    layer = port_model()
    for kw in ({"chunked": False, "output": "bases"},
               {"chunked": True, "output": "states"},
               {"chunked": False, "output": "states", "transducer": False}):
        caller = basecall.Basecaller(layer, 5, device="cpu", **kw)
        assert (caller.chunked, caller.output, caller.kmer_len) == (
            True, "bases", None)
    with pytest.raises(ValueError, match="CRF model"):
        basecall.Basecaller(layer, None, alphabet="ACGTX", device="cpu")
    assert basecall.crf_head(layer) is layer.layers[-1]
    assert basecall.crf_head(models.pretrained_standin()) is None


def test_model_json_round_trip(tmp_path):
    layer = port_model()
    path = str(tmp_path / "bonito.json")
    serialize.save_model_json(path, layer)
    again, params = serialize.load_model_json(path)
    assert params is not None
    assert json.dumps(again.to_json()) == json.dumps(layer.to_json())
    x, lengths = _signal(300, 2)
    with torch.no_grad():
        a = layer.apply_with_lengths(x, lengths)
        b = again.apply_with_lengths(x, lengths)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_basecall_cli_calls_a_crf_model(tmp_path):
    """The ``basecall raw`` CLI on the CPU, given the model as the port's
    JSON: chunked bases, one record a read."""
    from sloika_tpu_torch.cli import basecall as cli
    from sloika_tpu_torch.data import simulate
    path = str(tmp_path / "bonito.json")
    serialize.save_model_json(path, port_model())
    reads = str(tmp_path / "reads")
    simulate.simulate_read_set(reads, 2, genome_len=20000, read_len=1500)
    out = str(tmp_path / "calls.fa")
    assert cli.main(["raw", path, reads, "--device", "cpu", "--output", out,
                     "--chunk_size", str(C), "--overlap", str(V),
                     "--batch", "4"]) == 0
    lines = open(out).read().splitlines()
    assert len(lines) == 4 and all(l.startswith(">") for l in lines[::2])
    assert all(set(l) <= set("ACGT") and l for l in lines[1::2])
    with pytest.raises(ValueError, match="device_collapse off"):
        cli.main(["raw", path, reads, "--device", "cpu", "--output", out,
                  "--device_collapse", "off"])


def test_flops_of_the_published_widths():
    """2,563,956.8 FLOP a sample at features 384: the LSTMs 2,359,296 of
    it."""
    from sloika_tpu_torch.nn import flops
    layer = models.network_factory("bonito_crf")()
    assert flops.flops_per_input_frame(layer) == pytest.approx(2563956.8,
                                                               abs=1e-6)
    assert layer.size == 1280 and flops.downsample(layer) == 5


def test_lstm_forward_plan_takes_384_by_a_cluster():
    """S 384 at the CRF cell's batch: 7 clusters of 16 (an H100's), 74 rows
    a cluster in 10 chunks of 8; past S 384 refused, and at S 256 the
    narrow plan, as before."""
    plan = fused_lstm.lstm_fwd_plan(512, 384)
    assert plan == fused_lstm.lstm_fwd_plan(512, 384, clusters=7)
    assert (plan["mode"], plan["cluster"], plan["threads"]) == (
        "cluster", 16, 384)
    assert (plan["rows"], plan["clusters"], plan["chunks"]) == (74, 7, 10)
    assert plan["smem"] == 222912 <= fused_lstm.SMEM_OPTIN
    # the tail batch of the cell's reads, one row, and two waves
    assert fused_lstm.lstm_fwd_plan(250, 384)["rows"] == 36
    one = fused_lstm.lstm_fwd_plan(1, 384)
    assert (one["rows"], one["clusters"], one["chunks"]) == (1, 1, 1)
    two = fused_lstm.lstm_fwd_plan(1100, 384)
    assert (two["rows"], two["clusters"]) == (79, 14)
    assert fused_lstm.wide_rows() == 80
    narrow = fused_lstm.lstm_fwd_plan(100, 256)
    assert narrow == {"br": 1, "mode": "global", "kq": 0, "stage": 0,
                      "ns": 4, "mw": 16384, "smem": narrow["smem"],
                      "threads": 1024}
    with pytest.raises(ValueError, match="384"):
        fused_lstm.lstm_fwd_plan(8, 385)


def test_lstm_forward_counts_wide_launches_in_the_tracer():
    """``LstmForward.wide_launches`` (the wide route's launches) is one of
    the program's counters."""
    from sloika_tpu_torch import tracing
    counts = tracing.counters()
    assert counts["LstmForward.wide_launches"] == (
        fused_lstm.lstm_forward.wide_launches)
    assert counts["LstmForward.launches"] == fused_lstm.lstm_forward.launches


def test_lstm_forward_wide_entry_points_take_the_wrapper_arguments():
    """The C entry points of ``lstm_fwd_wide.cu`` take as many arguments as
    the wrapper declares (ctypes would pass a short list unchecked)."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(fused_lstm.__file__), "..",
                            "csrc", "lstm_fwd_wide.cu")).read()
    for name, argtypes in fused_lstm.LstmForward._WIDE_ARGTYPES.items():
        found = re.search(r'extern "C" int {}\(([^)]*)\)'.format(name), src)
        assert found, name
        assert len(found.group(1).split(",")) == len(argtypes), name


@pytest.mark.parametrize("S", [257, 320, 384])
@pytest.mark.parametrize("B", [1, 37, 250, 512, 1100, 5000])
@pytest.mark.parametrize("active", [1, 3, 7, 15])
def test_lstm_forward_wide_plan_covers_the_batch(B, S, active):
    """The wide route's plan from a given count of active clusters: every
    row in one cluster, no cluster empty, the fewest waves of ``active``
    clusters, the shared memory under SMEM_OPTIN and as the kernel lays it
    out; a function of its arguments alone."""
    plan = fused_lstm.lstm_fwd_plan(B, S, clusters=active)
    assert plan == fused_lstm.lstm_fwd_wide_plan(B, S, clusters=active)
    rows, n = plan["rows"], plan["clusters"]
    assert rows * n >= B > rows * (n - 1)
    most = fused_lstm.wide_rows()
    waves = -(-B // (active * most))
    assert rows <= most and n <= active * waves
    assert plan["chunks"] == -(-rows // 8) <= fused_lstm.WIDE_MAX_CHUNKS
    assert plan["smem"] == fused_lstm.wide_smem(rows) <= fused_lstm.SMEM_OPTIN
    assert plan["smem"] == 192 + 4 * (8 * plan["chunks"] * 24 * 19
                                      + 8 * 96 + 2 * 12 * 8 * 96)


# -- on the card ---------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("S", [257, 320, 384])
@pytest.mark.parametrize("B", [1, 37, 250, 512, 1100])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("peep", [False, True])
def test_lstm_forward_at_384_matches_twin(cuda_device, S, B, reverse, peep):
    """``lstm_fwd``'s wide route (a cluster of blocks) at bonito's width and
    two narrower, at one row, ragged batches, the CRF cell's batch and one
    past a wave, with zero and nonzero peepholes, against the plain twin on
    valid steps (rows masked from their first step, holes inside); the same
    bits twice, one launch and one wide launch a call; the traces
    (training) refused."""
    T = 48
    rs = np.random.RandomState(B + S)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    xp = f32(rs.normal(size=(T, B, 4 * S)))
    sWT = f32(rs.normal(size=(S, 4 * S)) / np.sqrt(2 * S))
    p = (f32(rs.normal(size=(3, S)) / np.sqrt(S)) if peep
         else torch.zeros((3, S), device=cuda_device))
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T
    valid = np.arange(T)[:, None] < lengths[None, :]
    valid &= rs.uniform(size=(T, B)) > 0.1
    if B > 2:
        valid[:, 2] = False
    mask = torch.from_numpy(valid).to(cuda_device)
    fwd = fused_lstm.lstm_forward
    before = fwd.launches, fwd.wide_launches
    h, none = fwd(xp, sWT, p, mask=mask, reverse=reverse, emit_cout=False)
    assert (fwd.launches, fwd.wide_launches) == (before[0] + 1,
                                                 before[1] + 1)
    again, _ = fwd(xp, sWT, p, mask=mask, reverse=reverse, emit_cout=False)
    assert none is None and fwd.wide_launches == before[1] + 2
    href, _ = fused_lstm.lstm_scan_plain(xp, sWT, p, mask, reverse)
    assert float((h - href).abs().max()) <= 1e-4
    assert torch.equal(h, again)
    with pytest.raises(ValueError, match="256"):
        fwd(xp, sWT, p, mask=mask, emit_cout=True)


@pytest.mark.gpu
def test_lstm_forward_wide_clocked_build_gives_the_same_bits(cuda_device):
    """``bench_lstm --wide --clocks``: the clocked build of the wide route
    computes the port's bits, and its phases sum to under the loop."""
    from sloika_tpu_torch.scripts import bench_lstm
    T, B, S = 40, 100, 384
    xp, sWT, p, _, mask = bench_lstm.inputs(T, B, S, cuda_device)
    h = fused_lstm.lstm_forward(xp, sWT, p, mask=mask, emit_cout=False)[0]
    split = bench_lstm.wide_step_clocks(xp, sWT, p, mask, h)
    phases = split["phases_mean"]
    assert set(phases) == set(bench_lstm.WIDE_PHASES)
    assert all(v >= 0 for v in phases.values())
    assert sum(phases.values()) <= split["cycles_per_step"] * 1.001
    assert len(split["phases_by_warp"]) == fused_lstm.WIDE_THREADS // 32


@pytest.mark.gpu
@pytest.mark.parametrize("N", [4, 16, 64, 256])
def test_crf_kernels_match_twin(cuda_device, N):
    """Scores and labels of the kernels against the plain twin on the card,
    rows ragged (none, one and all frames); one call a batch."""
    rs = np.random.RandomState(N)
    T, B = 301, 37
    scores = torch.from_numpy((np.tanh(rs.normal(size=(T, B, 5 * N))) * 5)
                              .astype(np.float32)).to(cuda_device)
    frames = torch.from_numpy(rs.randint(1, T + 1, size=B)).to(cuda_device)
    frames[0], frames[1], frames[2] = T, 0, 1
    before = cd.crf_decode.launches
    score, labels = cd.crf_decode(scores, frames)
    assert cd.crf_decode.launches == before + 1
    want_score, want_labels = cd.crf_decode_plain(scores, frames)
    assert torch.equal(labels, want_labels)
    assert torch.allclose(score, want_score, rtol=2e-6, atol=1e-5)
    again = cd.crf_decode(scores, frames)
    assert torch.equal(again[0], score) and torch.equal(again[1], labels)


@pytest.mark.gpu
def test_basecaller_on_the_card_launches_once_a_batch(cuda_device):
    """The DAC route on the card at small widths: the CPU route's bases,
    one CRF decode and five LSTM launches a window batch."""
    reads = _dac_reads(4)
    cpu = basecall.Basecaller(port_model(), None, batch_size=BATCH,
                              chunk_size=C, overlap=V, device="cpu")
    want = cpu.basecall_dac_reads(reads)
    card = basecall.Basecaller(port_model(), None, batch_size=BATCH,
                               chunk_size=C, overlap=V, device=cuda_device)
    jobs = basecall._window_jobs([len(d) for d, _ in reads], C, V)
    batches = -(-len(jobs) // BATCH)
    crf0, lstm0 = cd.crf_decode.launches, fused_lstm.lstm_forward.launches
    got = card.basecall_dac_reads(reads)
    assert cd.crf_decode.launches - crf0 == batches
    assert fused_lstm.lstm_forward.launches - lstm0 == 5 * batches
    for g, w in zip(got, want):
        assert np.array_equal(g[1], w[1])
        assert g[0] == pytest.approx(w[0], rel=1e-4)


def test_lstm_runs_the_inference_variant_outside_grad_mode(monkeypatch):
    """Under ``torch.inference_mode`` (the Basecaller's) the LSTM asks the
    forward for no cell or gate trace, which S = 384 has not."""
    asked = []
    real = fused_lstm.lstm_forward

    def spy(*args, **kwargs):
        asked.append(kwargs.get("emit_cout", True))
        return real(*args, **kwargs)

    monkeypatch.setattr(fused_lstm, "lstm_forward", spy)
    layer = nn.Lstm(6, 5, has_bias=True)
    x = torch.randn(7, 2, 6)
    with torch.inference_mode():
        layer(x)
    with torch.no_grad():
        layer(x)
    layer(x).sum().backward()
    assert asked == [False, False, True]


def test_the_reference_imports_torch_alone():
    """The plain reference imports ``torch`` and the standard library
    alone: no module of the port, nothing of JAX."""
    import ast
    import sys
    with open(ref.__file__) as fh:
        tree = ast.parse(fh.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots - set(sys.stdlib_module_names) == {"torch"}, roots
