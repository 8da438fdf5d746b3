"""The Viterbi kernels' launch plans, and the kernels against their plain
PyTorch twins (bit for bit).

This file imports no jax, so the ``gpu``-marked tests run on a machine with
a CUDA card and without jax::

    python -m pytest tests/test_torch_viterbi_kernels.py -m gpu --noconftest -q

On a machine without a card they skip; the plan tests run everywhere.
"""
import copy

import numpy as np
import pytest
import torch

from sloika_tpu_torch.ops import decode
from sloika_tpu_torch.ops import viterbi_kernel as vk

SMEM_OPTIN = 232448
SMS = 132
KS = (16, 64, 256, 1024, 4096)
BATCHES = (1, 7, 8, 64, 1024)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _posterior(klen, kind, T, B, seed=0):
    """(T, B, 4^klen + 1) probability-domain posterior: a softmax of
    4 x N(0, 1), or that rounded to eighths (a posterior full of ties)."""
    rs = np.random.RandomState(seed)
    x = 4.0 * rs.standard_normal((T, B, 4 ** klen + 1)).astype(np.float32)
    x = np.exp(x - x.max(axis=2, keepdims=True))
    post = x / x.sum(axis=2, keepdims=True)
    if kind == "ties":
        post = np.round(post * 8) / 8 + 1e-3
    return torch.from_numpy(post.astype(np.float32))


def _resident(B, threads):
    return min(-(-B // SMS), vk.SM_THREADS // threads, vk.SM_BLOCKS)


@pytest.mark.parametrize("pairs", [None, 0])
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("K", KS)
def test_viterbi_fwd_plan_fits(K, B, pairs):
    # pairs=0: a card that runs no cluster of two blocks at once
    plan = vk.viterbi_fwd_plan(B, K, pairs=pairs)
    assert plan["smem"] <= SMEM_OPTIN
    assert plan["row_bytes"] >= 4 * (K + 1) + 12
    assert plan["row_bytes"] % 16 == 0
    if pairs is None and B <= SMS // 2:
        # a DP block and a log block a row, each on an SM of its own
        assert plan["route"] == "pair" and plan["dpt"] == 0
        assert plan["threads"] == min(1024, max(32, K))
        assert plan["G"] in vk.FWD_PAIR_ROWS
        assert vk.FWD_MIN_SLOTS <= plan["nslots"] <= vk.FWD_PAIR_MAX_SLOTS
        assert plan["smem"] >= (vk.FWD_PAIR_BAR_BYTES + 8 * K
                                + (plan["nslots"] + vk.FWD_PAIR_POST_SLOTS)
                                * plan["G"] * plan["row_bytes"])
        assert 2 * plan["smem"] > vk.SM_SMEM - 2 * vk.BLOCK_RESERVED
        return
    # a thread's destinations: 4 where a block has its SM alone, else 8
    assert plan["route"] == "single"
    assert plan["dpt"] == (4 if B <= SMS else 8) and plan["G"] == 1
    assert plan["threads"] == K // plan["dpt"] <= 1024
    assert vk.FWD_MIN_SLOTS <= plan["nslots"] <= vk.FWD_MAX_SLOTS
    assert plan["smem"] == (vk.FWD_BAR_BYTES + plan["nslots"]
                            * plan["row_bytes"] + 8 * K)
    # as many blocks an SM as the batch needs in one wave, or as the
    # design before this one held (K / 4 threads a block), all within the
    # SM's shared memory
    assert plan["blocks"] >= min(_resident(B, plan["threads"]),
                                 _resident(B, K // 4))
    assert plan["blocks"] * (plan["smem"] + vk.BLOCK_RESERVED) <= vk.SM_SMEM


@pytest.mark.parametrize("T", (1, 2, 3277, 22543))
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("K", KS)
def test_viterbi_back_plan_fits(K, B, T):
    plan = vk.viterbi_back_plan(B, K, T)
    assert plan["F"] in vk.BACK_FRAMES
    assert plan["F"] * K <= vk.BACK_SLOT_BYTES or plan["F"] == 1
    assert plan["slot_bytes"] % 128 == 0
    assert plan["slot_bytes"] >= plan["F"] * K
    assert vk.BACK_MIN_SLOTS <= plan["nslots"] <= vk.BACK_MAX_SLOTS
    assert plan["smem"] == (vk.BACK_BAR_BYTES
                            + plan["nslots"] * plan["slot_bytes"])
    assert plan["smem"] <= SMEM_OPTIN
    assert vk.BACK_THREADS <= 1024
    assert plan["blocks"] >= _resident(B, vk.BACK_THREADS)
    assert plan["blocks"] * (plan["smem"] + vk.BLOCK_RESERVED) <= vk.SM_SMEM
    # no more slots than the row has chunks of F frames (but two)
    assert plan["nslots"] <= max(vk.BACK_MIN_SLOTS,
                                 -(-max(T - 1, 0) // plan["F"]))


def test_viterbi_plans_at_the_decode_paths_shapes():
    # a pair of blocks a row at B = 8 and 64; one block of the deepest ring
    # where a block has an SM alone; 8 blocks an SM at B = 1,024
    for B in (8, 64):
        plan = vk.viterbi_fwd_plan(B, 1024)
        assert (plan["route"], plan["G"], plan["nslots"]) == ("pair", 8, 4)
    plan = vk.viterbi_fwd_plan(100, 1024)
    assert (plan["route"], plan["dpt"], plan["nslots"]) == ("single", 4, 16)
    plan = vk.viterbi_fwd_plan(1024, 1024)
    assert (plan["dpt"], plan["blocks"], plan["nslots"]) == (8, 8, 4)
    back = vk.viterbi_back_plan(8, 1024, 22543)
    assert (back["F"], back["nslots"]) == (16, 14)
    back = vk.viterbi_back_plan(1024, 1024, 3277)
    assert (back["F"], back["nslots"], back["blocks"]) == (8, 3, 8)


@pytest.mark.parametrize("klen", range(1, 9))
@pytest.mark.parametrize("nbase", (3, 4, 5))
def test_kernel_route_is_tuned_for_nbase_4_and_klen_2_to_6(nbase, klen):
    K = nbase ** klen
    want = "tuned" if nbase == 4 and 2 <= klen <= 6 else "general"
    assert vk.kernel_route(K, klen, nbase) == want
    # a state count that is not nbase^klen never takes the tuned kernels
    assert vk.kernel_route(K + 1, klen, nbase) == "general"


def test_kernel_route_rejects_codes_past_int8():
    assert vk.kernel_route(100, 2, 10) == "general"
    with pytest.raises(ValueError, match="int8"):
        vk.kernel_route(121, 2, 11)


@pytest.mark.parametrize("B", (1, 8, 1024))
@pytest.mark.parametrize("nbase,klen", [(2, 2), (2, 14), (3, 4), (3, 9),
                                        (4, 7), (4, 8), (5, 6), (10, 2),
                                        (10, 4)])
def test_viterbi_general_plan_fits(nbase, klen, B):
    """The general route's plan: its arrays in shared memory with a ring
    slot beside them where that fits, else in device memory; at most
    GENERAL_MAX_SLOTS slots; from the shapes alone."""
    K = nbase ** klen
    plan = vk.viterbi_general_plan(B, K, nbase)
    assert plan == vk.viterbi_general_plan(B, K, nbase, SMEM_OPTIN)
    nrs = K // nbase
    arrays = 4 * (K + nrs + nrs // nbase) + nrs + nrs // nbase
    row = plan["row_bytes"]
    assert row % 16 == 0 and row >= 4 * (K + 1) + 12
    assert plan["smem"] <= SMEM_OPTIN
    assert 0 <= plan["nslots"] <= vk.GENERAL_MAX_SLOTS
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 1024
    fits = vk.FWD_BAR_BYTES + arrays + row <= SMEM_OPTIN
    assert plan["shared"] == fits
    if fits:
        assert plan["work_floats"] == 0 and plan["nslots"] >= 1
        assert plan["smem"] >= vk.FWD_BAR_BYTES + arrays + plan["nslots"] * row
    else:
        assert 4 * plan["work_floats"] >= arrays
    # the deepest ring that fits
    assert (plan["nslots"] == vk.GENERAL_MAX_SLOTS
            or plan["smem"] + row > SMEM_OPTIN)
    if (nbase, klen) == (4, 7):
        assert (plan["shared"], plan["nslots"], plan["threads"]) == (
            True, 2, 1024)


@pytest.mark.parametrize("K,nbase", [(16385, 4), (4097, 4), (80, 3), (1, 4)])
def test_the_backtrace_rejects_state_counts_of_no_kmer(K, nbase):
    tb = torch.full((3, 1, K), -1, dtype=torch.int8)
    with pytest.raises(ValueError):
        vk.viterbi_backtrace(tb.to("meta"), torch.zeros(1, dtype=torch.long,
                                                        device="meta"),
                             nbase=nbase)


@pytest.mark.parametrize("K", (0, 8, 32, 1000, 1025, 16384))
def test_viterbi_plans_reject_other_state_counts(K):
    with pytest.raises(ValueError):
        vk.viterbi_fwd_plan(8, K)
    with pytest.raises(ValueError):
        vk.viterbi_back_plan(8, K, 100)


def _against_twins(post, klen, skip_pen=5.0):
    """Both kernels on ``post`` (a CUDA tensor) bit-identical to the plain
    twins."""
    v, tb = vk.viterbi_forward(post, klen, skip_pen=skip_pen)
    v_ref, tb_ref = decode.viterbi_forward_plain(post, klen,
                                                 skip_pen=skip_pen)
    assert torch.equal(v, v_ref) and torch.equal(tb, tb_ref)
    last = torch.argmax(v, dim=1)
    path, moved = vk.viterbi_backtrace(tb, last)
    path_ref, moved_ref = decode.viterbi_backtrace_plain(tb, last)
    assert torch.equal(path, path_ref) and torch.equal(moved, moved_ref)
    return tb, last, path


@pytest.mark.gpu
@pytest.mark.parametrize("klen", vk.KLENS)
@pytest.mark.parametrize("kind", ["peaked", "ties"])
def test_viterbi_kernels_every_klen(cuda_device, klen, kind):
    _against_twins(_posterior(klen, kind, T=150, B=5).to(cuda_device), klen)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2, 3, 17, 37])
@pytest.mark.parametrize("B", [1, 3])
def test_viterbi_kernels_short_reads(cuda_device, T, B):
    # T = 17 and 37: not a multiple of a slot's 16 frames (K = 1,024), and
    # T B odd, so the posterior's last row runs past its storage's 16-byte
    # end and is read from device memory
    _against_twins(_posterior(5, "peaked", T, B, seed=T).to(cuda_device), 5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["peaked", "ties"])
def test_viterbi_kernels_long_whole_reads(cuda_device, kind):
    _against_twins(_posterior(5, kind, T=5000, B=8, seed=3).to(cuda_device),
                   5)


@pytest.mark.gpu
@pytest.mark.parametrize("klen", [3, 5])
def test_viterbi_kernels_production_batch(cuda_device, klen):
    _against_twins(_posterior(klen, "peaked", T=40, B=1024,
                              seed=4).to(cuda_device), klen)


#: (B, klen, T): each side of every boundary of the plans.  K = 1,024: B
#: 132 | 133, the forward's 4 | 8 destinations a thread and 1 | 2 blocks an
#: SM, the backtrace's 14 | 7 slots; 396 | 397, the forward's 16 | 11
#: slots; 792 | 793, the backtrace's slots of 16 | 8 frames; 924 | 925,
#: the forward's 5 | 4 slots.  K = 4,096: 132 | 133, the forward's 12 | 5
#: slots; 264 | 265, its 2 | 3 blocks an SM.  K = 256 at 8 blocks an SM,
#: and a backtrace ring capped by a short row's chunks
PLAN_BOUNDARIES = [(132, 5, 50), (133, 5, 50), (396, 5, 40), (397, 5, 40),
                   (792, 5, 30), (793, 5, 30), (924, 5, 30), (925, 5, 30),
                   (132, 6, 20), (133, 6, 20), (264, 6, 20), (265, 6, 20),
                   (1024, 6, 20), (1024, 4, 30), (7, 5, 40), (1, 6, 300),
                   (100, 5, 40), (100, 6, 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,klen,T", PLAN_BOUNDARIES)
def test_viterbi_kernels_at_plan_boundaries(cuda_device, B, klen, T):
    _against_twins(_posterior(klen, "ties", T, B, seed=B).to(cuda_device),
                   klen)


@pytest.mark.gpu
@pytest.mark.parametrize("klen", [5, 6])
def test_viterbi_kernels_at_the_cards_pairs(cuda_device, klen):
    # the forward's route changes where the batch outgrows the clusters of
    # two blocks that the card runs at once
    n = vk.viterbi_forward.pairs(4 ** klen, cuda_device)
    assert n >= 8
    for B in (n, n + 1):
        _against_twins(_posterior(klen, "ties", 30, B, seed=B).to(cuda_device),
                       klen)


@pytest.mark.gpu
def test_viterbi_kernels_on_views(cuda_device):
    # a posterior that is a view into a larger storage (its last row's
    # aligned superset may be copied), and a traceback that does not start
    # on a 16-byte boundary
    big = _posterior(4, "peaked", T=61, B=3, seed=8).to(cuda_device)
    post = big[1:-1]
    assert post.is_contiguous()
    tb_ref = _against_twins(post, 4)[0]
    base = torch.empty(tb_ref.numel() + 1, dtype=torch.int8,
                       device=cuda_device)
    tb = base[1:].view(tb_ref.shape)
    tb.copy_(tb_ref)
    last = torch.zeros(tb.shape[1], dtype=torch.int64, device=cuda_device)
    got = vk.viterbi_backtrace(tb, last)
    ref = decode.viterbi_backtrace_plain(tb, last)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def _softmax_posterior(klen, nbase, T, B, seed):
    rs = np.random.RandomState(seed)
    x = 4.0 * rs.standard_normal((T, B, nbase ** klen + 1))
    return torch.from_numpy((np.exp(x) / np.exp(x).sum(2, keepdims=True))
                            .astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("optin", [None, 1000, 4096])
@pytest.mark.parametrize("klen,nbase,T,B", [
    (7, 4, 40, 2), (4, 3, 60, 3), (2, 3, 30, 1), (6, 5, 12, 2),
    (2, 2, 25, 5), (2, 10, 9, 2), (9, 3, 5, 1), (7, 4, 1, 2)])
def test_the_general_route_equals_the_twins(cuda_device, monkeypatch, klen,
                                            nbase, T, B, optin):
    """klen 7 (16,384 states) and nbase 2, 3, 5 and 10 take the kernels'
    general route on the card: the twins' bits (scores, codes, path and
    moves), on the card's own device, counted in ``launches`` and
    ``general_launches``.  ``optin``: a card of that little shared memory,
    so the step's arrays lie in device memory (and the ring has one slot,
    or none)."""
    if optin is not None:
        monkeypatch.setattr(vk, "_device_limits", lambda dev: (SMS, optin))
    post = _softmax_posterior(klen, nbase, T, B, seed=klen + nbase)
    for kind in ("peaked", "ties"):
        if kind == "ties":
            post = (torch.round(post * 8) / 8 + 1e-3).contiguous()
        wrappers = (vk.viterbi_forward, vk.viterbi_backtrace)
        before = [(k.launches, k.general_launches) for k in wrappers]
        p = post.to(cuda_device)
        v, tb = vk.viterbi_forward(p, klen, skip_pen=5.0, nbase=nbase)
        v_ref, tb_ref = decode.viterbi_forward_plain(p, klen, skip_pen=5.0,
                                                     nbase=nbase)
        assert torch.equal(v, v_ref) and torch.equal(tb, tb_ref), kind
        last = torch.argmax(v, dim=1)
        got = vk.viterbi_backtrace(tb, last, nbase=nbase)
        ref = decode.viterbi_backtrace_plain(tb, last, nbase=nbase)
        assert all(g.device == p.device for g in got)
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), kind
        assert [(k.launches, k.general_launches) for k in wrappers] == [
            (n + 1, g + 1) for n, g in before]


@pytest.mark.gpu
def test_the_general_route_reads_a_view(cuda_device):
    """A posterior that is a view at an odd float offset, whose last row
    ends at its storage's end (no bulk copy may pass it)."""
    post = _softmax_posterior(4, 3, 30, 2, seed=5)
    base = torch.zeros(post.numel() + 1)
    base[1:] = post.flatten()
    view = base.to(cuda_device)[1:].view(post.shape)
    got = vk.viterbi(view, 4, skip_pen=5.0, nbase=3)
    ref = decode.viterbi(view, 4, skip_pen=5.0, nbase=3)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.gpu
def test_basecaller_klen_7_decodes_on_the_card(cuda_device):
    """``Basecaller(kmer_len=7)`` with a stand-in emitting 16,385 states:
    one read decoded on the card gives the CPU path's call, through the
    kernels' general route (``general_launches``)."""
    from sloika_tpu_torch import basecall as tbc, nn
    rs = np.random.RandomState(17)
    conv = nn.Convolution(1, 16, 11, stride=5)
    out = nn.Softmax(16, 16385)
    with torch.no_grad():
        conv.W.copy_(torch.from_numpy(rs.normal(size=(16, 1, 11))
                                      .astype(np.float32)))
        # large weights: a peaked posterior, far from round-off ties
        out.W.copy_(torch.from_numpy(8.0 * rs.normal(size=(16385, 16))
                                     .astype(np.float32)))
    layer = nn.Serial([conv, out])
    read = rs.normal(size=1500).astype(np.float32)
    cpu = tbc.Basecaller(copy.deepcopy(layer), 7, device="cpu")
    ref = cpu.basecall_signals([read])
    wrappers = (vk.viterbi_forward, vk.viterbi_backtrace)
    before = [(k.launches, k.general_launches) for k in wrappers]
    got = tbc.Basecaller(layer, 7, device=cuda_device).basecall_signals(
        [read])
    after = [(k.launches, k.general_launches) for k in wrappers]
    assert all(a[0] - b[0] == a[1] - b[1] > 0
               for a, b in zip(after, before))
    assert np.array_equal(got[0][1], ref[0][1])
    assert abs(float(got[0][0]) - float(ref[0][0])) <= 1e-4 * abs(
        float(ref[0][0]))


@pytest.mark.gpu
def test_viterbi_kernels_count_launches(cuda_device):
    post = _posterior(3, "peaked", T=20, B=2).to(cuda_device)
    before = (vk.viterbi_forward.launches, vk.viterbi_backtrace.launches)
    vk.viterbi(post, 3, skip_pen=5.0)
    assert (vk.viterbi_forward.launches,
            vk.viterbi_backtrace.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
def test_viterbi_clocked_builds_give_the_same_bits(cuda_device):
    """``bench_viterbi --clocks``: the clocked builds compute what the
    port's builds compute, and report cycles for every phase."""
    from sloika_tpu_torch.scripts import bench_viterbi
    post = _posterior(5, "peaked", T=300, B=3, seed=6).to(cuda_device)
    v, tb = vk.viterbi_forward(post, bench_viterbi.KLEN,
                               bench_viterbi.SKIP_PEN)
    split = bench_viterbi.fwd_clocks(post, (v, tb))
    assert split["cycles_per_step"] > 0
    assert set(split["phases_mean"]) == set(bench_viterbi.FWD_PHASES)
    last = torch.argmax(v, dim=1)
    back = bench_viterbi.back_clocks(tb, last, vk.viterbi_backtrace(tb, last))
    assert back["walker"]["loop"] > 0 and back["copier"]["loop"] > 0
    assert back["smem_chase_cycles"] > 0
