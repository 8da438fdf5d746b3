"""The Viterbi kernels' launch plans, and the kernels against their plain
PyTorch twins (bit for bit).

This file imports no jax, so the ``gpu``-marked tests run on a machine with
a CUDA card and without jax::

    python -m pytest tests/test_torch_viterbi_kernels.py -m gpu --noconftest -q

On a machine without a card they skip; the plan tests run everywhere.
"""
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
