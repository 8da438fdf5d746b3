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


#: cards' answers to cudaOccupancyMaxActiveClusters for the general plan:
#: the H100's (the default), a card that runs any cluster of every row at
#: once, one that runs none in one wave, and each size forced alone
CLUSTER_LIMITS = {"h100": None, "all": {C: 10 ** 6 for C in (1, 2, 4, 8, 16)},
                  "none": {C: 0 for C in (1, 2, 4, 8, 16)},
                  **{"only{}".format(C): {C: 10 ** 6} for C in (2, 8, 16)}}


@pytest.mark.parametrize("limits", sorted(CLUSTER_LIMITS))
@pytest.mark.parametrize("B", (1, 8, 1024))
@pytest.mark.parametrize("nbase,klen", [(2, 2), (2, 14), (3, 4), (3, 9),
                                        (4, 7), (4, 8), (5, 6), (10, 2),
                                        (10, 4)])
def test_viterbi_general_plan_fits(nbase, klen, B, limits):
    """The general route's plan: a cluster of C blocks a row, C a power of
    two at most nbase^2 that divides the skip groups, the largest whose B
    clusters run in one wave on the card given (else the smallest that
    fits); a block's arrays in shared memory with a ring of two slots
    beside them where that fits, else C = 1 with the arrays in device
    memory; at most GENERAL_MAX_SLOTS slots; from the shapes and the card's
    answers alone."""
    K = nbase ** klen
    clusters = CLUSTER_LIMITS[limits]
    plan = vk.viterbi_general_plan(B, K, nbase, clusters=clusters)
    assert plan == vk.viterbi_general_plan(B, K, nbase, SMEM_OPTIN, clusters)
    shapes = vk.general_cluster_shapes(K, nbase)
    nrk = K // nbase ** 2
    C = plan["C"]
    assert C in vk.GENERAL_CLUSTERS and nrk % C == 0 and C <= nbase ** 2
    KC = K // C
    slot = plan["slot_bytes"]
    assert slot % 16 == 0 and slot >= 16 + 4 * KC + 12
    assert plan["smem"] <= SMEM_OPTIN
    assert plan["nslots"] in (0,) + tuple(range(vk.GENERAL_MIN_SLOTS,
                                                vk.GENERAL_MAX_SLOTS + 1))
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 1024
    # a thread a step group, where a block has at most 1,024 of them; in a
    # cluster, a block's skip groups in 16-byte runs
    assert plan["threads"] >= min(1024, KC // nbase)
    assert C == 1 or (nrk // C) % 4 == 0
    KC4 = -(-KC // 4) * 4
    # both parities' scores (its inputs), or in a cluster its scores, both
    # parities' inputs (step and skip predecessors) and every block's
    # addresses
    arrays = 8 * KC4 if C == 1 else 20 * KC4 + 4 * (-(-2 * C // 4) * 4)
    fits = vk.FWD_BAR_BYTES + 8 * -(-K // 4) * 4 + 2 * slot <= SMEM_OPTIN
    assert plan["shared"] == bool(shapes)
    if not plan["shared"]:
        assert not fits and C == 1
        assert plan["work_floats"] >= 2 * K
        assert plan["smem"] == vk.FWD_BAR_BYTES + plan["nslots"] * slot
        return
    assert plan["work_floats"] == 0 and plan["nslots"] >= 2
    assert plan["smem"] >= vk.FWD_BAR_BYTES + arrays + plan["nslots"] * slot
    # the deepest ring that fits
    assert (plan["nslots"] == vk.GENERAL_MAX_SLOTS
            or plan["smem"] + slot > SMEM_OPTIN)
    limit = vk.H100_CLUSTERS if clusters is None else clusters
    wave = [c for c in shapes if B <= limit.get(c, 0)]
    if wave:
        # every row's cluster in one wave, each block on an SM of its own
        assert C == max(wave) and B <= limit[C]
        assert 2 * (plan["smem"] + vk.BLOCK_RESERVED) > vk.SM_SMEM
    else:
        assert C == min(shapes)
    if limits.startswith("only") and int(limits[4:]) in shapes:
        assert C == int(limits[4:])
    if (nbase, klen, B, limits) == (4, 7, 8, "h100"):
        # 7 clusters of 16 hold 7 of the 8 rows: 8 blocks a row
        assert (C, plan["threads"], plan["nslots"]) == (8, 512, 8)
    if (nbase, klen, B, limits) == (4, 8, 8, "h100"):
        # klen 8's arrays fit the cluster's shared memory
        assert (C, plan["shared"]) == (8, True)


#: (nbase, klen) of every alphabet whose codes fit int8 (nbase + nbase^2
#: <= 128), from klen 2 to the first K whose two frames no longer fit
#: shared memory; klen 7 and 8 over 4 bases among them
BACK_GENERAL_SHAPES = [(n, k) for n in range(2, 11) for k in range(2, 18)
                       if k == 2 or 2 * -(-(n ** (k - 1) + 15) // 16) * 16
                       + vk.BACK_BAR_BYTES <= SMEM_OPTIN]


@pytest.mark.parametrize("B", (8, 1024))
@pytest.mark.parametrize("nbase,klen", BACK_GENERAL_SHAPES)
def test_viterbi_back_general_plan_fits_or_reads_device_memory(nbase, klen,
                                                               B):
    """The general backtrace's plan covers every shape the general route
    takes: tensor-map boxes over 4 bases at a power-of-two K, else each
    frame's 16-byte-aligned superset by a bulk copy, F frames a slot, two
    to BACK_MAX_SLOTS slots in shared memory; where a frame is larger than
    GENERAL_RING_BYTES or two slots do not fit, no ring (every frame read
    from device memory)."""
    K, T = nbase ** klen, 22543
    plan = vk.viterbi_back_general_plan(B, K, T, nbase)
    tensor = nbase == 4
    superset = -(-(K + 15) // 16) * 16
    frame = K if tensor else superset
    assert plan["F"] in vk.BACK_FRAMES
    assert plan["smem"] == (vk.BACK_BAR_BYTES
                            + plan["nslots"] * plan["slot_bytes"])
    assert plan["smem"] <= SMEM_OPTIN
    assert plan["blocks"] >= _resident(B, vk.BACK_THREADS)
    if (frame > vk.GENERAL_RING_BYTES
            or vk.BACK_BAR_BYTES + 2 * frame > SMEM_OPTIN):
        # the bulk kernel without a ring
        assert plan["copy"] == "none" and plan["frame_bytes"] == superset
        assert plan["nslots"] == 0 and plan["F"] == 1
        return
    assert plan["frame_bytes"] == frame
    assert vk.BACK_MIN_SLOTS <= plan["nslots"] <= vk.BACK_MAX_SLOTS
    if tensor:
        assert plan["copy"] == "tensor"
        assert plan["slot_bytes"] == -(-plan["F"] * K // 128) * 128
        assert plan["F"] == 1 or plan["F"] * K <= vk.BACK_SLOT_BYTES
    else:
        assert plan["copy"] == "bulk" and frame % 16 == 0
        assert plan["slot_bytes"] == plan["F"] * frame
        assert (plan["F"] == 1
                or plan["F"] * frame <= vk.GENERAL_SLOT_BYTES)
    if (nbase, klen, B) == (4, 7, 8):
        assert (plan["copy"], plan["F"], plan["nslots"]) == ("tensor", 1, 14)
    if (nbase, klen, B) == (5, 5, 8):
        assert (plan["F"], plan["nslots"], frame) == (16, 4, 3152)


@pytest.mark.parametrize("optin,copy", [(1000, "none"), (4096, "none"),
                                        (40000, "tensor")])
def test_viterbi_back_general_plan_on_small_cards(optin, copy):
    """A card of little shared memory: the ring where two slots fit, else
    none."""
    plan = vk.viterbi_back_general_plan(2, 4 ** 7, 40, 4, optin=optin)
    assert plan["smem"] <= optin and plan["copy"] == copy
    assert plan["nslots"] == (0 if copy == "none" else 2)


def test_viterbi_back_general_plan_copies_by_alignment():
    """A traceback off a 16-byte boundary takes the bulk copies at klen 7
    (the tensor map reads 16-byte units)."""
    plan = vk.viterbi_back_general_plan(8, 4 ** 7, 100, 4, aligned=False)
    assert (plan["copy"], plan["frame_bytes"]) == ("bulk", 16400)


@pytest.mark.parametrize("K,nbase", [(80, 3), (12, 4), (130, 11), (1, 2)])
def test_viterbi_back_general_plan_rejects_other_codes(K, nbase):
    with pytest.raises(ValueError, match="K = {} states over nbase {}"
                       .format(K, nbase)):
        vk.viterbi_back_general_plan(8, K, 100, nbase)


def test_viterbi_back_general_plan_rejects_2_to_the_24_states():
    with pytest.raises(ValueError, match="K = 16777216 states over nbase 2"):
        vk.viterbi_back_general_plan(8, 2 ** 24, 100, 2)


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
@pytest.mark.parametrize("optin,cluster", [
    (None, None), (1000, None), (4096, None), (None, 1), (None, 2),
    (None, 4), (None, 8), (None, 16)])
@pytest.mark.parametrize("klen,nbase,T,B", [
    (7, 4, 40, 2), (4, 3, 60, 3), (2, 3, 30, 1), (6, 5, 12, 2),
    (2, 2, 25, 5), (2, 10, 9, 2), (9, 3, 5, 1), (7, 4, 1, 2),
    (8, 4, 6, 2), (14, 2, 7, 1), (4, 10, 8, 2), (7, 4, 30, 9),
    (5, 8, 6, 2), (3, 7, 70, 3), (5, 5, 80, 3), (8, 4, 40, 1)])
def test_the_general_route_equals_the_twins(cuda_device, monkeypatch, klen,
                                            nbase, T, B, optin, cluster):
    """klen 7 (16,384 states), klen 8 (65,536) and nbase 2, 3, 5, 7, 8 and
    10 take the kernels' general route on the card: the twins' bits (scores,
    codes, path and moves), on the card's own device, counted in
    ``launches`` and ``general_launches``.  ``optin``: a card of that little
    shared memory, so the step's scores lie in device memory (and the ring
    has two slots, or none).  ``cluster``: a card that runs clusters of that
    size only, so the plan takes it wherever the shape allows (B = 9 at
    klen 7 leaves the H100's 16s for 8s; nbase 8 at klen 5 sends 72 runs a
    step to 16 blocks)."""
    if optin is not None:
        monkeypatch.setattr(vk, "_device_limits", lambda dev: (SMS, optin))
    K = nbase ** klen
    if cluster is not None:
        monkeypatch.setattr(vk.viterbi_forward, "general_clusters",
                            lambda K, nbase, device: {cluster: 10 ** 6})
        limits = vk._device_limits(cuda_device)
        if cluster in vk.general_cluster_shapes(K, nbase, limits[1]):
            plan = vk.viterbi_general_plan(B, K, nbase, limits[1],
                                           {cluster: 10 ** 6})
            assert plan["C"] == cluster
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
def test_the_cards_clusters_take_klen_7_over_8_blocks(cuda_device):
    """The card's answer for the general kernel at klen 7: at least one
    cluster of every size the shape allows, and a plan at the whole-read
    batch of 8 whose clusters all run in one wave, of 8 blocks or more."""
    K = 4 ** 7
    clusters = vk.viterbi_forward.general_clusters(K, 4, cuda_device)
    assert set(clusters) == set(vk.general_cluster_shapes(
        K, 4, vk._device_limits(cuda_device)[1]))
    assert all(n >= 1 for n in clusters.values())
    plan = vk.viterbi_general_plan(8, K, 4, vk._device_limits(cuda_device)[1],
                                   clusters)
    assert plan["C"] >= 8 and clusters[plan["C"]] >= 8


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
@pytest.mark.parametrize("offset", [1, 8, 16])
@pytest.mark.parametrize("klen,nbase,T,B", [(5, 5, 90, 3), (7, 4, 40, 2),
                                            (8, 4, 12, 2), (4, 3, 300, 3),
                                            (3, 7, 50, 1)])
def test_the_general_backtrace_reads_a_view(cuda_device, klen, nbase, T, B,
                                            offset):
    """The general backtrace on a traceback that starts ``offset`` bytes
    into its storage (16: aligned; 1 and 8: not, so every frame's superset
    starts below it) and ends at the storage's end, where the last frames'
    supersets would run past it (those are read from device memory): the
    twin's path and moves."""
    post = _softmax_posterior(klen, nbase, T, B, seed=klen + offset)
    v, tb = vk.viterbi_forward(post.to(cuda_device), klen, skip_pen=5.0,
                               nbase=nbase)
    base = torch.empty(tb.numel() + offset, dtype=torch.int8,
                       device=cuda_device)
    view = base[offset:].view(tb.shape)
    view.copy_(tb)
    last = torch.argmax(v, dim=1)
    n = vk.viterbi_backtrace.general_launches
    got = vk.viterbi_backtrace(view, last, nbase=nbase)
    ref = decode.viterbi_backtrace_plain(tb, last, nbase=nbase)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert vk.viterbi_backtrace.general_launches == n + 1


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


def _peaked_model(nstate, seed, scale=8.0):
    """A convolution (stride 5) and a softmax over ``nstate`` states with
    weights of sd ``scale``: at 8 a peaked posterior, far from the
    transducer Viterbi's round-off ties."""
    from sloika_tpu_torch import nn
    rs = np.random.RandomState(seed)
    conv = nn.Convolution(1, 16, 11, stride=5)
    out = nn.Softmax(16, nstate)
    with torch.no_grad():
        conv.W.copy_(torch.from_numpy(rs.normal(size=(16, 1, 11))
                                      .astype(np.float32)))
        out.W.copy_(torch.from_numpy(scale * rs.normal(size=(nstate, 16))
                                     .astype(np.float32)))
    reads = [rs.normal(size=n).astype(np.float32) for n in (1500, 2600)]
    return nn.Serial([conv, out]), reads


@pytest.mark.gpu
@pytest.mark.parametrize("chunked", (False, True))
def test_basecaller_nbase_5_decodes_on_the_card(cuda_device, chunked):
    """A 5-letter transducer (``alphabet=b"ACGTX"``, 126 states at klen 3),
    whole reads and the chunked "states" route: the CPU path's calls,
    through the kernels' general route on every launch."""
    from sloika_tpu_torch import basecall as tbc
    layer, reads = _peaked_model(5 ** 3 + 1, 19)
    kw = dict(alphabet=b"ACGTX", batch_size=2, chunked=chunked,
              chunk_size=1000, overlap=100)
    ref = tbc.Basecaller(copy.deepcopy(layer), 3, device="cpu",
                         **kw).basecall_signals(reads)
    wrappers = (vk.viterbi_forward, vk.viterbi_backtrace)
    before = [(k.launches, k.general_launches) for k in wrappers]
    got = tbc.Basecaller(layer, 3, device=cuda_device,
                         **kw).basecall_signals(reads)
    after = [(k.launches, k.general_launches) for k in wrappers]
    assert all(a[0] - b[0] == a[1] - b[1] > 0
               for a, b in zip(after, before))
    for (gs, gc), (rs_, rc) in zip(got, ref):
        assert np.array_equal(gc, rc) and len(gc) > 10
        assert abs(gs - rs_) <= 1e-4 * abs(rs_)


def _legacy_decoder_inputs(caller, read):
    """The floored posterior of one read as the legacy decoder sees it (the
    bad state's frames and column dropped, rows renormalised) and its
    log-scaled per-event transition weights, as ``decode_post_host``
    computes them."""
    from sloika_tpu_torch.ops import olddecode
    x = torch.from_numpy(read.reshape(len(read), 1, 1)).to(caller.device)
    lengths = torch.tensor([len(read)], device=caller.device)
    with torch.inference_mode():
        post, frames = caller._floored_masked_post(x, lengths)
    post = post[:int(frames[0]), 0].float().cpu().numpy()
    post = post[np.argmax(post, axis=1) > 0, 1:]
    post = post / np.sum(post, axis=1, keepdims=True)
    trans = olddecode.estimate_transitions(post)
    return post, np.log(1e-10 + trans)


def _legacy_path_score(post, ltrans, path):
    """The legacy decoder's objective (``olddecode.decode_profile``, no
    slip) for one state path: each event's log posterior plus the best
    weight of the moves (stay, step, skip, slip) that join its state to the
    next."""
    eta = 1e-10
    lpost = np.log(np.asarray(post, dtype=float) + eta)
    nkmer = post.shape[1]
    w = np.array(ltrans, dtype=float)[:len(post) - 1].copy()
    w[:, 1] -= np.log(4)
    w[:, 2] -= np.log(16)
    score = lpost[0, path[0]]
    for ev in range(len(path) - 1):
        a, b = int(path[ev]), int(path[ev + 1])
        cand = [np.log(eta)]
        if a == b:
            cand.append(w[ev, 0])
        if b in (a * 4 + np.arange(4)) % nkmer:
            cand.append(w[ev, 1])
        if b in (a * 16 + np.arange(16)) % nkmer:
            cand.append(w[ev, 2])
        score += max(cand) + lpost[ev + 1, b]
    return score


@pytest.mark.parametrize("scale", (0.5, 8.0))
def test_the_legacy_decoders_score_is_its_paths_score(scale):
    """``_legacy_path_score`` of the CPU path's own call is the score the
    legacy decoder returned, flat and peaked posteriors alike."""
    from sloika_tpu_torch import basecall as tbc
    layer, reads = _peaked_model(4 ** 3 + 1, 23, scale=scale)
    caller = tbc.Basecaller(layer, 3, device="cpu", transducer=False,
                            bad=True, batch_size=2)
    for (score, path), read in zip(caller.basecall_signals(reads), reads):
        post, ltrans = _legacy_decoder_inputs(caller, read)
        assert len(path) == len(post) > 10
        assert abs(_legacy_path_score(post, ltrans, path) - score) <= \
            1e-9 * abs(score)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", (0.5, 8.0))
def test_nontransducer_basecaller_runs_the_forward_on_the_card(cuda_device,
                                                               scale):
    """A non-transducer with a bad state: the forward and the floor on the
    card, no Viterbi launch, the legacy decoder on the host.

    At sd 0.5 no state sits at the ``min_prob`` floor, and the calls are
    the CPU path's.  At sd 8 (a peaked posterior, as a trained model's is)
    most of the floored posterior is the floor, whose exact ties the legacy
    decoder breaks by the round-off of the states just above it: a 1e-6
    relative change of the posterior can move its path between paths of
    equal score.  There the card's score is the CPU's within 1e-4, and the
    card's path, scored on the CPU's posterior, is as good as the CPU's
    within 1e-4."""
    from sloika_tpu_torch import basecall as tbc
    layer, reads = _peaked_model(4 ** 3 + 1, 23, scale=scale)
    kw = dict(transducer=False, bad=True, batch_size=2)
    cpu = tbc.Basecaller(copy.deepcopy(layer), 3, device="cpu", **kw)
    ref = cpu.basecall_signals(reads)
    before = vk.viterbi_forward.launches
    caller = tbc.Basecaller(layer, 3, device=cuda_device, **kw)
    assert next(caller.layer.parameters()).is_cuda
    got = caller.basecall_signals(reads)
    assert vk.viterbi_forward.launches == before
    for (gs, gc), (rs_, rc), read in zip(got, ref, reads):
        assert len(gc) == len(rc) > 10
        assert abs(gs - rs_) <= 1e-4 * abs(rs_)
        if scale < 1:
            assert np.array_equal(gc, rc)
        else:
            post, ltrans = _legacy_decoder_inputs(cpu, read)
            assert abs(_legacy_path_score(post, ltrans, gc) - rs_) <= \
                1e-4 * abs(rs_)


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


@pytest.mark.gpu
def test_the_general_route_clocked_build_gives_the_same_bits(cuda_device):
    """``bench_viterbi --clocks`` at klen 7: the clocked general kernel
    computes the port's bits, stamps every phase and measures a cluster
    barrier, a remote load and a push's hop; the clocked general
    backtrace computes the port's path and moves at klen 7 and nbase 5 and
    stamps its walker and copier."""
    from sloika_tpu_torch.scripts import bench_viterbi
    post = _softmax_posterior(7, 4, 50, 2, seed=9).to(cuda_device)
    ref = vk.viterbi_forward(post, 7, bench_viterbi.SKIP_PEN)
    split = bench_viterbi.fwd_clocks(post, ref, klen=7)
    assert split["cycles_per_step"] > 0
    assert set(split["phases_mean"]) == set(bench_viterbi.GENERAL_PHASES)
    assert split["plan"]["C"] >= 8
    assert split["cluster_barrier_cycles"] > 0
    assert split["remote_load_cycles"] > 0
    assert 0 < split["design_floor_ms"] < split["ms"]
    # the general backtrace's clocked build, at klen 7 and at nbase 5
    for klen, nbase, post in ((7, 4, post), (5, 5, _softmax_posterior(
            5, 5, 70, 2, seed=3).to(cuda_device))):
        v, tb = vk.viterbi_forward(post, klen, 5.0, nbase=nbase)
        last = torch.argmax(v, dim=1)
        back = bench_viterbi.back_clocks(
            tb, last, vk.viterbi_backtrace(tb, last, nbase=nbase), nbase)
        assert back["walker"]["loop"] > 0 and back["copier"]["loop"] > 0
        assert back["walker"]["walk"] > 0
        assert back["smem_chase_cycles"] > 0


#: (klen, nbase, T, B) of every route of the forward at bfloat16: the pair
#: route (B = 8), the single route with 4 destinations a thread (B = 100)
#: and with 8 (B = 1,024), K = 4,096 (klen 6), a short read whose last row
#: runs past its storage's end, and the general route at klen 7 and at
#: nbase 3
BF16_ROUTES = [(5, 4, 300, 8), (5, 4, 40, 100), (5, 4, 20, 1024),
               (6, 4, 60, 8), (6, 4, 30, 140), (3, 4, 17, 3), (2, 4, 37, 1),
               (7, 4, 40, 2), (4, 3, 60, 3), (7, 4, 30, 9)]


def _bf16_equals_f32_on_the_upcast(post, klen, nbase=4):
    """The forward on a bfloat16 posterior: the bits of the forward fed its
    float32 upcast and of the plain twin on it (codes, final scores), and
    the same decoded path."""
    v, tb = vk.viterbi_forward(post, klen, skip_pen=5.0, nbase=nbase)
    v32, tb32 = vk.viterbi_forward(post.float(), klen, skip_pen=5.0,
                                   nbase=nbase)
    v_ref, tb_ref = decode.viterbi_forward_plain(post, klen, skip_pen=5.0,
                                                 nbase=nbase)
    assert v.dtype == torch.float32 and tb.dtype == torch.int8
    assert torch.equal(v, v32) and torch.equal(tb, tb32)
    assert torch.equal(v, v_ref) and torch.equal(tb, tb_ref)
    last = torch.argmax(v, dim=1)
    got = vk.viterbi_backtrace(tb, last, nbase=nbase)
    ref = vk.viterbi_backtrace(tb32, torch.argmax(v32, dim=1), nbase=nbase)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["peaked", "ties"])
@pytest.mark.parametrize("klen,nbase,T,B", BF16_ROUTES)
def test_viterbi_fwd_bf16_every_route(cuda_device, klen, nbase, T, B, kind):
    post = _softmax_posterior(klen, nbase, T, B, seed=klen + B)
    if kind == "ties":
        post = torch.round(post * 8) / 8 + 1e-3
    post = post.to(torch.bfloat16).to(cuda_device)
    wrappers = (vk.viterbi_forward, vk.viterbi_backtrace)
    before = [(k.launches, k.general_launches) for k in wrappers]
    _bf16_equals_f32_on_the_upcast(post, klen, nbase)
    general = vk.kernel_route(nbase ** klen, klen, nbase) == "general"
    # the two forwards and the two backtraces of the check launched
    assert [(k.launches - n, k.general_launches - g)
            for k, (n, g) in zip(wrappers, before)] == [
        (2, 2 * general), (2, 2 * general)]


@pytest.mark.gpu
@pytest.mark.parametrize("klen,nbase", [(5, 4), (4, 3)])
@pytest.mark.parametrize("shift", range(1, 8))
def test_viterbi_fwd_bf16_views_at_every_offset(cuda_device, klen, nbase,
                                                shift):
    """A bfloat16 posterior that starts ``shift`` elements (2 shift bytes)
    into its storage and whose last row ends at the storage's end: each
    row's offset into its 16-byte superset, and the rows left out of the
    ring."""
    post = _softmax_posterior(klen, nbase, 23, 3, seed=shift)
    base = torch.zeros(post.numel() + shift, dtype=torch.bfloat16)
    base[shift:] = post.flatten().to(torch.bfloat16)
    view = base.to(cuda_device)[shift:].view(post.shape)
    _bf16_equals_f32_on_the_upcast(view, klen, nbase)


@pytest.mark.gpu
@pytest.mark.parametrize("optin", [1000, 4096, 20000])
def test_viterbi_fwd_bf16_general_route_small_cards(cuda_device, monkeypatch,
                                                    optin):
    """The general route at bfloat16 on a card of little shared memory: the
    scores in device memory, a ring of no slots or of a few."""
    monkeypatch.setattr(vk, "_device_limits", lambda dev: (SMS, optin))
    post = _softmax_posterior(7, 4, 12, 2, seed=optin)
    _bf16_equals_f32_on_the_upcast(post.to(torch.bfloat16).to(cuda_device),
                                   7)


@pytest.mark.gpu
def test_basecaller_streams_a_bf16_posterior_on_the_card(cuda_device,
                                                         monkeypatch):
    """Under ``config.compute_dtype`` bfloat16 the Basecaller's posterior
    is bfloat16 and reaches the kernels; its calls equal those of a
    float32-posterior Basecaller fed the same posterior's upcast."""
    from sloika_tpu_torch import basecall as tbc, config, models
    monkeypatch.setattr(config, "compute_dtype", torch.bfloat16)
    layer = models.network_factory("raw_1_00_rGr")(
        klen=3, sd=0.5, sizes=(16, 12, 16, 12), stride=5, seed=4)
    caller = tbc.Basecaller(layer, 3, device=cuda_device)
    assert caller.post_dtype == torch.bfloat16
    rs = np.random.RandomState(12)
    x = torch.from_numpy(rs.normal(size=(3000, 2, 1)).astype(np.float32))
    lengths = torch.tensor([3000, 2100])
    with torch.inference_mode():
        post, _ = caller._floored_masked_post(x.to(cuda_device),
                                              lengths.to(cuda_device))
        assert post.dtype == torch.bfloat16
        before = vk.viterbi_forward.launches
        got = caller._forward_decode_states(x.to(cuda_device),
                                            lengths.to(cuda_device))
        assert vk.viterbi_forward.launches == before + 1
        ref = vk.viterbi(post.float(), 3, skip_pen=caller.skip)
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[2], ref[1]) and torch.equal(got[3], ref[2])


def test_viterbi_forward_rejects_other_dtypes():
    post = _posterior(2, "peaked", T=4, B=1)
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            vk.viterbi_forward(post.to(dtype), 2)
