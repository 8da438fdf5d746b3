"""The banded remap kernels against their plain PyTorch twins.

This file imports no jax, so the ``gpu``-marked tests run on a machine with
a CUDA card and without jax::

    python -m pytest tests/test_torch_remap_kernels.py -m gpu --noconftest -q

On a machine without a card they skip; the CPU tests check that each
wrapper hands CPU tensors to its plain twin without counting a launch.
"""
import os
import re

import numpy as np
import pytest
import torch

from sloika_tpu_torch.ops import remap_kernel as rk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def near_linear_case(nframes, nposs, T, P, nstate=66, seed=0, jitter=3):
    """Log-posteriors (T, B, nstate) whose best path runs near the
    diagonal, with stay-padded frames past each row's length, plus the
    sequences and masks (cf. tests/test_remap_banded.py::_make_case)."""
    rs = np.random.RandomState(seed)
    B = len(nframes)
    lt = np.full((T, B, nstate), np.log(1e-6), dtype=np.float32)
    seq = np.zeros((B, P), np.int32)
    mask = np.zeros((B, P), bool)
    for b in range(B):
        npos, tb = nposs[b], nframes[b]
        s = rs.randint(1, nstate, size=npos).astype(np.int32)
        seq[b, :npos] = s
        mask[b, :npos] = True
        base = np.clip(np.arange(tb) * (npos - 1) // max(tb - 1, 1)
                       + rs.randint(-jitter, jitter + 1, size=tb),
                       0, npos - 1)
        base = np.maximum.accumulate(base)
        post = np.full((tb, nstate), 1e-4)
        for t in range(tb):
            if t > 0 and base[t] == base[t - 1] and rs.rand() < 0.5:
                post[t, 0] = 1.0
            else:
                post[t, s[base[t]]] = 1.0
        post /= post.sum(1, keepdims=True)
        lt[:tb, b] = np.log(post)
        lt[tb:, b] = np.log(1e-10)
        lt[tb:, b, 0] = 0.0
    return lt, seq, mask


def _inputs(nframes, nposs, T, P, W, dev, seed=0, nstate=66):
    lt, seq, mask = near_linear_case(nframes, nposs, T, P, nstate=nstate,
                                     seed=seed)
    rs = np.random.RandomState(seed + 1)
    p0 = np.log(rs.uniform(0.1, 1.0, size=(len(nframes), P))) \
        .astype(np.float32)
    TB = rk.block_len(W)
    Tp = -(-T // TB) * TB
    starts = rk.band_starts_blocked(torch.from_numpy(np.asarray(nframes)),
                                    torch.from_numpy(np.asarray(nposs)),
                                    Tp, W, TB)
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(lt), t(seq), t(mask), t(p0), starts.to(dev)


def test_cpu_tensors_take_the_plain_twins():
    lt, seq, mask, p0, starts = _inputs([60, 45], [30, 20], 60, 40, 16,
                                        torch.device("cpu"))
    n0, m0 = rk.remap_banded.launches, rk.remap_backtrack.launches
    tb, vfinal = rk.remap_banded(lt, seq, mask, p0, starts, 3.0, 16)
    ref_tb, ref_v = rk.remap_banded_plain(lt, seq, mask, p0, starts, 3.0, 16)
    assert torch.equal(tb, ref_tb) and torch.equal(vfinal, ref_v)
    last = torch.argmax(vfinal, dim=1).to(torch.int32) + starts[-1]
    assert torch.equal(rk.remap_backtrack(tb, starts, last),
                       rk.remap_backtrack_plain(tb, starts, last))
    assert (rk.remap_banded.launches, rk.remap_backtrack.launches) == (n0, m0)


@pytest.mark.gpu
@pytest.mark.parametrize("W,P,nposs", [
    (64, 256, [200, 150, 90]),          # banded, nbits > 0
    (128, 256, [200, 150, 90]),
    (256, 256, [200, 150, 90]),         # the full-window (exact) form
    (3072, 3072, [2900, 2000, 1200]),   # 256 threads x 12 positions
    (5000, 5000, [4900, 3000, 100]),    # > 1,024 threads' worth at 3 each
])
def test_remap_kernels_bit_identical_to_plain(cuda_device, W, P, nposs):
    T = 400
    nframes = [400, 300, 250]
    lt, seq, mask, p0, starts = _inputs(nframes, nposs, T, P, W, cuda_device)
    n0 = rk.remap_banded.launches
    tb, vfinal = rk.remap_banded(lt, seq, mask, p0, starts, 3.0, W)
    torch.cuda.synchronize()
    assert rk.remap_banded.launches == n0 + 1
    ref_tb, ref_v = rk.remap_banded_plain(lt, seq, mask, p0, starts, 3.0, W)
    assert torch.equal(tb, ref_tb)
    assert torch.equal(vfinal, ref_v)
    last = torch.argmax(vfinal, dim=1).to(torch.int32) + starts[-1]
    path = rk.remap_backtrack(tb, starts, last)
    torch.cuda.synchronize()
    assert torch.equal(path, rk.remap_backtrack_plain(tb, starts, last))


@pytest.mark.gpu
def test_remap_widest_window(cuda_device):
    """W = 16,384, the kernel's limit: 1,024 threads of 16 positions."""
    W = P = 16384
    lt, seq, mask, p0, starts = _inputs([40, 33], [16000, 9000], 40, P, W,
                                        cuda_device)
    tb, vfinal = rk.remap_banded(lt, seq, mask, p0, starts, 2.0, W)
    ref_tb, ref_v = rk.remap_banded_plain(lt, seq, mask, p0, starts, 2.0, W)
    torch.cuda.synchronize()
    assert torch.equal(tb, ref_tb) and torch.equal(vfinal, ref_v)


@pytest.mark.gpu
def test_remap_window_out_of_range_raises(cuda_device):
    lt, seq, mask, p0, starts = _inputs([40], [30], 40, 64, 32, cuda_device)
    with pytest.raises(ValueError, match="window of 1..32767"):
        rk.remap_banded(lt, seq, mask, p0, starts, 3.0,
                        rk.RemapBanded.MAX_W + 1)


#: the wide route's cases (W, P, T): the exact window of the 22,145 bucket,
#: the first wide width (not a multiple of 8, so remap_back copies bulk
#: rows), an odd width, and the widest
WIDE_CASES = ((22272, 22145, 120), (16385, 16385, 80), (20001, 19000, 70),
              (32767, 32767, 40))


@pytest.mark.gpu
@pytest.mark.parametrize("W,P,T", WIDE_CASES)
def test_remap_wide_route_bit_identical_to_plain(cuda_device, W, P, T):
    """Windows past MAX_W: the wide route's traceback, final scores and
    paths are the twins' bits, twice, and count in ``wide_launches``."""
    assert rk.kernel_route(W) == "wide"
    nframes = [T, T - 5, T // 2]
    nposs = [P, P - 2000, 700]
    lt, seq, mask, p0, starts = _inputs(nframes, nposs, T, P, W, cuda_device,
                                        seed=W % 89)
    w0 = rk.remap_banded.wide_launches, rk.remap_backtrack.wide_launches
    _twice_against_twins(lt, seq, mask, p0, starts, 3.0, W)
    assert (rk.remap_banded.wide_launches,
            rk.remap_backtrack.wide_launches) == (w0[0] + 2, w0[1] + 2)


@pytest.mark.gpu
def test_remap_wide_route_moves_across_the_split(cuda_device):
    """W = 22,272 over longer references: the window jumps by d = 256
    (the largest move, one block of frames) with the positions within 258
    of each of the cluster's splits live, so that each block's last
    positions read their sources in the next block over distributed
    shared memory."""
    W, P, T = 22272, 40000, 900
    plan = rk.remap_banded_plan(W)
    lt, seq, mask, p0, starts = _inputs([T, T - 100], [P, P - 2000], T, P,
                                        W, cuda_device, seed=5)
    jumps = starts[1:] - starts[:-1]
    assert int(jumps.max()) == rk.block_len(W) == 256
    # a jump of 256 where the positions around every split are real
    t = int(torch.nonzero(jumps[:, 0] == 256)[0, 0]) + 1
    for k in range(1, plan["cluster"]):
        edge = int(starts[t - 1, 0]) + k * plan["hb"]
        assert bool(mask[0, edge - 258:edge + 258].all())
    _twice_against_twins(lt, seq, mask, p0, starts, 3.0, W)


@pytest.mark.gpu
def test_remap_wide_route_without_a_ring(cuda_device):
    """Posterior rows of 65,537 states (klen 8) at the first wide width:
    no ring of two slots fits beside a block's arrays, so the consumers
    gather the emissions from device memory while the producer warp only
    sends the block's edges; the twins' bits."""
    W, P, T = rk.MAX_W + 1, rk.MAX_W + 1, 40
    nstate = 65537
    assert rk.remap_banded_plan(W, nstate)["nslots"] == 0
    lt, seq, mask, p0, starts = _inputs([T, T - 9], [P, 700], T, P, W,
                                        cuda_device, seed=3, nstate=nstate)
    _twice_against_twins(lt, seq, mask, p0, starts, 3.0, W)


@pytest.mark.gpu
def test_remap_wide_route_tie_heavy(cuda_device):
    """The tie-heavy posterior of ``test_remap_kernels_tie_heavy`` at the
    exact window of the 22,145 bucket: equal slip sources on both sides of
    the cluster's splits, where the earlier block's total wins the ties."""
    W, P, T = 22272, 22145, 150
    lt, seq, mask, p0, starts = _inputs([T, T - 20, 90], [P, P - 400, 600],
                                        T, P, W, cuda_device, seed=7)
    lt = torch.round(lt / 4.0) * 4.0
    p0 = torch.round(p0)
    _twice_against_twins(lt, seq, mask, p0, starts, 0.0, W)


@pytest.mark.gpu
def test_remap_wide_route_banded_schedule(cuda_device):
    """The wide route where the window moves (W < P): every window jump
    d in [0, TB] realigns the scores as the twin does."""
    W, P, T = 16392, 40000, 900
    lt, seq, mask, p0, starts = _inputs([T, T - 100], [P, P - 9000], T, P,
                                        W, cuda_device, seed=3)
    assert int((starts[1:] - starts[:-1]).max()) > 0
    _twice_against_twins(lt, seq, mask, p0, starts, 3.0, W)


@pytest.mark.gpu
def test_the_tuned_route_counts_no_wide_launch(cuda_device):
    lt, seq, mask, p0, starts = _inputs([60, 45], [30, 20], 60, 40, 16,
                                        cuda_device)
    w0 = rk.remap_banded.wide_launches, rk.remap_backtrack.wide_launches
    _twice_against_twins(lt, seq, mask, p0, starts, 3.0, 16)
    assert (rk.remap_banded.wide_launches,
            rk.remap_backtrack.wide_launches) == w0


#: the widths the plans are checked over, and the plan's layout boundaries
#: (positions a thread 2 -> 3 -> 4 -> 6 -> 8 on 6 consumer warps, then 6 ->
#: 8 -> 12 -> 16 on 12, then the 512- and 1024-thread instances, and the
#: last width with a producer warp)
PLAN_WIDTHS = (1, 7, 32, 64, 255, 256, 640, 768, 1000, 3072, 5000, 12288,
               16384)
LAYOUT_BOUNDARIES = (384, 385, 576, 577, 768, 769, 1152, 1153, 1536, 1537,
                     2304, 2305, 3072, 3073, 4608, 4609, 6144, 6145, 7680,
                     7681, 15872, 15873)


@pytest.mark.parametrize("W", PLAN_WIDTHS + LAYOUT_BOUNDARIES + (777,))
def test_remap_banded_plan_fits_and_covers(W):
    plan = rk.remap_banded_plan(W)
    assert plan["smem"] + rk.BANDED_STATIC_BYTES <= rk.SMEM_OPTIN
    assert plan["smem"] >= (rk.BANDED_BAR_BYTES + plan["nslots"]
                            * plan["rows"] * plan["slot_bytes"]
                            + rk.BANDED_POSITION_BYTES * W)
    assert plan["slot_bytes"] % 16 == 0
    assert plan["slot_bytes"] >= 4 * rk.NSTATE + 12
    assert plan["ppt"] in rk.BANDED_PPTS and 2 <= plan["nslots"] <= 4
    assert plan["rows"] in rk.BANDED_ROWS
    assert plan["producer"] == int(plan["warps"] < 32)
    assert plan["threads"] == 32 * (plan["warps"] + plan["producer"]) <= 1024
    # every position has a thread, and every warp a position
    assert plan["threads"] * plan["ppt"] >= W
    assert (plan["warps"] - 1) * 32 * plan["ppt"] < W
    ppt = plan["ppt"]
    assert plan["vec"] == (16 if W % 8 == 0 and ppt % 8 == 0 else
                           8 if W % 4 == 0 and ppt % 4 == 0 else
                           4 if W % 2 == 0 and ppt % 2 == 0 else 2)
    assert (ppt, plan["maxt"]) in rk.BANDED_BUILDS
    assert plan["maxt"] // 2 < plan["threads"] <= plan["maxt"] or (
        plan["maxt"] == 256)


#: kmer lengths 5 to 8: posterior rows of 1,025 to 65,537 states
NSTATES = (1025, 4097, 16385, 65537)


@pytest.mark.parametrize("nstate", NSTATES[1:])
@pytest.mark.parametrize("W", PLAN_WIDTHS)
def test_remap_banded_plan_reaches_large_posteriors(W, nstate):
    """Rows of 4,097 states keep a ring at every width; rows of 16,385
    keep one up to W = 9,976 and rows of 65,537 at no width: there the
    kernel gathers its emissions from device memory, without a producer
    warp, and still fits beside the window's arrays."""
    plan = rk.remap_banded_plan(W, nstate)
    assert plan["smem"] + rk.BANDED_STATIC_BYTES <= rk.SMEM_OPTIN
    assert plan["threads"] * plan["ppt"] >= W
    assert (plan["ppt"], plan["maxt"]) in rk.BANDED_BUILDS
    ring = plan["nslots"] > 0
    assert ring == (nstate == 4097 or (nstate == 16385 and W <= 9976))
    if ring:
        assert 2 <= plan["nslots"] <= 4
        assert plan["smem"] >= (rk.BANDED_BAR_BYTES + plan["nslots"]
                                * plan["rows"] * plan["slot_bytes"]
                                + rk.BANDED_POSITION_BYTES * W)
    else:
        assert plan["producer"] == 0 and plan["rows"] == 1
        assert plan["threads"] == 32 * plan["warps"]
        assert plan["smem"] == (rk.BANDED_BAR_BYTES
                                + rk.BANDED_POSITION_BYTES * (-(-W // 8) * 8))


def test_remap_banded_builds_are_the_plans_pairs():
    """remap_banded.cu instantiates exactly BANDED_BUILDS, and every plan,
    at every width and with or without a ring, falls on one of them."""
    src = os.path.join(os.path.dirname(rk.__file__), os.pardir, "csrc",
                       "remap_banded.cu")
    with open(src) as f:
        built = {(int(a), int(b)) for a, b in re.findall(
            r"^\s*REMAP_BANDED_CASE\((\d+), (\d+)\);", f.read(), re.M)}
    assert built == set(rk.BANDED_BUILDS)
    reached = {(plan["ppt"], plan["maxt"])
               for nstate in (NSTATES[0], NSTATES[-1])
               for plan in map(lambda W: rk.remap_banded_plan(W, nstate),
                               range(1, rk.MAX_W + 1))}
    assert reached == built


def test_remap_banded_plan_at_the_main_paths_widths():
    main = rk.remap_banded_plan(768)
    assert (main["warps"], main["ppt"], main["rows"], main["nslots"],
            main["vec"]) == (6, 4, 4, 4, 8)
    assert main["producer"] == 1 and main["threads"] == 224
    rerun = rk.remap_banded_plan(3072)
    assert (rerun["warps"], rerun["ppt"], rerun["vec"]) == (12, 8, 16)


@pytest.mark.parametrize("W", PLAN_WIDTHS + (777, 1024, 2048, 15872))
def test_remap_back_plan_fits(W):
    plan = rk.remap_back_plan(W)
    assert plan["smem"] <= rk.SMEM_OPTIN
    assert plan["frame_bytes"] % 16 == 0
    assert plan["K"] in rk.BACK_FRAMES
    assert plan["K"] == 1 or plan["K"] * plan["frame_bytes"] <= (
        rk.BACK_SLOT_BYTES)
    assert plan["slot_bytes"] >= plan["K"] * plan["frame_bytes"]
    assert rk.BACK_MIN_SLOTS <= plan["nslots"] <= rk.BACK_MAX_SLOTS
    assert plan["smem"] == (rk.BACK_BAR_BYTES
                            + plan["nslots"] * plan["slot_bytes"])
    if plan["copy"] == "tensor":
        # one box a slot: inner x W / inner lanes, each side <= 256
        inner = plan["inner"]
        assert W % 8 == 0 and inner % 8 == 0 and W % inner == 0
        assert inner <= rk.BACK_BOX_LANES and W // inner <= rk.BACK_BOX_LANES
        assert plan["frame_bytes"] == 2 * W
        assert plan["slot_bytes"] % 128 == 0
    else:
        assert plan["copy"] == "bulk rows" and plan["inner"] == 0
        assert plan["frame_bytes"] >= 2 * W + 14


def test_remap_back_plan_copy_forms():
    assert rk.remap_back_plan(768)["inner"] == 256
    assert rk.remap_back_plan(3072)["inner"] == 256
    assert rk.remap_back_plan(640)["inner"] == 160
    assert rk.remap_back_plan(777)["copy"] == "bulk rows"     # W % 8 != 0
    assert rk.remap_back_plan(7)["copy"] == "bulk rows"


@pytest.mark.parametrize("W", (0, rk.WIDE_MAX_W + 1))
def test_remap_banded_plan_rejects_out_of_range_windows(W):
    with pytest.raises(ValueError, match="window of 1..32767"):
        rk.remap_banded_plan(W)


def _check_wide_plan(plan, W, nstate=rk.NSTATE):
    """A wide plan: a cluster of WIDE_CLUSTER blocks of 8 or 12 positions a
    thread, each before the last holding hb positions in whole warps, the
    last the rest, the blocks covering W; each within WIDE_WARPS consumer
    warps and a producer warp (a 512-thread instance), its arrays and ring
    in shared memory; no device scratch."""
    assert plan["route"] == "wide" and plan["cluster"] == rk.WIDE_CLUSTER
    assert "scratch" not in plan
    hb, blocks = plan["hb"], plan["blocks"]
    assert len(blocks) == plan["cluster"] and sum(blocks) == W
    assert all(n == hb for n in blocks[:-1]) and 1 <= blocks[-1] <= hb
    assert plan["ppt"] in rk.WIDE_PPTS and hb % (32 * plan["ppt"]) == 0
    # the fewest positions a thread whose blocks keep within WIDE_WARPS
    assert plan["ppt"] == (8 if W <= 8 * 32 * 8 * rk.WIDE_WARPS else 12)
    assert plan["warps"] == hb // (32 * plan["ppt"]) <= rk.WIDE_WARPS
    assert plan["producer"] == 1
    assert plan["threads"] == 32 * (plan["warps"] + 1) <= plan["maxt"]
    assert (plan["ppt"], plan["maxt"]) in rk.WIDE_BUILDS
    assert plan["smem"] == (rk.WIDE_BAR_BYTES + rk.BANDED_POSITION_BYTES
                            * hb + plan["nslots"] * plan["rows"]
                            * plan["slot_bytes"])
    assert plan["smem"] + rk.BANDED_STATIC_BYTES <= rk.SMEM_OPTIN
    assert plan["slot_bytes"] == -(-(4 * nstate + 12) // 16) * 16
    assert plan["nslots"] == 0 or 2 <= plan["nslots"] <= 4
    ppt = plan["ppt"]
    assert plan["vec"] == (16 if W % 8 == 0 and ppt % 8 == 0 else
                           8 if W % 4 == 0 and ppt % 4 == 0 else
                           4 if W % 2 == 0 and ppt % 2 == 0 else 2)


#: every tier of the plans: the tuned route's layout boundaries, its limit,
#: and widths where the wide route's warps a block change
WIDE_BOUNDARIES = tuple(w for p in range(16, 33) for w in
                        (1024 * p, 1024 * p + 1)
                        if rk.MAX_W < w <= rk.WIDE_MAX_W) + (rk.WIDE_MAX_W,)


@pytest.mark.parametrize("lo,hi,step", [
    (1, rk.MAX_W + 1, 1),                            # every tuned width
    (rk.MAX_W + 1, rk.WIDE_MAX_W + 1, 1),            # every wide width
])
def test_every_window_gets_a_plan_or_the_stated_refusal(lo, hi, step):
    """Every W from 1 to 32,767 has a plan of both kernels, tuned up to
    MAX_W and wide past it, each covering the window; 0 and 32,768 are
    refused with the int16 reason."""
    for W in range(lo, hi, step):
        plan = rk.remap_banded_plan(W)
        assert plan["route"] == rk.kernel_route(W)
        assert plan["route"] == ("tuned" if W <= rk.MAX_W else "wide")
        # the threads of a block (the wide route: of each of its cluster's
        # blocks) cover the window
        assert plan.get("cluster", 1) * plan["threads"] * plan["ppt"] >= W
        if plan["route"] == "wide":
            _check_wide_plan(plan, W)
        back = rk.remap_back_plan(W)
        assert back["smem"] <= rk.SMEM_OPTIN
        assert rk.BACK_MIN_SLOTS <= back["nslots"]
    for W in (0, rk.WIDE_MAX_W + 1, 40000):
        with pytest.raises(ValueError, match="int16 traceback"):
            rk.kernel_route(W)
        with pytest.raises(ValueError, match="window of 1..32767"):
            rk.remap_back_plan(W)


@pytest.mark.parametrize("W", WIDE_BOUNDARIES + (22272,))
def test_remap_wide_plan_at_its_boundaries(W):
    plan = rk.remap_banded_plan(W)
    _check_wide_plan(plan, W)
    # a block's warps: W over the cluster in runs of 32 ppt
    assert plan["warps"] == -(-(-(-W // rk.WIDE_CLUSTER))
                              // (32 * plan["ppt"]))
    if W == 22272:
        assert (plan["hb"], plan["warps"], plan["ppt"], plan["threads"],
                plan["maxt"], plan["rows"], plan["nslots"], plan["vec"]) == (
                    2816, 11, 8, 384, 512, 4, 4, 16)
    back = rk.remap_back_plan(W)
    assert back["K"] == 1
    assert back["copy"] == ("tensor" if W % 8 == 0 else "bulk rows")


def test_remap_back_plan_at_the_exact_window_of_the_22145_bucket():
    """The exact window of a reference in the 22,145-position bucket:
    the tensor copy (a box of 256 x 87 lanes) and 5 slots of one frame;
    a width that no box divides copies bulk rows."""
    plan = rk.remap_back_plan(22272)
    assert (plan["copy"], plan["inner"], plan["K"], plan["nslots"]) == (
        "tensor", 256, 1, 5)
    assert rk.remap_back_plan(22273)["copy"] == "bulk rows"


@pytest.mark.parametrize("nstate", NSTATES)
@pytest.mark.parametrize("W", (rk.MAX_W + 1, 22272, 24576, 24577,
                               rk.WIDE_MAX_W))
def test_remap_wide_plan_reaches_large_posteriors(W, nstate):
    """The wide plan at kmer lengths 5 to 8: a ring beside each block's
    arrays wherever two slots fit (always for rows of 1,025 and 4,097
    states), else none and the emissions gathered from device memory (the
    producer warp stays: it sends the block's edges to the later
    blocks)."""
    plan = rk.remap_banded_plan(W, nstate)
    _check_wide_plan(plan, W, nstate)
    two = (rk.WIDE_BAR_BYTES + rk.BANDED_POSITION_BYTES * plan["hb"]
           + 2 * plan["slot_bytes"] + rk.BANDED_STATIC_BYTES)
    assert (plan["nslots"] > 0) == (two <= rk.SMEM_OPTIN)
    assert plan["nslots"] > 0 or nstate > 4097


def test_remap_wide_builds_are_the_plans_pairs():
    """remap_banded.cu instantiates the wide kernel at exactly WIDE_BUILDS,
    and the plans of every width reach each of them."""
    src = os.path.join(os.path.dirname(rk.__file__), os.pardir, "csrc",
                       "remap_banded.cu")
    with open(src) as f:
        built = {(int(a), int(b)) for a, b, c, d in re.findall(
            r"if \(ppt == (\d+) && maxt == (\d+)\) return "
            r"remap_banded_kernel<(\d+), (\d+), true>;", f.read())
            if (a, b) == (c, d)}
    assert built == set(rk.WIDE_BUILDS)
    reached = {(plan["ppt"], plan["maxt"]) for plan in map(
        rk.remap_banded_plan, range(rk.MAX_W + 1, rk.WIDE_MAX_W + 1, 7))}
    assert reached == built == {(8, 512), (12, 512)}


def test_the_parents_copy_is_loaded_by_no_path():
    """``csrc/redesign_parents.cu`` (the two redesigned kernels' parents,
    timed beside them by chip_smoke.py) is loaded only by
    ``scripts/redesign_parents.py``, which no module of the port imports."""
    pkg = os.path.join(os.path.dirname(rk.__file__), os.pardir)
    users = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    if "redesign_parents" in f.read():
                        users.append(os.path.relpath(path, pkg))
    assert users == [os.path.join("scripts", "redesign_parents.py")]


def test_storage_end_counts_from_a_views_start():
    base = torch.zeros(100, dtype=torch.float32)
    view = base[10:90]
    assert rk.storage_end(view) == view.data_ptr() + 90 * 4
    assert rk.storage_end(base) == base.data_ptr() + 400


def _twice_against_twins(lt, seq, mask, p0, starts, slip, W):
    """Both kernels twice against their twins: the same bits each time."""
    n0, m0 = rk.remap_banded.launches, rk.remap_backtrack.launches
    tb, vfinal = rk.remap_banded(lt, seq, mask, p0, starts, slip, W)
    tb2, vfinal2 = rk.remap_banded(lt, seq, mask, p0, starts, slip, W)
    torch.cuda.synchronize()
    ref_tb, ref_v = rk.remap_banded_plain(lt, seq, mask, p0, starts, slip, W)
    assert torch.equal(tb, ref_tb) and torch.equal(vfinal, ref_v)
    assert torch.equal(tb2, tb) and torch.equal(vfinal2, vfinal)
    last = torch.argmax(vfinal, dim=1).to(torch.int32) + starts[-1]
    path = rk.remap_backtrack(tb, starts, last)
    path2 = rk.remap_backtrack(tb, starts, last)
    torch.cuda.synchronize()
    assert torch.equal(path, rk.remap_backtrack_plain(tb, starts, last))
    assert torch.equal(path2, path)
    assert (rk.remap_banded.launches, rk.remap_backtrack.launches) == (
        n0 + 2, m0 + 2)
    return tb, path


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 130])
def test_remap_kernels_across_batch_sizes(cuda_device, B):
    """B = 1, an odd B (the posterior's last row ends off a 16-byte
    boundary, so it is read from device memory), and more rows than half
    the SMs."""
    rs = np.random.RandomState(B)
    T, P, W = 301, 400, 128
    nframes = rs.randint(T // 2, T + 1, size=B)
    nposs = rs.randint(P // 4, P + 1, size=B)
    nframes[0], nposs[0] = T, P
    lt, seq, mask, p0, starts = _inputs(list(nframes), list(nposs), T, P, W,
                                        cuda_device, seed=B)
    if B % 2:
        assert (T * B * lt.shape[2] * 4) % 16 != 0
    _twice_against_twins(lt, seq, mask, p0, starts, 3.0, W)


@pytest.mark.gpu
@pytest.mark.parametrize("W,P,T", [
    (777, 2000, 500),                  # W not a multiple of 8 (nor even)
    (100, 300, 40),                    # T < TB: one block, stay-padded
    (768, 3000, 700),                  # T padded with stays up to Tp
    (640, 600, 300),                   # the exact form (W >= P)
] + [(W, W + 500, 60) for W in LAYOUT_BOUNDARIES])
def test_remap_kernels_at_odd_widths_and_plan_boundaries(cuda_device, W, P,
                                                         T):
    nframes = [T, T - 7, T // 2]
    nposs = [P, P - 33, 2]             # a row of two positions
    lt, seq, mask, p0, starts = _inputs(nframes, nposs, T, P, W, cuda_device,
                                        seed=W)
    TB = rk.block_len(W)
    assert starts.shape[0] == -(-T // TB) * TB
    _twice_against_twins(lt, seq, mask, p0, starts, 3.0, W)


@pytest.mark.gpu
@pytest.mark.parametrize("W,P", [(64, 256), (256, 256), (777, 900)])
def test_remap_kernels_tie_heavy(cuda_device, W, P):
    """A posterior quantised to a few values and no slip penalty: many
    slip sources and stay/step scores are equal, and the tie rules decide
    the traceback."""
    T = 300
    lt, seq, mask, p0, starts = _inputs([300, 280, 150], [P, P - 40, 60], T,
                                        P, W, cuda_device, seed=7)
    lt = torch.round(lt / 4.0) * 4.0
    p0 = torch.round(p0)
    _twice_against_twins(lt, seq, mask, p0, starts, 0.0, W)


@pytest.mark.gpu
def test_remap_clocked_builds_give_the_same_bits(cuda_device):
    """``bench_remap --clocks``: the clocked builds compute what the port's
    builds compute, and report cycles for every phase, on the tuned route
    and on the wide route's cluster."""
    from sloika_tpu_torch.scripts import bench_remap
    T, W = 300, 768
    lt, seq, mask, p0, starts = _inputs([300, 290, 200], [900, 800, 400], T,
                                        1000, W, cuda_device)
    args = (lt, seq, mask, p0, starts, 3.0, W)
    tb, vfinal = rk.remap_banded(*args)
    split = bench_remap.banded_clocks(args, (tb, vfinal))
    assert split["cycles_per_step"] > 0
    assert set(split["phases_mean"]) == set(bench_remap.BANDED_PHASES)
    last = torch.argmax(vfinal, dim=1).to(torch.int32) + starts[-1]
    path = rk.remap_backtrack(tb, starts, last)
    back = bench_remap.back_clocks((tb, starts, last), path)
    assert back["walker"]["loop"] > 0 and back["copier"]["loop"] > 0
    # the wide route's: blocks 0 and 1 of row 0's cluster stamp, block 1
    # its waits for block 0's edge
    W, P = 22272, 22145
    lt, seq, mask, p0, starts = _inputs([80, 70], [P, P - 500], 80, P, W,
                                        cuda_device)
    args = (lt, seq, mask, p0, starts, 3.0, W)
    split = bench_remap.banded_clocks(args, rk.remap_banded(*args))
    assert set(split["phases_mean"]) == set(bench_remap.WIDE_PHASES)
    assert split["cycles_per_step"] > 0
    assert split["block1"]["cycles_per_step"] > 0
    assert split["block1"]["phases_mean"]["cluster_wait"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("nstate,W,P,T", [
    (4097, 12288, 12800, 60),          # a ring of rows of 16,400 bytes
    (16385, 3072, 3600, 300),          # a ring of rows of 65,552 bytes
    (16385, 12288, 12800, 60),         # no ring fits: device gathers
    (65537, 2048, 2500, 100),          # no ring at any width
])
def test_remap_kernels_at_large_posteriors(cuda_device, nstate, W, P, T):
    """Longer kmers (``--kmer_len`` 6 to 8): the plan keeps a ring where
    one fits and gathers the emissions from device memory where none does;
    both give the twins' bits."""
    nframes = [T, T - 9, T // 2]
    nposs = [P, P - 100, 40]
    lt, seq, mask, p0, starts = _inputs(nframes, nposs, T, P, W, cuda_device,
                                        seed=nstate % 97, nstate=nstate)
    _twice_against_twins(lt, seq, mask, p0, starts, 3.0, W)
