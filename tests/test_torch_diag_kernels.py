"""The diagnostic probes' CUDA kernels against their plain PyTorch twins.

This file imports no jax, so the ``gpu``-marked tests run on a machine with
a CUDA card and without jax::

    python -m pytest tests/test_torch_diag_kernels.py -m gpu --noconftest -q

On a machine without a card they skip; the CPU tests check that each
wrapper hands CPU tensors to its plain twin without counting a launch, and
that the probes' entry points run on the CPU only when asked.
"""
import numpy as np
import pytest
import torch

from sloika_tpu_torch.nn.fused_gru import H100_SMS, SMEM_OPTIN, gru_forward
from sloika_tpu_torch.scripts import bench_dma as tdma
from sloika_tpu_torch.scripts import bench_gru_unroll as tgru
from sloika_tpu_torch.scripts import bench_viterbi_parts as tvit

#: gru_unroll "highest" against its f32 twin: float32 sums in another order
GRU_TOL = 1e-4
#: gru_unroll "default" against its bf16-rounding twin, max abs: where the
#: kernel's and the twin's f32 state differ in the last ulp, their bf16
#: roundings can differ by one bf16 ulp (2^-8 relative), which the
#: recurrence carries on (1.6e-4 at the script's shape between the twin and
#: itself summed in float64, on the CPU)
BF16_TOL = 2e-3
#: ... and its mean abs difference from that twin, as a share of the mean
#: abs difference the bf16 rounding itself makes (1.5e-6 against 4.2e-5 in
#: that comparison): the kernel does round
BF16_MEAN_SHARE = 0.2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _gru_case(T, B, S, dev, seed=4):
    rs = np.random.RandomState(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return (f32(0.3 * rs.normal(size=(T, B, 3 * S))),
            f32(rs.normal(size=(S, 2 * S)) / np.sqrt(2 * S)),
            f32(rs.normal(size=(S, S)) / np.sqrt(2 * S)))


# ---------------------------------------------------------------------------
# CPU: dispatch to the twins, the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", tgru.PRECISIONS)
def test_gru_unroll_cpu_dispatch_is_the_plain_twin(precision):
    xp, sWT, sW2T = _gru_case(7, 3, 8, "cpu")
    before = tgru.gru_unroll.launches
    out = tgru.gru_unroll(xp, sWT, sW2T, U=4, precision=precision)
    assert torch.equal(out, tgru.gru_unroll_plain(xp, sWT, sW2T, precision))
    assert tgru.gru_unroll.launches == before
    if precision == "default":          # the twin rounds the products
        assert not torch.equal(
            out, tgru.gru_unroll_plain(xp, sWT, sW2T, "highest"))
    with pytest.raises(ValueError, match="precision"):
        tgru.gru_unroll(xp, sWT, sW2T, precision="bf16")


def test_viterbi_parts_cpu_dispatch_is_the_plain_twin():
    post, stay = (torch.from_numpy(a) for a in tvit.variant_inputs(3, 6, 64))
    before = tvit.viterbi_parts.launches
    for variant in tvit.VARIANTS:
        tb, vf = tvit.viterbi_parts(variant, post, stay)
        tb_p, vf_p = tvit.viterbi_parts_plain(variant, post, stay)
        assert torch.equal(tb, tb_p) and torch.equal(vf, vf_p)
    # "expand" and "full" are one computation
    assert torch.equal(tvit.viterbi_parts("expand", post, stay)[0],
                       tvit.viterbi_parts("full", post, stay)[0])
    assert tvit.viterbi_parts.launches == before
    with pytest.raises(ValueError, match="variant"):
        tvit.viterbi_parts("skip", post, stay)


def test_hbm_ring_cpu_dispatch_is_the_plain_twin():
    x = torch.from_numpy(np.random.RandomState(6).rand(11, 3, 20)
                         .astype(np.float32))
    before = tdma.hbm_ring.launches
    for rows, nslots in tdma.CASES + ((3, 2), (12, 2)):
        out = tdma.hbm_ring(x, rows, nslots)
        Tr = 11 // rows * rows
        ref = (x[:Tr].amax(0) if Tr else
               torch.full((3, 20), -float("inf")))
        assert torch.equal(out, ref)
    assert tdma.hbm_ring.launches == before
    with pytest.raises(ValueError, match="nslots"):
        tdma.hbm_ring(x, 1, 17)


@pytest.mark.parametrize("rows,nslots", tdma.CASES + ((1, 16),))
@pytest.mark.parametrize("N", [128 * 1024, 128 * 1024 + 4, 3000, 4])
def test_hbm_ring_plan(rows, nslots, N):
    """Tiles of whole warps of float4s (every consumer thread folds one a
    row of a whole tile), a ring that fits, and every tile on a block; at
    the script's shape (N = 128 x 1,024) one tile a block on 128 SMs, but
    at (32, 3), whose ring holds 512 floats a row, two."""
    plan = tdma.hbm_ring_plan(N, rows, nslots)
    W = plan["W"]
    assert W % 4 == 0 and (W % 128 == 0 or W < 128)
    assert plan["consumers"] == -(-W // 128) <= 8
    assert plan["threads"] == 32 * (plan["consumers"] + 1)
    assert plan["smem"] == 256 + 4 * nslots * rows * W <= SMEM_OPTIN
    assert plan["tiles"] == -(-N // W)
    assert plan["grid"] * plan["tiles_per_block"] >= plan["tiles"]
    assert plan["grid"] <= H100_SMS * plan["blocks_per_sm"]
    assert (plan["grid"] - 1) * plan["tiles_per_block"] < plan["tiles"]
    if N == 128 * 1024:
        assert (W, plan["grid"]) == ((512, 128) if rows == 32 else
                                     (1024, 128))
        assert plan["tiles_per_block"] == (2 if rows == 32 else 1)
        assert plan["blocks_per_sm"] == 1


def test_hbm_ring_plan_puts_blocks_together_where_tiles_outnumber_sms():
    """At 32 times the script's columns the SMs hold several blocks each, so
    that their tiles stream at once; a ring too large for the SM's shared
    memory is refused."""
    plan = tdma.hbm_ring_plan(32 * 128 * 1024, 1, 8)
    assert plan["blocks_per_sm"] > 1 and plan["W"] == 1024
    assert plan["grid"] > H100_SMS
    with pytest.raises(ValueError):
        tdma.hbm_ring_plan(1024, 4096, 16)
    with pytest.raises(ValueError):
        tdma.hbm_ring_plan(1022, 1, 2)


def test_probe_entry_points_run_on_the_cpu_only_when_asked(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (tgru.main, tvit.main, tdma.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--device", "cuda"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])
    assert tvit.main(["full", "reduce", "--batch", "2", "--T", "5",
                      "--device", "cpu"]) == 0
    assert tdma.main(["1,2", "3,2", "--batch", "2", "--T", "7",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "full" in out and "rows=3" in out and "not timed" in out


@pytest.mark.parametrize("U", tgru.UNROLLS)
@pytest.mark.parametrize("precision", tgru.PRECISIONS)
@pytest.mark.parametrize("S", tgru.WIDTHS)
def test_gru_unroll_plan_at_the_script_widths(S, precision, U):
    """At the script's batch (B = 100): one row a block, the weights in
    registers (at S = 144 in f32 the 8-warp layout, sWT's last 40 rows
    staged, where two rows a block, from B = 200, take 9 warps and 96 rows
    staged; in bf16 all of them held, two rows a register), a ring of 4
    slots of U rows."""
    plan = tgru.gru_unroll_plan(100, S, U, precision)
    assert plan == tgru.gru_unroll_plan(100, S, U, precision)  # shapes alone
    w8 = (S, precision) == (144, "highest")
    assert (plan["br"], plan["mode"], plan["nslot"]) == (
        1, "registers8" if w8 else "registers", 4)
    want = {(96, "highest"): (96, 48), (96, "default"): (96, 48),
            (144, "highest"): (104, 72), (144, "default"): (144, 72)}
    assert (plan["kr"], plan["kh2"]) == want[(S, precision)]
    assert plan["threads"] == (256 if w8 else 2 * S)
    assert plan["ld"] == 3 * S and plan["smem"] <= SMEM_OPTIN
    wbytes = 2 if precision == "default" else 4
    if w8:
        assert plan["smem"] == (tgru.UNROLL_BAR_BYTES + 4 * (
            4 * U * 3 * S + 4 * 72 + 16 + 40 * 256))
        nine = tgru.gru_unroll_plan(200, S, U, precision)
        assert (nine["br"], nine["mode"], nine["kr"], nine["kh2"],
                nine["threads"]) == (2, "registers", 48, 72, 288)
    else:
        assert plan["smem"] == (tgru.UNROLL_BAR_BYTES + 4 * (
            4 * U * 3 * S + max(S, plan["kr"]) + 2 * plan["kh2"])
            + wbytes * (S - min(S, plan["kr"])) * 2 * S)


@pytest.mark.parametrize("precision", tgru.PRECISIONS)
@pytest.mark.parametrize("S", [1, 5, 8, 64, 72, 73, 96, 97, 144, 145, 256,
                               512])
@pytest.mark.parametrize("B", [1, 100, 600, 1100])
def test_gru_unroll_plan_fits_every_width(B, S, precision):
    for U in tgru.UNROLLS:
        br = 1
        while br < 8 and -(-B // br) > H100_SMS:
            br *= 2
        if 4 * U * br * -(-3 * S // 4) * 4 > SMEM_OPTIN:
            # not one ring slot of U time rows fits
            with pytest.raises(ValueError):
                tgru.gru_unroll_plan(B, S, U, precision)
            continue
        plan = tgru.gru_unroll_plan(B, S, U, precision)
        assert plan["br"] == br and plan["smem"] <= SMEM_OPTIN
        assert 1 <= plan["nslot"] <= 4
        # one slot only where two would not fit with nothing staged
        wbytes = 2 if precision == "default" else 4
        kh = plan["kh2"] or -(-((S + 1) // 2) // 4) * 4
        staged = (wbytes * (S - min(S, plan["kr"])) * 2 * S * plan["stage1"]
                  + wbytes * kh * S * 2 * plan["stage2"])
        assert plan["nslot"] >= 2 or (plan["smem"] - staged
                                      + 4 * U * br * plan["ld"] > SMEM_OPTIN)
        assert plan["ld"] % 4 == 0 and 3 * S <= plan["ld"] < 3 * S + 4
        assert plan["threads"] % 32 == 0
        assert plan["threads"] >= 2 * S or plan["mode"] == "registers8"
        if plan["mode"] == "registers":
            # the kernel's instances: S <= 2 kh2, and sWT's rows past kr
            # staged
            assert 73 <= S <= 144 and S <= 2 * plan["kh2"]
            assert plan["stage1"] and not plan["stage2"]
            assert plan["threads"] <= 4 * plan["kh2"]
            assert plan["br"] <= (2 if plan["kh2"] == 72 else 8)
        elif plan["mode"] == "registers8":
            assert precision == "highest" and plan["br"] == 1
            assert 128 < S <= 144 and plan["threads"] == 256
        else:
            assert (plan["kr"], plan["kh2"]) == (0, 0)


def test_gru_unroll_main_on_the_cpu(capsys):
    """The script's cases at the training shape through the twin: every U
    gives U = 1's output."""
    assert tgru.main(["1", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "U=2  parity vs U=1: EXACT" in out
    assert out.count("prec=default") == 2


# ---------------------------------------------------------------------------
# GPU: the kernels against their twins
# ---------------------------------------------------------------------------

#: (T, B, S): the script's shape, ragged batches (1, 3; 128 at the wave's
#: edge; 600 takes 8 rows a block), T no multiple of U, S = 144 and 130 (the
#: 8-warp layout in f32, with 16 and 2 states spread over the warps; all
#: weights in registers in bf16) and S = 5 (3S no multiple of 4: the
#: projections padded to 16-byte rows)
GRU_SHAPES = ((400, 100, 96), (37, 1, 96), (37, 3, 96), (37, 128, 96),
              (37, 600, 96), (37, 64, 144), (37, 3, 130), (37, 5, 5))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", tgru.PRECISIONS)
@pytest.mark.parametrize("U", tgru.UNROLLS)
def test_gru_unroll_kernel_matches_its_twin(cuda_device, U, precision):
    for T, B, S in GRU_SHAPES:
        xp, sWT, sW2T = _gru_case(T, B, S, cuda_device)
        before = tgru.gru_unroll.launches
        got = tgru.gru_unroll(xp, sWT, sW2T, U=U, precision=precision)
        torch.cuda.synchronize()
        assert tgru.gru_unroll.launches == before + 1
        ref = tgru.gru_unroll_plain(xp, sWT, sW2T, precision)
        d = (got - ref).abs()
        if precision == "highest":
            assert float(d.max()) <= GRU_TOL, (T, B, S)
        else:
            f32 = tgru.gru_unroll_plain(xp, sWT, sW2T, "highest")
            assert float(d.max()) <= BF16_TOL, (T, B, S)
            assert float(d.mean()) <= BF16_MEAN_SHARE * float(
                (ref - f32).abs().mean()), (T, B, S)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", tgru.PRECISIONS)
def test_gru_unroll_kernel_is_the_same_at_every_unroll(cuda_device,
                                                       precision):
    for T, B, S in GRU_SHAPES:
        xp, sWT, sW2T = _gru_case(T, B, S, cuda_device)
        base = tgru.gru_unroll(xp, sWT, sW2T, U=1, precision=precision)
        for U in tgru.UNROLLS[1:]:
            assert torch.equal(base, tgru.gru_unroll(
                xp, sWT, sW2T, U=U, precision=precision)), (T, B, S, U)


@pytest.mark.gpu
def test_gru_unroll_kernel_matches_the_production_forward(cuda_device):
    for T, B, S in GRU_SHAPES:
        xp, sWT, sW2T = _gru_case(T, B, S, cuda_device)
        got = tgru.gru_unroll(xp, sWT, sW2T, U=1)
        ref = gru_forward(xp, sWT, sW2T)           # an all-valid mask
        assert float((got - ref).abs().max()) <= GRU_TOL, (T, B, S)


@pytest.mark.gpu
def test_gru_unroll_run_case_at_the_script_shape(cuda_device):
    out, ms = tgru.run_case(8, device=cuda_device)
    xp, sWT, sW2T = (torch.from_numpy(a).to(cuda_device)
                     for a in tgru.case_inputs(8))
    assert out.shape == (400, 100, 96) and ms > 0
    assert float((out - tgru.gru_unroll_plain(xp, sWT, sW2T))
                 .abs().max()) <= GRU_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("precision", tgru.PRECISIONS)
@pytest.mark.parametrize("S", tgru.WIDTHS)
def test_gru_unroll_at_the_script_widths(cuda_device, S, precision):
    """T = 400, B = 100 at S = 96 and 144: every U gives the same bits,
    within GRU_TOL of the f32 twin and of the production forward, or
    BF16_TOL of the bf16 twin; in f32 also at B = 200 (two rows a block:
    at S = 144 the 9-warp layout)."""
    xp, sWT, sW2T = (torch.from_numpy(a).to(cuda_device)
                     for a in tgru.case_inputs(1, S=S))
    base = tgru.gru_unroll(xp, sWT, sW2T, U=1, precision=precision)
    for U in tgru.UNROLLS[1:]:
        assert torch.equal(base, tgru.gru_unroll(
            xp, sWT, sW2T, U=U, precision=precision)), U
    ref = tgru.gru_unroll_plain(xp, sWT, sW2T, precision)
    d = (base - ref).abs()
    if precision == "highest":
        assert float(d.max()) <= GRU_TOL
        assert float((base - gru_forward(xp, sWT, sW2T)).abs().max()) \
            <= GRU_TOL
        # B = 200: two rows a block, the 9-warp layout at S = 144
        xp2, sWT2, sW2T2 = (torch.from_numpy(a).to(cuda_device)
                            for a in tgru.case_inputs(1, B=200, S=S))
        base2 = tgru.gru_unroll(xp2, sWT2, sW2T2, U=1)
        assert float((base2 - tgru.gru_unroll_plain(xp2, sWT2, sW2T2))
                     .abs().max()) <= GRU_TOL
        assert all(torch.equal(base2, tgru.gru_unroll(xp2, sWT2, sW2T2, U=U))
                   for U in tgru.UNROLLS[1:])
    else:
        f32 = tgru.gru_unroll_plain(xp, sWT, sW2T, "highest")
        assert float(d.max()) <= BF16_TOL
        assert float(d.mean()) <= BF16_MEAN_SHARE * float(
            (ref - f32).abs().mean())


@pytest.mark.gpu
@pytest.mark.parametrize("S", tgru.WIDTHS)
def test_gru_unroll_clocked_build_gives_the_same_bits(cuda_device, S):
    """``bench_gru_unroll --clocks``: the clocked build computes what the
    port's build does and stamps every warp's steps."""
    for p in tgru.PRECISIONS:
        split = tgru.step_clocks(2, S=S, precision=p, T=40, B=3,
                                 device=cuda_device)
        assert split["cycles_per_step"] > 0
        assert set(split["phases_mean"]) == set(tgru.UNROLL_PHASES)
        plan = tgru.gru_unroll_plan(3, S, 2, p)
        assert len(split["phases_by_warp"]) == plan["threads"] // 32


@pytest.mark.gpu
@pytest.mark.parametrize("variant", tvit.VARIANTS)
def test_viterbi_parts_kernel_is_bit_identical_to_its_twin(cuda_device,
                                                           variant):
    for B, T, K in ((128, 3277, 1024), (1, 50, 1024), (3, 50, 64),
                    (5, 2, 16), (2, 1, 1024)):
        post, stay = tvit.device_inputs(B, T, K, cuda_device, seed=B + T)
        before = tvit.viterbi_parts.launches
        tb, vf = tvit.viterbi_parts(variant, post, stay)
        torch.cuda.synchronize()
        assert tvit.viterbi_parts.launches == before + 1
        tb_p, vf_p = tvit.viterbi_parts_plain(variant, post, stay)
        assert torch.equal(tb, tb_p), (variant, B, T, K)
        assert torch.equal(vf, vf_p), (variant, B, T, K)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,nslots", tdma.CASES + ((3, 5), (2, 16),
                                                      (1, 16)))
def test_hbm_ring_kernel_is_bit_identical_to_its_twin(cuda_device, rows,
                                                      nslots):
    """Every case on the script's shape, ragged columns (N = 3,000 and 4:
    a tile narrower than the block's warps), T short of a whole number of
    chunks, and more tiles than the SMs hold (N = 4M: several blocks an
    SM)."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows * 17 + nslots)
    for T, B, K in ((3264, 128, 1024), (100, 1, 1024), (101, 3, 1000),
                    (70, 128, 1024), (35, 2, 2), (67, 4096, 1024)):
        x = torch.rand((T, B, K), generator=gen, device=cuda_device)
        before = tdma.hbm_ring.launches
        out = tdma.hbm_ring(x, rows, nslots)
        torch.cuda.synchronize()
        assert tdma.hbm_ring.launches == before + (T >= rows)
        assert torch.equal(out, tdma.hbm_ring_plain(x, rows)), (T, B, K)


@pytest.mark.gpu
def test_hbm_ring_kernel_propagates_nan_and_empty_is_minus_inf(cuda_device):
    x = torch.rand((9, 2, 8), device=cuda_device)
    x[4, 1, 3] = float("nan")
    out = tdma.hbm_ring(x, 2, 3)
    assert torch.isnan(out[1, 3]) and int(torch.isnan(out).sum()) == 1
    assert torch.equal(tdma.hbm_ring(x, 10, 2),
                       torch.full((2, 8), -float("inf"), device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,nslots", tdma.CASES + ((1, 16),))
def test_hbm_ring_kernel_propagates_nan_at_every_case(cuda_device, rows,
                                                      nslots):
    """A NaN in a folded row, and one in the last row, which only rows = 1
    folds (the others stop a row short of T), over ragged columns: NaN
    where the twin has it, every other value bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows + nslots)
    T = 3 * rows + 1
    x = torch.rand((T, 5, 1000), generator=gen, device=cuda_device)
    x[T // 2, 3, 777] = float("nan")
    x[T - 1, 1, 5] = float("nan")
    out = tdma.hbm_ring(x, rows, nslots)
    ref = tdma.hbm_ring_plain(x, rows)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.isnan(out[3, 777]) and bool(torch.isnan(out[1, 5])) == (
        rows == 1)
    assert int(torch.isnan(out).sum()) == 1 + (rows == 1)
    keep = ~torch.isnan(ref)
    assert torch.equal(out[keep], ref[keep])


@pytest.mark.gpu
def test_hbm_ring_clocked_build_gives_the_same_bits(cuda_device):
    """The probe's clocked build (``--clocks``) folds what the port's build
    folds, and reports every chunk of block 0."""
    x = torch.rand((64, 8, 1024), device=cuda_device)
    out = tdma.hbm_ring(x, 2, 4)
    clocks = tdma.chunk_clocks(x, 2, 4, out)
    assert clocks["chunks_block0"] == 32 and clocks["cycles_per_chunk"] > 0
    assert set(clocks["producer"]) == set(tdma.RING_PHASES) | {"loop"}
