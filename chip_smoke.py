"""GPU smoke run of the PyTorch/CUDA port (``sloika_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one.
Phases, each printing one line and raising on failure:

1. environment: the card's name and power limit, the CUDA version;
2. build: the thirteen kernels, from ``sloika_tpu_torch/csrc``, and the
   clocked builds the phases split steps with (CLOCKED), one nvcc each, all
   started together;
3. GRU: the forward kernel against its plain twin at S = 112 and 144,
   T = 3277, B = 64, ragged lengths, forward and reverse (max abs difference
   on valid steps <= 1e-4: float32 summation order over 3277 recurrent
   steps); then at S = 144, forward, at bench.py's production batch
   (T = 3277, B = 1,024) and at the remap path's longest bucket
   (T = 35,429, B = 64), each timed;
4. Viterbi: forward and backtrace kernels against their plain twins at
   K = 1024, T = 3277, B = 64 on a peaked and on a tie-heavy posterior
   (score, codes and path bit-identical), each kernel's step split by its
   clocked build (``scripts/bench_viterbi.py --clocks``); then both timed
   at bench.py's production batch (T = 3277, B = 1,024), the events
   basecall's batch (T = 9,000, B = 64) and the whole-read raw path's
   longest batch (B = 8), rows 0-7 bit-identical to the twins run on those
   rows alone; ``viterbi_back`` also beside its design's bytes and its
   chain's floor (T shared-memory reads); and posteriors the tuned kernels
   do not take, klen 7 (16,384 states) and nbase 3 at klen 4 (T = 200,
   B = 2): the wrappers launch the kernels' general route
   (``general_launches`` up by one) and the paths equal the CPU twin's;
   then klen 7 at the whole-read batch (B = 8), both general kernels
   timed against their plain twins on the card and bit-identical to them;
5. basecall main path: the headline model's graph at full width (seeded
   random weights) basecalls 16 synthetic DAC reads through
   ``Basecaller.basecall_dac_reads``; every kernel of the path must have
   launched, every read must get a call, and the posterior must agree with
   the plain CPU forward on a small batch (<= 1e-4);
5b. whole-read raw basecall path (the default of ``raw``): the same model
   basecalls the 16 reads, normalised on the host as ``load_raw_signal``
   does, whole, in batches of 8, through ``Basecaller(output="states").
   basecall_signals``; every kernel of the path must have launched and
   every read must get a call; then one profiled call; two reads of
   20,000 samples against the plain CPU path (scores within 1e-4
   relative; whether the calls are identical is reported, with the first
   differing state: random weights leave near-ties that round-off may
   flip);
6. GRU backward, at the training shapes T = 400, B = 100, S = 96, ragged
   lengths with interior holes, forward and reverse: the forward kernel's
   inference and training variants against their twin (as in 3; the
   training variant's gate trace within 1e-4 of the twin's at every step,
   and its h equal to the inference variant's), each timed; then the
   backward kernels (``gru_bwd`` from the gate trace, then ``gru_wgrad``)
   against the plain backward twins on the kernel's ``h_out``, the
   recompute twin and the twin from the gate trace (max|kernel - twin| /
   max|twin| <= 1e-4 for dxp on valid steps and for the weight cotangents:
   float32 sums over 400 steps and 40,000 rows in another order), and both
   kernels must give the same bits on two calls;
7. training main path: ``training.train`` of raw_0.98_rgrgr at full width
   (seeded random weights) for 30 ADAMski steps of B = 100 chunks of 2,000
   samples from 1,000 synthetic chunks; every loss must be finite, the three
   GRU kernels must have launched, and one batch's gradients (B = 4) must
   agree with the plain CPU twins' (max|gpu - cpu| / max|cpu| <= 1e-3 per
   parameter: five recurrent layers, and cuDNN's convolution weight
   gradient may sum with atomics);
8. remap kernels: ``remap_banded`` and ``remap_back`` against their plain
   twins at B = 64 on log-posteriors made on the card, at W = 768
   (Tp = 2,048, P = 1,300), the exact form (P = 600, W = 640), W = 3,072,
   W = 777 (not a multiple of 8; T = 1,000), and the remap main path's
   shape (T = 35,429 frames, Tp = 35,584, W = 768, P = 14,763)
   (traceback, final scores, score and path bit-identical, and the same
   bits on a second call); each kernel and each twin timed at the main
   path's shape, beside the previous design's, and each kernel's step
   split by its clocked build (``scripts/bench_remap.py --clocks``);
   ``remap_back`` also beside its design's bytes and its chain's floor
   (Tp shared-memory reads);
9. remap main path: ``Remapper(pretrained_standin(sd=1.5), 5,
   batch_size=64)`` at the default band (768) remaps 64 synthetic DAC
   reads of 40k-120k samples through ``remap_dac_signals``; every kernel
   of the path must have launched, every read must get a registered
   mapping table and a monotone path, and the four shortest reads, whose
   references are too long for their frames, must miss their sequence
   ends and be re-run at W = 3,072.  Then two reads of 13,500 samples
   (references that bucket to P = 1,944 > 768, so both sides run banded
   at W = 768) must agree with the plain CPU path (scores within 1e-4
   relative, >= 99% of frames on the same position: the two forwards
   differ at round-off).  Each read's reference (about L/9 bases) is the
   one the model's own posterior favours along the read's diagonal.
   Random weights need both: at the stand-in's sd of 0.5 the posterior
   is nearly flat and barely follows the signal, so each step's frame is
   a near-tie that round-off flips; and against a random reference every
   banded path misses its sequence ends and is re-run exact at a window
   of ~14,848 positions (a 68 GB traceback at this batch);
10. LSTM forward: the kernel (the inference variant, and the training
    variant with the cell and gate traces) against its plain twin at
    S = 64, ragged lengths, forward and reverse, at the two event paths'
    shapes: B = 64 at T = the events basecall path's longest read, and
    B = 100 at T = 500 (max abs difference of h and c on valid steps, and
    of the gate trace at every step, <= 1e-4: float32 sums in another
    order over thousands of steps), each variant timed; then at S = 96,
    outside the registers mode (sWT staged), at T = 500, B = 100;
11. LSTM backward: ``lstm_bwd`` from the gate trace, then ``lstm_wgrad``,
    against the plain backward twins (the recompute twin and the twin from
    the gate trace) on the kernel's traces at B = 100, T = 500, S = 64,
    ragged lengths with interior holes, forward and reverse (max|kernel -
    twin| / max|twin| <= 1e-4 for dxp on valid steps, dsWT and dp), the
    same bits from ``lstm_bwd`` on two calls, and ``lstm_wgrad`` against
    its einsum twin; then ``lstm_wgrad``'s ms beside its bound and the
    einsums', its launches a call and their device ms (``torch.profiler``),
    its plan, and a slice split by its clocked build (``bench_lstm.py
    --clocks``);
12. events basecall main path: ``baseline_lstm`` at full width (size 64,
    4 features, window 3, k = 5: 1,025 states; seeded random weights)
    basecalls 64 event reads of 3,000-9,000 events (feature matrices from
    seeded event tables through ``data.features.from_events``) in one batch
    of 64 through ``Basecaller.basecall_signals`` in "states" mode; every
    kernel of the path must have launched and every read must get a call,
    and the posterior of 4 reads must agree with the plain CPU forward
    (<= 1e-4); one more call under the profiler;
13. events training main path: ``training.train`` of ``baseline_lstm`` at
    full width for 30 ADAMski steps of B = 100 chunks of 500 events from
    1,000 synthetic chunks (drop 20); every loss must be finite, the three
    LSTM kernels must have launched, and one batch's gradients (B = 4) must
    agree with the plain CPU twins' (<= 1e-3 relative per parameter); then
    a profile of 5 steady steps;
14. diagnostic probes (``sloika_tpu_torch/scripts``) through their entry
    points at the JAX scripts' default shapes, launches counted under their
    own path, "diagnostics": ``gru_unroll`` at T = 400, B = 100, S = 96 and
    144 for U = 1, 2, 4, 8 in both precisions (each within 1e-4 of its f32
    twin, or 2e-3 of its bf16-rounding twin, and equal to U = 1), a step
    split by its clocked build at U = 1 and 8 (``bench_gru_unroll.py
    --clocks``); ``viterbi_parts``'
    eight variants at B = 128, T = 3,277, K = 1,024 (traceback and final
    scores bit-identical to the twin; the Dirichlet(0.05) posterior is drawn
    on the card from a seeded ``torch.Generator``, as numpy's draw of its
    429 M values takes minutes); ``hbm_ring`` at the four (rows, nslots) of
    the script over B = 128, T = 3,264, K = 1,024 (1.71 GB, drawn on the
    card; bit-identical to the twin), its bandwidth beside ``torch.amax``'s,
    and each case's cycles a chunk from the kernel's clocked build
    (``bench_dma.py --clocks``, the same bits).

Every path (5-14) sets the kernels' launch counts to 0 before it runs and
reads them after, and fails if a Viterbi wrapper took its general route
(``general_launches``): the paths decode klen 5 over 4 bases.

Then one JSON line of per-kernel numbers (with the least time the card
could take for each kernel's work, ``bound_ms``, from the shapes run: the
larger of its bytes at 3.35 TB/s and its float32 operations at
67 TFLOP/s), the card line again, and last ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX and no h5py.
"""
import copy
import io
import json
import subprocess
import sys
import time

import numpy as np
import torch

from sloika_tpu_torch.scripts import cuda_ms

T_FRAMES = 3277          # frames of a 16384-sample window at stride 5
BATCH = 64
CHUNK, OVERLAP = 16384, 400
GRU_TOL = 1e-4
POST_TOL = 1e-4
# training shapes (bench.py:369): B chunks of 2,000 samples, T = 400 frames
TRAIN_B, TRAIN_SAMPLES, TRAIN_T = 100, 2000, 400
TRAIN_STEPS, TRAIN_WARM = 30, 5
# the forward kernel's further timed shapes at S = 144 (name, T, B):
# bench.py's production batch of 1,024 windows (bench.py:53-55), and the
# remap path's longest bucket
GRU_EXTRA_SHAPES = (("production batch", T_FRAMES, 1024),
                    ("remap", 35429, 64))
BWD_RTOL = 1e-4
GRAD_RTOL = 1e-3
KERNELS = ("gru_fwd", "gru_bwd", "gru_wgrad", "viterbi_fwd", "viterbi_back",
           "remap_banded", "remap_back", "lstm_fwd", "lstm_bwd", "lstm_wgrad",
           "gru_unroll", "viterbi_parts", "hbm_ring")
#: the clocked builds the phases split steps with, compiled beside the
#: kernels (``scripts.clocked_library``)
CLOCKED = tuple((n, n.upper() + "_CLOCKS") for n in (
    "viterbi_fwd", "viterbi_back", "remap_banded", "remap_back",
    "lstm_wgrad", "gru_unroll", "hbm_ring"))
#: the kernels each main path must launch
PATH_KERNELS = {"basecall": ("gru_fwd", "viterbi_fwd", "viterbi_back"),
                "basecall_raw": ("gru_fwd", "viterbi_fwd", "viterbi_back"),
                "train": ("gru_fwd", "gru_bwd", "gru_wgrad"),
                "remap": ("gru_fwd", "remap_banded", "remap_back"),
                "basecall_events": ("lstm_fwd", "viterbi_fwd",
                                    "viterbi_back"),
                "train_events": ("lstm_fwd", "lstm_bwd", "lstm_wgrad"),
                "diagnostics": ("gru_unroll", "viterbi_parts", "hbm_ring")}
# whole-read raw basecalling: reads a batch, the short reads' samples (their
# CPU twin takes seconds), the score tolerance against the CPU path
RAW_BATCH, RAW_SHORT, RAW_SCORE_RTOL = 8, 20000, 1e-4
# remap: B reads a batch; the main path's longest read buckets to 177,147
# samples, 35,429 frames at stride 5, 35,584 in whole 256-frame blocks
REMAP_B, REMAP_W = 64, 768
REMAP_T_MAIN, REMAP_P_MAIN = 35429, 14763
REMAP_T = 2000
# the odd-width case: a window that is not a multiple of 8, at small T
REMAP_T_ODD, REMAP_W_ODD = 1000, 777
# the four shortest reads get references this many kmers longer than their
# frames: the 768 window cannot reach their ends, the 3,072 window can
REMAP_OVERLONG, REMAP_OVERLONG_EXCESS = 4, 1200
# samples of the two reads the card and the CPU both remap
REMAP_SHORT = 13500
REMAP_SCORE_RTOL, REMAP_SAME_POS = 1e-4, 0.99
# init sd of the remap path's stand-in weights (see phase 9)
REMAP_SD = 1.5
# event paths: baseline_lstm's width; 64 reads of 3,000-9,000 events in one
# batch; training batches of 100 chunks of 500 events
LSTM_S = 64
# the LSTM forward also at a width outside its registers mode (S 33-64)
LSTM_S_STAGED = 96
EVENTS_READS, EVENTS_MIN, EVENTS_MAX = 64, 3000, 9000
# the Viterbi kernels' further timed shapes (name, T, B), beside the
# whole-read raw path's longest batch: bench.py's production batch, and the
# events basecall path's batch
VITERBI_EXTRA_SHAPES = (("production batch", T_FRAMES, 1024),
                        ("events", EVENTS_MAX, EVENTS_READS))
# posteriors the tuned Viterbi kernels do not take (T, B): klen 7, and nbase
# 3 at klen 4, through the kernels' general route
KLEN7_T, KLEN7_B = 200, 2
EVENTS_TRAIN_B, EVENTS_TRAIN_T = 100, 500
# the diagnostic probes at the JAX scripts' defaults: Viterbi parts (B, T),
# the copy ring (B, T); gru_unroll "default" against its bf16 twin: max abs,
# and mean abs as a share of the rounding's own (tests/test_torch_diag_kernels)
DIAG_VITERBI, DIAG_RING = (128, 3277), (128, 3264)
DIAG_BF16_TOL, DIAG_BF16_MEAN = 2e-3, 0.2
# the published peaks of one H100 SXM (NVIDIA data sheet) the bounds use
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def zero_counts(counters):
    """Set every wrapper's launch count, and the Viterbi wrappers' count of
    general-route launches, to 0."""
    for k in counters.values():
        k.launches = 0
        if hasattr(k, "general_launches"):
            k.general_launches = 0


def read_counts(counters):
    """The launches of each kernel since :func:`zero_counts`; raises if a
    Viterbi wrapper launched its general route (``general_launches``): the
    main paths decode klen 5 over nbase 4, the tuned kernels' range."""
    general = {n: k.general_launches for n, k in counters.items()
               if getattr(k, "general_launches", 0)}
    if general:
        raise AssertionError("a main path took the general Viterbi route: "
                             "general_launches {}".format(general))
    return {n: k.launches for n, k in counters.items()}


def bound(nbytes, nflop):
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` and do ``nflop`` float32 operations."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * nflop / F32_FLOP_PER_S
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def with_bound(entry, nbytes, nflop, library_ms=None):
    """Add ``bound_ms``, ``bound_by`` and ``library_ms`` to a kernel entry."""
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, nflop)
    entry["library_ms"] = library_ms
    return entry


def phase_gru(dev, standin):
    from sloika_tpu_torch.nn.fused_gru import gru_forward, gru_scan_plain
    rs = np.random.RandomState(1)
    lengths = rs.randint(T_FRAMES // 2, T_FRAMES + 1, size=BATCH)
    lengths[0] = T_FRAMES
    mask = torch.from_numpy(np.arange(T_FRAMES)[:, None]
                            < lengths[None, :]).to(dev)
    worst, times = 0.0, {}
    for gru in (standin.layers[1].layer, standin.layers[2]):
        S = gru.size
        x = torch.from_numpy(rs.normal(size=(T_FRAMES, BATCH, gru.insize))
                             .astype(np.float32)).to(dev)
        with torch.no_grad():
            xp = gru.input_proj(x).contiguous()
            sWT = gru.sW.reshape(2 * S, S).t().contiguous()
            sW2T = gru.sW2.t().contiguous()
        for reverse in (False, True):
            got = gru_forward(xp, sWT, sW2T, mask=mask, reverse=reverse)
            ref = gru_scan_plain(xp, sWT, sW2T, mask, reverse=reverse)
            d = float(((got - ref).abs() * mask[:, :, None]).max())
            ms = cuda_ms(lambda: gru_forward(xp, sWT, sW2T, mask=mask,
                                             reverse=reverse), 5)
            plain_ms = cuda_ms(lambda: gru_scan_plain(xp, sWT, sW2T, mask,
                                                      reverse=reverse), 1)
            times[(S, reverse)] = (ms, plain_ms)
            worst = max(worst, d)
            print("gru S={} reverse={} T={} B={}: max_abs_err {:.3e} "
                  "kernel {:.3f} ms plain {:.3f} ms".format(
                      S, reverse, T_FRAMES, BATCH, d, ms, plain_ms))
            if not d <= GRU_TOL:
                raise AssertionError("GRU kernel differs from its twin by "
                                     "{} > {}".format(d, GRU_TOL))
    ms, plain_ms = times[(144, False)]
    # at S = 144, forward: per valid step of a row, the products with sWT
    # (S x 2S) and sW2T (S x S), 6 S^2 flop (the gates' elementwise work
    # adds ~3%); xp read and h written once, and the weights.  No PyTorch
    # call computes this GRU: cuDNN applies r after the recurrent product,
    # sloika's candidate is sW2 (r * h)
    S, steps = 144, int(lengths.sum())
    entry = with_bound(
        {"name": "gru_fwd", "route": "cuda",
         "source": "sloika_tpu_torch/csrc/gru_fwd.cu",
         "replaces": "sloika_tpu/nn/pallas_gru.py:41",
         "shape": "T={} B={} S={}".format(T_FRAMES, BATCH, S),
         "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms},
        *gru_fwd_bound(steps, S))
    entry["at_shapes"] = {}
    gru = standin.layers[2]
    for name, T, B in GRU_EXTRA_SHAPES:
        entry["at_shapes"][name] = gru_at_shape(gru, T, B, dev)
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   entry["at_shapes"][name]["max_abs_err"])
    return entry


def gru_fwd_bound(steps, S):
    """gru_fwd's bytes and flop over ``steps`` valid steps of a row."""
    return 4 * (4 * S * steps + 3 * S * S), 6 * S * S * steps


def gru_at_shape(gru, T, B, dev):
    """The forward kernel of the stand-in's S = 144 GRU against its twin on
    valid steps at (T, B), ragged lengths, forward; each timed."""
    from sloika_tpu_torch.nn.fused_gru import gru_forward, gru_scan_plain
    S = gru.size
    gen = torch.Generator(device=dev).manual_seed(T + B)
    with torch.no_grad():
        xp = gru.input_proj(torch.randn((T, B, gru.insize), generator=gen,
                                        device=dev)).contiguous()
        sWT = gru.sW.reshape(2 * S, S).t().contiguous()
        sW2T = gru.sW2.t().contiguous()
    lengths = np.random.RandomState(T).randint(T // 2, T + 1, size=B)
    lengths[0] = T
    mask = torch.from_numpy(np.arange(T)[:, None] < lengths[None, :]).to(dev)
    got = gru_forward(xp, sWT, sW2T, mask=mask)
    ref, plain_ms = timed_once(lambda: gru_scan_plain(xp, sWT, sW2T, mask))
    d = float(((got - ref).abs() * mask[:, :, None]).max())
    del got, ref
    ms = cuda_ms(lambda: gru_forward(xp, sWT, sW2T, mask=mask), 3)
    del xp
    torch.cuda.empty_cache()
    print("gru S={} T={} B={}: max_abs_err {:.3e} kernel {:.3f} ms ({:.3f} "
          "us a step) plain {:.3f} ms".format(S, T, B, d, ms, 1e3 * ms / T,
                                              plain_ms), flush=True)
    if not d <= GRU_TOL:
        raise AssertionError("GRU kernel differs from its twin at T={} B={} "
                             "by {} > {}".format(T, B, d, GRU_TOL))
    out = {"shape": "T={} B={} S={}".format(T, B, S), "max_abs_err": d,
           "ms": ms, "plain_ms": plain_ms}
    out["bound_ms"], out["bound_by"] = bound(
        *gru_fwd_bound(int(lengths.sum()), S))
    return out


def phase_viterbi(dev, standin):
    from sloika_tpu_torch.ops import decode, viterbi_kernel
    from sloika_tpu_torch.scripts import bench_viterbi
    gen = torch.Generator(device=dev).manual_seed(7)
    logits = 4.0 * torch.randn((T_FRAMES, BATCH, 1025), generator=gen,
                               device=dev)
    peaked = torch.softmax(logits, dim=2).contiguous()
    ties = (torch.round(peaked * 8) / 8 + 1e-3).contiguous()
    fwd_t, back_t, err_fwd, err_back = {}, {}, 0.0, 0.0
    for kind, post in (("peaked", peaked), ("ties", ties)):
        v, tb = viterbi_kernel.viterbi_forward(post, 5, skip_pen=5.0)
        v_ref, tb_ref = decode.viterbi_forward_plain(post, 5, skip_pen=5.0)
        last = torch.argmax(v, dim=1)
        path, moved = viterbi_kernel.viterbi_backtrace(tb, last)
        path_ref, moved_ref = decode.viterbi_backtrace_plain(tb, last)
        same = (torch.equal(v, v_ref) and torch.equal(tb, tb_ref)
                and torch.equal(path, path_ref)
                and torch.equal(moved, moved_ref))
        err_fwd = max(err_fwd, float((v - v_ref).abs().max()),
                      float((tb.int() - tb_ref.int()).abs().max()))
        err_back = max(err_back, float((path - path_ref).abs().max()),
                       float((moved.int() - moved_ref.int()).abs().max()))
        fwd_t[kind] = (
            cuda_ms(lambda: viterbi_kernel.viterbi_forward(post, 5, 5.0), 5),
            cuda_ms(lambda: decode.viterbi_forward_plain(post, 5, 5.0), 1))
        back_t[kind] = (
            cuda_ms(lambda: viterbi_kernel.viterbi_backtrace(tb, last), 5),
            cuda_ms(lambda: decode.viterbi_backtrace_plain(tb, last), 1))
        print("viterbi {} K=1024 T={} B={}: bit_identical {} forward kernel "
              "{:.3f} ms plain {:.3f} ms; backtrace kernel {:.3f} ms plain "
              "{:.3f} ms; moves {}".format(
                  kind, T_FRAMES, BATCH, same, *fwd_t[kind], *back_t[kind],
                  int(moved.sum())), flush=True)
        if not same:
            raise AssertionError("Viterbi kernels differ from their twins "
                                 "on the {} posterior".format(kind))
    # each kernel's step split by its clocked build (the same bits), on the
    # peaked posterior
    v, tb = viterbi_kernel.viterbi_forward(peaked, 5, skip_pen=5.0)
    last = torch.argmax(v, dim=1)
    fwd_split = bench_viterbi.fwd_clocks(peaked, (v, tb))
    back_split = bench_viterbi.back_clocks(
        tb, last, viterbi_kernel.viterbi_backtrace(tb, last))
    print("viterbi kernels' steps by phase (cycles, clocked builds, T={} "
          "B={}): viterbi_fwd {:.0f} a step {}; viterbi_back {:.0f} a frame, "
          "walker {}, copier {}, {:.1f} cycles a shared-memory read".format(
              T_FRAMES, BATCH, fwd_split["cycles_per_step"],
              json.dumps(fwd_split["phases_mean"]),
              back_split["cycles_per_step"], json.dumps(back_split["walker"]),
              json.dumps(back_split["copier"]),
              back_split["smem_chase_cycles"]), flush=True)
    del logits, peaked, ties, tb
    torch.cuda.empty_cache()
    fwd_at, back_at = {}, {}
    whole_T = max(raw_batch_frames(standin, [d for d, _ in
                                             synthetic_reads()]))
    general_fwd, general_back = viterbi_general_route(dev, whole_T)
    for name, T, B in VITERBI_EXTRA_SHAPES + (("whole read", whole_T,
                                               RAW_BATCH),):
        fwd_at[name], back_at[name] = viterbi_at_shape(T, B, dev,
                                                       back_split)
        err_fwd = max(err_fwd, fwd_at[name]["max_abs_err"])
        err_back = max(err_back, back_at[name]["max_abs_err"])
    # forward: the posterior read once, int8 codes and final scores
    # written once; 21 candidate adds and compares a state a step.  The
    # backtrace: one code byte read, a path int32 and a move byte written
    # a step; its time is set by a chain of T dependent loads.  No PyTorch
    # call computes either
    shape = "T={} B={} K={}".format(T_FRAMES, BATCH, 1024)
    back = with_bound({"name": "viterbi_back", "route": "cuda",
                       "source": "sloika_tpu_torch/csrc/viterbi_back.cu",
                       "replaces": "sloika_tpu/ops/pallas/viterbi.py:575",
                       "shape": shape,
                       "max_abs_err": err_back, "ms": back_t["peaked"][0],
                       "plain_ms": back_t["peaked"][1]},
                      *viterbi_back_bound(T_FRAMES, BATCH))
    back.update(bench_viterbi.back_design_bounds(T_FRAMES, BATCH, 1024,
                                                 back_split))
    back.update({"cycles_per_step": back_split["cycles_per_step"],
                 "cycles_per_step_by_phase": {
                     "walker": back_split["walker"],
                     "copier": back_split["copier"]},
                 "at_shapes": back_at, "general_route": general_back})
    return [
        with_bound({"name": "viterbi_fwd", "route": "cuda",
                    "source": "sloika_tpu_torch/csrc/viterbi_fwd.cu",
                    "replaces": "sloika_tpu/ops/pallas/viterbi.py:187",
                    "shape": shape,
                    "max_abs_err": err_fwd, "ms": fwd_t["peaked"][0],
                    "plain_ms": fwd_t["peaked"][1],
                    "cycles_per_step": fwd_split["cycles_per_step"],
                    "cycles_per_step_by_phase": fwd_split["phases_mean"],
                    "at_shapes": fwd_at, "general_route": general_fwd},
                   *viterbi_fwd_bound(T_FRAMES, BATCH)),
        back]


def viterbi_general_route(dev, whole_T):
    """Posteriors the tuned Viterbi kernels do not take, on the card,
    through ``viterbi_kernel.viterbi``: they take the kernels' general
    route (``general_launches`` up by one each).  klen 7 (16,385 states)
    and nbase 3 at klen 4 (KLEN7_T, KLEN7_B), paths equal to the CPU twin's;
    then klen 7 at the whole-read raw path's batch (RAW_BATCH reads of
    ``whole_T`` frames), both kernels timed against their plain twins on
    the card, bit-identical to them.

    :returns: (viterbi_fwd's, viterbi_back's) general-route entries
    """
    from sloika_tpu_torch.ops import decode, viterbi_kernel as vk
    wrappers = (vk.viterbi_forward, vk.viterbi_backtrace)
    checks = {}
    for klen, nbase in ((7, 4), (4, 3)):
        gen = torch.Generator(device=dev).manual_seed(71 + nbase)
        post = torch.softmax(4.0 * torch.randn(
            (KLEN7_T, KLEN7_B, nbase ** klen + 1), generator=gen,
            device=dev), dim=2).contiguous()
        before = [(k.launches, k.general_launches) for k in wrappers]
        score, path, moved = vk.viterbi(post, klen, skip_pen=5.0,
                                        nbase=nbase)
        after = [(k.launches, k.general_launches) for k in wrappers]
        ref = decode.viterbi(post.cpu(), klen, skip_pen=5.0, nbase=nbase)
        same_path = (torch.equal(path.cpu(), ref[1])
                     and torch.equal(moved.cpu(), ref[2]))
        score_err = float((score.cpu() - ref[0]).abs().max())
        routed = all(a == (b[0] + 1, b[1] + 1)
                     for a, b in zip(after, before))
        print("viterbi klen {} nbase {} (K = {}) T={} B={} on the card: "
              "general route {} (launches and general_launches before {}, "
              "after {}), on {}; path equal to the CPU twin's {}, score "
              "max_abs_err {:.3e}".format(
                  klen, nbase, nbase ** klen, KLEN7_T, KLEN7_B, routed,
                  before, after, path.device, same_path, score_err),
              flush=True)
        if not (routed and same_path and path.is_cuda
                and score_err <= 1e-4 * float(ref[0].abs().max())):
            raise AssertionError("the general Viterbi route failed at klen "
                                 "{} nbase {}".format(klen, nbase))
        checks["klen {} nbase {}".format(klen, nbase)] = {
            "path_equal_to_cpu_twin": same_path,
            "score_max_abs_err": score_err}
    # klen 7 at the whole-read batch: the kernels against the twins on the
    # card
    T, B, K = whole_T, RAW_BATCH, 4 ** 7
    gen = torch.Generator(device=dev).manual_seed(77)
    post = torch.randn((T, B, K + 1), generator=gen, device=dev)
    post.mul_(4.0)
    post = torch.softmax(post, dim=2)
    before = [k.general_launches for k in wrappers]
    (v, tb), ms = timed_once(lambda: vk.viterbi_forward(post, 7, 5.0))
    last = torch.argmax(v, dim=1)
    (path, moved), back_ms = timed_once(
        lambda: vk.viterbi_backtrace(tb, last))
    launched = [k.general_launches - b for k, b in zip(wrappers, before)]
    (v_ref, tb_ref), plain_ms = timed_once(
        lambda: decode.viterbi_forward_plain(post, 7, skip_pen=5.0))
    same_fwd = torch.equal(v, v_ref) and torch.equal(tb, tb_ref)
    err_fwd = max(float((v - v_ref).abs().max()),
                  float((tb != tb_ref).any()))
    del tb_ref, v_ref
    (path_ref, moved_ref), back_plain_ms = timed_once(
        lambda: decode.viterbi_backtrace_plain(tb, last))
    same_back = (torch.equal(path, path_ref)
                 and torch.equal(moved, moved_ref))
    err_back = max(float((path - path_ref).abs().max()),
                   float((moved != moved_ref).any()))
    ms = min(ms, cuda_ms(lambda: vk.viterbi_forward(post, 7, 5.0), 2))
    back_ms = min(back_ms, cuda_ms(lambda: vk.viterbi_backtrace(tb, last),
                                   2))
    del post, tb
    torch.cuda.empty_cache()
    print("viterbi general route klen 7 (K = 16,384) T={} B={}: "
          "bit_identical to the twins on the card {}; forward kernel {:.3f} "
          "ms ({:.3f} us a step) plain {:.1f} ms; backtrace kernel {:.3f} "
          "ms plain {:.1f} ms; launches {}".format(
              T, B, same_fwd and same_back, ms, 1e3 * ms / T, plain_ms,
              back_ms, back_plain_ms, launched), flush=True)
    if not (same_fwd and same_back and launched == [1, 1]):
        raise AssertionError("the general Viterbi route differs from its "
                             "twins at T={} B={}".format(T, B))
    shape = "T={} B={} K={} (klen 7)".format(T, B, K)
    fwd = with_bound({"shape": shape, "max_abs_err": err_fwd, "ms": ms,
                      "plain_ms": plain_ms, "checks": checks},
                     *viterbi_fwd_bound(T, B, K))
    back = with_bound({"shape": shape, "max_abs_err": err_back,
                       "ms": back_ms, "plain_ms": back_plain_ms},
                      *viterbi_back_bound(T, B))
    return fwd, back


def viterbi_fwd_bound(T, B, K=1024):
    """viterbi_fwd's bytes and operations at (T, B)."""
    return T * B * (K + 1) * 4 + T * B * K + B * K * 4, 42 * T * B * K


def viterbi_back_bound(T, B):
    """viterbi_back's bytes and operations at (T, B): a code read, a state
    and a move written, a step."""
    return T * B * (1 + 4 + 1) + B * 4, 3 * T * B


def viterbi_at_shape(T, B, dev, back_split):
    """Both Viterbi kernels at (T, B), K = 1,024, on a peaked posterior
    drawn on the card, each timed; rows 0-7 of their outputs must be
    bit-identical to the plain twins run on those rows alone (the rows are
    independent; the twins on every row of a batch of 1,024 would take
    minutes)."""
    from sloika_tpu_torch.ops import decode, viterbi_kernel as vk
    from sloika_tpu_torch.scripts import bench_viterbi
    post = bench_viterbi.posterior(T, B, dev, seed=T + B)
    v, tb = vk.viterbi_forward(post, 5, skip_pen=5.0)
    last = torch.argmax(v, dim=1)
    path, moved = vk.viterbi_backtrace(tb, last)
    n = min(B, RAW_BATCH)
    (v_ref, tb_ref), plain_ms = timed_once(
        lambda: decode.viterbi_forward_plain(post[:, :n].contiguous(), 5,
                                             skip_pen=5.0))
    tb_rows = tb[:, :n].contiguous()
    (path_ref, moved_ref), back_plain_ms = timed_once(
        lambda: decode.viterbi_backtrace_plain(tb_rows, last[:n]))
    same_fwd = torch.equal(v[:n], v_ref) and torch.equal(tb_rows, tb_ref)
    same_back = (torch.equal(path[:n], path_ref)
                 and torch.equal(moved[:n], moved_ref))
    err_fwd = max(float((v[:n] - v_ref).abs().max()),
                  float((tb_rows.int() - tb_ref.int()).abs().max()))
    err_back = max(float((path[:n] - path_ref).abs().max()),
                   float((moved[:n].int() - moved_ref.int()).abs().max()))
    del tb_rows, tb_ref
    ms = cuda_ms(lambda: vk.viterbi_forward(post, 5, 5.0), 3)
    back_ms = cuda_ms(lambda: vk.viterbi_backtrace(tb, last), 3)
    del post, tb
    torch.cuda.empty_cache()
    print("viterbi K=1024 T={} B={}: rows 0-{} bit_identical {}; forward "
          "kernel {:.3f} ms ({:.3f} us a step), backtrace kernel {:.3f} ms; "
          "plain twins on {} rows {:.1f} ms and {:.1f} ms".format(
              T, B, n - 1, same_fwd and same_back, ms, 1e3 * ms / T,
              back_ms, n, plain_ms, back_plain_ms), flush=True)
    if not (same_fwd and same_back):
        raise AssertionError("Viterbi kernels differ from their twins at "
                             "T={} B={}".format(T, B))
    shape = "T={} B={} K=1024".format(T, B)
    fwd = {"shape": shape, "max_abs_err": err_fwd, "ms": ms,
           "plain_ms_rows_0_7": plain_ms}
    fwd["bound_ms"], fwd["bound_by"] = bound(*viterbi_fwd_bound(T, B))
    back = {"shape": shape, "max_abs_err": err_back, "ms": back_ms,
            "plain_ms_rows_0_7": back_plain_ms}
    back["bound_ms"], back["bound_by"] = bound(*viterbi_back_bound(T, B))
    back.update(bench_viterbi.back_design_bounds(T, B, 1024, back_split))
    return fwd, back


def rel_err(got, ref, mask=None):
    """(max abs difference, that over max|ref|), under an optional mask."""
    d = (got - ref).abs()
    if mask is not None:
        d = d * mask[:, :, None]
    d = float(d.max())
    return d, d / max(float(ref.abs().max()), 1e-30)


def holes(mask, seed):
    """The (T, B) mask with 10% of its valid steps masked (interior holes;
    the first row stays whole)."""
    rs = np.random.RandomState(seed)
    keep = torch.from_numpy(rs.uniform(size=tuple(mask.shape)) >= 0.1)
    keep[:, 0] = True
    return mask & keep.to(mask.device)


def phase_gru_bwd(dev):
    from sloika_tpu_torch.nn.fused_gru import (
        gru_backward, gru_forward, gru_scan_bwd_gates_plain,
        gru_scan_bwd_plain, gru_scan_plain, gru_wgrad, gru_wgrad_plain)
    S, T, B = 96, TRAIN_T, TRAIN_B
    rs = np.random.RandomState(3)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    xp = f32(rs.normal(size=(T, B, 3 * S)))
    sWT = f32(rs.normal(size=(S, 2 * S)) / np.sqrt(2 * S))
    sW2T = f32(rs.normal(size=(S, S)) / np.sqrt(2 * S))
    g = f32(rs.normal(size=(T, B, S)))
    lengths = rs.randint(T // 2, T + 1, size=B)
    lengths[0] = T
    mask = holes(torch.from_numpy(np.arange(T)[:, None]
                                  < lengths[None, :]).to(dev), 4)
    worst_f = worst_b = worst_w = 0.0
    times, fwd_times = {}, {}
    for reverse in (False, True):
        # the forward's two variants at these shapes; the backward reads
        # the training variant's h_out and gate trace
        h_inf = gru_forward(xp, sWT, sW2T, mask=mask, reverse=reverse)
        h_out, gates = gru_forward(xp, sWT, sW2T, mask=mask,
                                   reverse=reverse, emit_gates=True)
        (h_ref, gates_ref), fwd_plain_ms = timed_once(lambda: gru_scan_plain(
            xp, sWT, sW2T, mask, reverse=reverse, emit_gates=True))
        e_fwd = float(((h_out - h_ref).abs() * mask[:, :, None]).max())
        e_gates = float((gates - gates_ref).abs().max())
        fwd_times[reverse] = (
            cuda_ms(lambda: gru_forward(xp, sWT, sW2T, mask=mask,
                                        reverse=reverse), 5),
            cuda_ms(lambda: gru_forward(xp, sWT, sW2T, mask=mask,
                                        reverse=reverse, emit_gates=True),
                    5), fwd_plain_ms)
        print("gru S={} reverse={} T={} B={}: max_abs_err {:.3e}, gate "
              "trace {:.3e}; inference variant {:.3f} ms, training variant "
              "(with the gate trace) {:.3f} ms; plain {:.3f} ms".format(
                  S, reverse, T, B, e_fwd, e_gates, *fwd_times[reverse]),
              flush=True)
        if not (e_fwd <= GRU_TOL and e_gates <= GRU_TOL
                and torch.equal(h_inf, h_out)):
            raise AssertionError("GRU forward kernel differs from its twin "
                                 "at the training shapes: h {}, gates {} "
                                 "(> {}), or its variants differ".format(
                                     e_fwd, e_gates, GRU_TOL))
        worst_f = max(worst_f, e_fwd, e_gates)
        got = gru_backward(gates, sWT, sW2T, mask, reverse, g, h_out)
        ref = gru_scan_bwd_plain(xp, sWT, sW2T, mask, reverse, g, h_out)
        ref_g, plain_ms = timed_once(lambda: gru_scan_bwd_gates_plain(
            gates, sWT, sW2T, mask, reverse, g, h_out))
        e_dxp = rel_err(got[0], ref[0], mask)
        e_w = [rel_err(a, b) for a, b in zip(got[1:], ref[1:])]
        e_twin = [rel_err(a, b)[1] for a, b in zip(got, ref_g)]
        dxp, rh = gru_backward.recurrence(gates, sWT, sW2T, mask, reverse, g,
                                          h_out)
        again = gru_backward.recurrence(gates, sWT, sW2T, mask, reverse, g,
                                        h_out)
        wk = gru_wgrad(h_out, rh, dxp, reverse)
        e_wt = [rel_err(a, b)[1] for a, b in zip(
            wk, gru_wgrad_plain(h_out, rh, dxp, reverse))]
        if not (torch.equal(dxp, again[0]) and torch.equal(rh, again[1])
                and all(torch.equal(a, b) for a, b in zip(
                    wk, gru_wgrad(h_out, rh, dxp, reverse)))):
            raise AssertionError("gru_bwd or gru_wgrad gave other bits on a "
                                 "second call")
        times[reverse] = (
            cuda_ms(lambda: gru_backward.recurrence(
                gates, sWT, sW2T, mask, reverse, g, h_out), 5), plain_ms,
            cuda_ms(lambda: gru_wgrad(h_out, rh, dxp, reverse), 20),
            cuda_ms(lambda: gru_wgrad_plain(h_out, rh, dxp, reverse), 20))
        worst_b = max(worst_b, e_dxp[0])
        worst_w = max([worst_w] + [e[0] for e in e_w])
        print("gru backward S={} reverse={} T={} B={}: against the recompute "
              "twin dxp max_abs_err {:.3e} (rel {:.3e}), dsWT {:.3e} (rel "
              "{:.3e}), dsW2T {:.3e} (rel {:.3e}); against the gate-trace "
              "twin rel {:.3e} {:.3e} {:.3e}; gru_wgrad vs its einsum twin "
              "rel {:.3e} {:.3e} (both kernels the same bits on two calls); "
              "gru_bwd kernel {:.3f} ms ({:.3f} us a step), plain twin "
              "{:.3f} ms; gru_wgrad kernel {:.3f} ms, einsum {:.3f} ms"
              .format(S, reverse, T, B, *e_dxp, *e_w[0], *e_w[1], *e_twin,
                      *e_wt, times[reverse][0], 1e3 * times[reverse][0] / T,
                      *times[reverse][1:]), flush=True)
        bad = [e for e in [e_dxp[1]] + [e[1] for e in e_w] + e_twin + e_wt
               if not e <= BWD_RTOL]
        if bad:
            raise AssertionError("GRU backward kernels differ from their "
                                 "twins: relative errors {} > {}".format(
                                     bad, BWD_RTOL))
    ms, plain_ms, wms, wplain_ms = times[False]
    shape = "T={} B={} S={}".format(T, B, S)
    steps = int(mask.sum())
    fwd = with_bound({"shape": shape, "max_abs_err": worst_f,
                      "ms": fwd_times[False][0],
                      "ms_training_variant": fwd_times[False][1],
                      "plain_ms": fwd_times[False][2]},
                     *gru_fwd_bound(steps, S))
    # gru_bwd from the gate trace: three products a valid step of a row
    # (da . sW2, dz . sW[:S], dr . sW[S:]: 3 S^2 multiply-adds); the gates,
    # h_out and g read and dxp, r*h written once, and sWT, sW2T.  Beside it
    # the bound of the design that recomputed the gates from xp (four
    # products, 6 S^2 multiply-adds, both weight layouts), the yardstick of
    # earlier records.  gru_wgrad: the two weight sums over the valid rows,
    # 6 S^2 flop a row; h_out, r*h and dxp read once.  Its library time is
    # the einsum pair of its twin; no PyTorch call computes gru_bwd's
    # recurrence
    bwd = with_bound({"name": "gru_bwd", "route": "cuda",
                      "source": "sloika_tpu_torch/csrc/gru_bwd.cu",
                      "replaces": "sloika_tpu/nn/pallas_gru.py:157",
                      "shape": shape,
                      "max_abs_err": worst_b, "ms": ms, "plain_ms": plain_ms},
                     4 * (9 * S * steps + 3 * S * S), 6 * S * S * steps)
    bwd["bound_ms_recompute_design"] = bound(
        4 * (9 * S * steps + 6 * S * S), 12 * S * S * steps)[0]
    return fwd, [
        bwd,
        with_bound({"name": "gru_wgrad", "route": "cuda",
                    "source": "sloika_tpu_torch/csrc/gru_wgrad.cu",
                    "replaces": "sloika_tpu/nn/pallas_gru.py:157",
                    "shape": shape,
                    "max_abs_err": worst_w, "ms": wms, "plain_ms": wplain_ms},
                   4 * (5 * S * steps + 3 * S * S), 6 * S * S * steps,
                   library_ms=wplain_ms)]


def phase_train(dev, counters):
    from sloika_tpu_torch import models, training
    from sloika_tpu_torch.profile_train import StepMarks, synthetic_chunks
    layer = models.network_factory("raw_0.98_rgrgr")(klen=5, sd=0.5,
                                                     seed=0)
    data = synthetic_chunks()
    clock = StepMarks(sync=True)
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, history = training.train(
        layer, data, batch_size=TRAIN_B, chunk_len_range=(1.0, 1.0),
        drop=20, niteration=TRAIN_STEPS, seed=1, log=clock, device=dev)
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    launches = [counts[n] for n in PATH_KERNELS["train"]]
    peak = torch.cuda.max_memory_allocated()
    steps = len(clock.marks) - TRAIN_WARM
    dt = clock.marks[-1] - clock.marks[TRAIN_WARM - 1]
    print("training main path: raw_0.98_rgrgr, {} ADAMski steps of B={} x "
          "{} samples in {:.3f} s; steady state (steps {}-{}): {:.2f} ms a "
          "step, {:.1f} chunks/s; peak memory {:.1f} MiB; loss {:.4f} -> "
          "{:.4f}; launches gru_fwd {} gru_bwd {} gru_wgrad {} [{}]".format(
              TRAIN_STEPS, TRAIN_B, TRAIN_SAMPLES, wall, TRAIN_WARM + 1,
              TRAIN_STEPS, 1e3 * dt / steps, steps * TRAIN_B / dt,
              peak / 2 ** 20, history[0, 0], history[-1, 0], *launches,
              card_line()), flush=True)
    if len(history) != TRAIN_STEPS or not np.isfinite(history).all():
        raise AssertionError("training losses not all finite: {}".format(
            history[:, 0]))
    if min(launches) <= 0:
        raise AssertionError("a GRU kernel of the training path never "
                             "launched: {}".format(launches))

    # one batch's gradients on the card against the plain CPU twins, at
    # the trained weights
    cpu_layer = copy.deepcopy(layer).cpu()
    x, labels, weights = training.ChunkSampler(
        data, 4, TRAIN_SAMPLES, TRAIN_SAMPLES, 5, np.ones(1025, np.float32),
        seed=2).sample()
    grads = []
    for lyr, d in ((layer, dev), (cpu_layer, torch.device("cpu"))):
        lyr.zero_grad(set_to_none=True)
        loss, _ = training.make_loss_fn(lyr, min_prob=1e-30, drop=20)(
            torch.from_numpy(x).to(d),
            torch.from_numpy(labels.astype(np.int64)).to(d),
            torch.from_numpy(weights).to(d))
        loss.backward()
        grads.append([p.grad.cpu() for p in lyr.parameters()])
    errs = [rel_err(a, b)[1] for a, b in zip(*grads)]
    names = [n for n, _ in layer.named_parameters()]
    print("training gradients (B=4, T={}), GPU kernels vs CPU plain twins: "
          "worst max|d|/max|g_cpu| {:.3e} ({})".format(
              TRAIN_T, max(errs), names[int(np.argmax(errs))]), flush=True)
    if not max(errs) <= GRAD_RTOL:
        raise AssertionError("GPU gradients differ from the CPU ones: {}"
                             .format(dict(zip(names, errs))))
    return counts, peak


def synthetic_reads(n=16, seed=5):
    """int16 DAC reads of 40k-120k samples: a step signal (one level per
    base, ~9 samples a step) plus noise, with their normalisation."""
    rs = np.random.RandomState(seed)
    reads = []
    for _ in range(n):
        L = int(rs.randint(40000, 120001))
        levels = rs.normal(size=L // 4)
        sig = np.repeat(levels, rs.geometric(1 / 9.0, size=len(levels)))[:L]
        sig = np.pad(sig, (0, L - len(sig)), mode="edge")
        dac = np.round(sig * 300 + 2000 + rs.normal(scale=30, size=L))
        dac = dac.astype(np.int16)
        off, sc = np.float32(10.0), np.float32(0.15)
        scaled = (dac.astype(np.float32) + off) * sc
        med = np.float32(np.median(scaled))
        mad = np.float32(1.4826 * np.median(np.abs(scaled - med)))
        reads.append((dac, (off, sc, med, mad)))
    return reads


def phase_main(dev, standin, counters):
    from sloika_tpu_torch import basecall as bc

    reads = synthetic_reads()
    cpu_layer = copy.deepcopy(standin).cpu()
    caller = bc.Basecaller(standin, 5, chunk_size=CHUNK, overlap=OVERLAP,
                           batch_size=BATCH, output="bases", device=dev)
    caller.basecall_dac_reads(reads)                 # warm-up
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = caller.basecall_dac_reads(reads)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(counters)
    launches = [counts[n] for n in PATH_KERNELS["basecall"]]
    peak = torch.cuda.max_memory_allocated()
    nsamples = sum(len(d) for d, _ in reads)
    nbases = sum(len(c) for _, c in out)
    nwin = len(bc._window_jobs([len(d) for d, _ in reads], CHUNK, OVERLAP))
    print("main path: {} reads {} windows {} samples -> {} bases in {:.3f} s: "
          "{:.1f} samples/s {:.1f} bases/s, peak memory {:.1f} MiB, "
          "launches gru_fwd {} viterbi_fwd {} viterbi_back {} [{}]".format(
              len(reads), nwin, nsamples, nbases, dt, nsamples / dt,
              nbases / dt, peak / 2 ** 20, *launches, card_line()))
    if min(launches) <= 0:
        raise AssertionError("a kernel of the main path never launched: "
                             "{}".format(launches))
    for i, (score, codes) in enumerate(out):
        if len(codes) == 0 or not np.isfinite(score) or codes.max() > 3:
            raise AssertionError("read {}: bad call (score {}, {} bases)"
                                 .format(i, score, len(codes)))

    # the posterior of one window batch against the plain CPU forward
    sig = np.concatenate([bc.normalise_dac_f32(d, n) for d, n in reads])
    x = torch.from_numpy(
        sig[:4 * CHUNK].reshape(4, CHUNK).T.copy()[:, :, None])
    lengths = torch.full((4,), CHUNK, dtype=torch.int64)
    with torch.inference_mode():
        got, _ = caller._floored_masked_post(x.to(dev), lengths.to(dev))
        ref, _ = bc.Basecaller(cpu_layer, 5, chunk_size=CHUNK,
                               overlap=OVERLAP, output="bases",
                               device="cpu") \
            ._floored_masked_post(x, lengths)
    d = float((got.cpu() - ref).abs().max())
    print("posterior check (4 windows, GPU kernels vs CPU plain forward): "
          "max_abs_err {:.3e}".format(d))
    if not d <= POST_TOL:
        raise AssertionError("posterior differs from the CPU forward by "
                             "{} > {}".format(d, POST_TOL))
    return counts


def raw_signals(reads):
    """Whole raw signals normalised on the host as ``load_raw_signal`` does
    (pA scale, then per-read median/MAD)."""
    from sloika_tpu_torch.basecall import scale_dac_f32
    from sloika_tpu_torch.data.batching import normalise_raw_signal
    return [normalise_raw_signal(scale_dac_f32(d, n4[0], n4[1]))
            for d, n4 in reads]


def first_difference(a, b):
    """Index of the first state at which two calls differ."""
    n = min(len(a), len(b))
    d = np.flatnonzero(a[:n] != b[:n])
    return int(d[0]) if len(d) else n


def raw_batch_frames(layer, sigs):
    """The frames of each batch of whole reads, as ``basecall_signals``
    batches them (in order of length) and the model's strided convolution
    makes them."""
    conv = layer.layers[0]
    lens = sorted(len(s) for s in sigs)
    return [1 + (max(lens[lo:lo + RAW_BATCH]) + sum(conv.padding)
                 - conv.winlen) // conv.stride
            for lo in range(0, len(lens), RAW_BATCH)]


def gru_layers(layer):
    """The GRU layers of a Serial model, reversed ones unwrapped."""
    from sloika_tpu_torch.nn.rnn import Gru
    inner = [getattr(l, "layer", l) for l in layer.layers]
    return [l for l in inner if isinstance(l, Gru)]


def phase_basecall_raw(dev, standin, counters):
    """The default raw path: whole reads through ``Basecaller(output=
    "states").basecall_signals``, then one profiled call; two short reads
    against the CPU plain path."""
    from torch.profiler import ProfilerActivity
    from sloika_tpu_torch import basecall as bc
    sigs = raw_signals(synthetic_reads())
    caller = bc.Basecaller(standin, 5, batch_size=RAW_BATCH, output="states",
                           device=dev)
    caller.basecall_signals(sigs)                    # warm-up
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = caller.basecall_signals(sigs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(counters)
    launches = [counts[n] for n in PATH_KERNELS["basecall_raw"]]
    peak = torch.cuda.max_memory_allocated()
    nsamples = sum(len(x) for x in sigs)
    printer = bc.SeqPrinter(datatype="samples", fh=io.StringIO())
    nbases = sum(printer.write("r", sc, call, 0) for sc, call in out)
    print("whole-read raw basecall path: {} reads {} samples -> {} bases in "
          "{:.3f} s: {:.1f} samples/s {:.1f} bases/s, peak memory {:.1f} "
          "MiB, launches gru_fwd {} viterbi_fwd {} viterbi_back {} [{}]"
          .format(len(sigs), nsamples, nbases, dt, nsamples / dt,
                  nbases / dt, peak / 2 ** 20, *launches, card_line()),
          flush=True)
    if min(launches) <= 0:
        raise AssertionError("a kernel of the whole-read raw path never "
                             "launched: {}".format(launches))
    for i, (score, call) in enumerate(out):
        if len(call) == 0 or not np.isfinite(score):
            raise AssertionError("raw read {}: bad call (score {}, {} "
                                 "states)".format(i, score, len(call)))
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        caller.basecall_signals(sigs)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    print("whole-read raw basecall profile (one call, profiled; batches of "
          "{} reads at T = {} frames): ".format(
              RAW_BATCH, raw_batch_frames(standin, sigs)) +
          profile_table(prof.events(), 1, wall), flush=True)
    # the least time of the call's GRU launches: each layer over each
    # batch's valid frames
    conv = standin.layers[0]
    frames = sorted(1 + (len(x) + sum(conv.padding) - conv.winlen)
                    // conv.stride for x in sigs)
    widths = [l.size for l in gru_layers(standin)]
    gru_bound = sum(bound(*gru_fwd_bound(sum(frames[lo:lo + RAW_BATCH]),
                                         S))[0]
                    for lo in range(0, len(frames), RAW_BATCH)
                    for S in widths)
    print("whole-read raw gru_fwd bound over the call's {} launches (S = {} "
          "over each batch's valid frames): {:.3f} ms (operations: 6 S^2 "
          "flop a valid frame)".format(
              len(widths) * -(-len(frames) // RAW_BATCH), widths, gru_bound),
          flush=True)

    # two short reads on the card and through the plain CPU path
    short = raw_signals([(d[:RAW_SHORT], n4) for d, n4 in
                         synthetic_reads(n=2, seed=9)])
    got = caller.basecall_signals(short)
    ref = bc.Basecaller(copy.deepcopy(standin).cpu(), 5, batch_size=2,
                        output="states", device="cpu").basecall_signals(short)
    rel = max(abs(g[0] - r[0]) / abs(r[0]) for g, r in zip(got, ref))
    same = [len(g[1]) == len(r[1]) and bool(np.all(g[1] == r[1]))
            for g, r in zip(got, ref)]
    first = [None if s else first_difference(g[1], r[1])
             for s, g, r in zip(same, got, ref)]
    print("whole-read raw check (2 reads of {:,} samples, GPU kernels vs CPU "
          "plain path): score max rel err {:.3e}; calls identical {} (first "
          "differing state {}; lengths {} and {})".format(
              RAW_SHORT, rel, same, first, [len(g[1]) for g in got],
              [len(r[1]) for r in ref]), flush=True)
    if not rel <= RAW_SCORE_RTOL:
        raise AssertionError("whole-read raw scores differ from the CPU path "
                             "by {} > {}".format(rel, RAW_SCORE_RTOL))
    return counts


def profile_table(events, nsteps, wall_ms=None):
    """One line of where the device time went, from profiler events."""
    from sloika_tpu_torch.profile_train import device_breakdown
    busy, span, by_kernel = device_breakdown(events, nsteps)
    head = ("wall {:.1f} ms, device busy {:.1f} ms ({:.1%})".format(
        wall_ms, busy, busy / wall_ms) if wall_ms else
        "device busy {:.2f} ms a step, span {:.2f} ms".format(busy, span))
    return head + "; by kernel: " + "; ".join(
        "{} {:.2f} ms x{:.0f}".format(name[:48], ms, n)
        for ms, n, name in by_kernel[:10])


def timed_once(fn):
    """(fn(), its milliseconds by CUDA events), one run, no warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def remap_bytes(T, Tp, B, W, P):
    """Bytes the banded DP must move: the posterior read once, its
    sequences, masks, priors and schedule, the int16 traceback and final
    scores written once."""
    return T * B * 1025 * 4 + B * P * 9 + Tp * B * 4 + Tp * B * W * 2 \
        + B * W * 4


def phase_remap_kernels(dev):
    from sloika_tpu_torch.ops import remap_kernel as rk
    from sloika_tpu_torch.scripts import bench_remap
    gen = torch.Generator(device=dev).manual_seed(11)
    worst_tb = worst_back = 0.0
    cases = (("W=768", REMAP_T, 1300, REMAP_W), ("exact", REMAP_T, 600, 640),
             ("W=3072", REMAP_T, 5000, 4 * REMAP_W),
             ("W=777", REMAP_T_ODD, 1300, REMAP_W_ODD),
             ("main path's shape", REMAP_T_MAIN, REMAP_P_MAIN, REMAP_W))
    for name, T, P, W in cases:
        lt = torch.log_softmax(
            2.0 * torch.randn((T, REMAP_B, 1025), generator=gen, device=dev),
            dim=2).contiguous()
        seq, mask, p0, p1, starts = bench_remap.remap_inputs(dev, lt, P, W,
                                                             seed=W + T)
        tb, vfinal = rk.remap_banded(lt, seq, mask, p0, starts, 5.0, W)
        score, path = rk.finish_banded(tb, vfinal, starts, p1,
                                       rk.remap_backtrack)
        # the same bits on a second call of each
        tb2, vfinal2 = rk.remap_banded(lt, seq, mask, p0, starts, 5.0, W)
        again = (torch.equal(tb2, tb) and torch.equal(vfinal2, vfinal)
                 and torch.equal(rk.remap_backtrack(tb, starts, path[-1]),
                                 path))
        del tb2
        (tb_p, vfinal_p), plain_ms = timed_once(
            lambda: rk.remap_banded_plain(lt, seq, mask, p0, starts, 5.0, W))
        score_p, path_p = rk.finish_banded(tb_p, vfinal_p, starts, p1,
                                           rk.remap_backtrack_plain)
        torch.cuda.synchronize()
        same = (torch.equal(tb, tb_p) and torch.equal(vfinal, vfinal_p)
                and torch.equal(score, score_p) and torch.equal(path, path_p))
        worst_tb = max(worst_tb, float((tb.int() - tb_p.int()).abs().max()),
                       float((vfinal - vfinal_p).abs().max()),
                       float((score - score_p).abs().max()))
        worst_back = max(worst_back, float((path - path_p).abs().max()))
        Tp = starts.shape[0]
        print("remap kernels {} (T={} Tp={} B={} P={} W={}): bit_identical "
              "{}; same bits on a second call {}; slips in the path "
              "{}".format(name, T, Tp, REMAP_B, P, W, same, again,
                          int(((path[1:] - path[:-1]) >= 2).sum())),
              flush=True)
        if not (same and again):
            raise AssertionError("remap kernels differ from their twins or "
                                 "from their first call ({})".format(name))
        del tb_p
    # each kernel and each twin timed at the main path's shape (the last),
    # and each kernel's step split by its clocked build (the same bits)
    last = path[-1]
    args = (lt, seq, mask, p0, starts, 5.0, W)
    ms = cuda_ms(lambda: rk.remap_banded(*args), 3)
    back_ms = cuda_ms(lambda: rk.remap_backtrack(tb, starts, last), 3)
    _, back_plain_ms = timed_once(
        lambda: rk.remap_backtrack_plain(tb, starts, last))
    banded_split = bench_remap.banded_clocks(args, (tb, vfinal))
    back_split = bench_remap.back_clocks((tb, starts, last), path)
    del lt, tb, args
    torch.cuda.empty_cache()
    shape = "T={} Tp={} B={} W={} P={}".format(T, Tp, REMAP_B, W, P)
    # remap_back's design reads the whole traceback once; its chain is Tp
    # shared-memory reads at the clocked build's clock
    design_bytes = Tp * REMAP_B * (W * 2 + 4 + 4) + REMAP_B * 4
    chain_floor_ms = (Tp * back_split["smem_chase_cycles"]
                      / (back_split["ghz"] * 1e6))
    print("remap kernels at the main path's shape ({}): remap_banded "
          "{:.3f} ms ({:.3f} us, {:.0f} cycles a step), remap_back {:.3f} "
          "ms ({:.0f} cycles a step; its design's bytes {:.3f} ms, its "
          "chain floor {:.3f} ms at {:.1f} cycles a shared-memory read); "
          "plain twins {:.1f} ms and {:.1f} ms".format(
              shape, ms, 1e3 * ms / Tp, banded_split["cycles_per_step"],
              back_ms, back_split["cycles_per_step"],
              bound(design_bytes, 0)[0], chain_floor_ms,
              back_split["smem_chase_cycles"], plain_ms, back_plain_ms),
          flush=True)
    print("remap kernels' steps by phase (cycles, clocked builds): "
          "remap_banded {}; remap_back walker {}, copier {}".format(
              json.dumps(banded_split["phases_mean"]),
              json.dumps(back_split["walker"]),
              json.dumps(back_split["copier"])), flush=True)
    # remap_banded: ~13 float32 operations a window lane a step; the
    # backtrace reads one delta and one window start and writes one
    # position a step (its time is set by a chain of Tp dependent loads).
    # No PyTorch call computes either
    return [
        with_bound({"name": "remap_banded", "route": "cuda",
                    "source": "sloika_tpu_torch/csrc/remap_banded.cu",
                    "replaces": "sloika_tpu/ops/pallas/remap.py:69",
                    "shape": shape, "max_abs_err": worst_tb, "ms": ms,
                    "plain_ms": plain_ms,
                    "cycles_per_step": banded_split["cycles_per_step"],
                    "cycles_per_step_by_phase": banded_split["phases_mean"]},
                   remap_bytes(T, Tp, REMAP_B, W, P), 13 * Tp * REMAP_B * W),
        with_bound({"name": "remap_back", "route": "cuda",
                    "source": "sloika_tpu_torch/csrc/remap_back.cu",
                    "replaces": "sloika_tpu/ops/pallas/remap.py:161",
                    "shape": shape, "max_abs_err": worst_back,
                    "ms": back_ms, "plain_ms": back_plain_ms,
                    "design_bytes_bound_ms": bound(design_bytes, 0)[0],
                    "chain_floor_ms": chain_floor_ms,
                    "cycles_per_step": back_split["cycles_per_step"],
                    "cycles_per_step_by_phase": {
                        "walker": back_split["walker"],
                        "copier": back_split["copier"]}},
                   Tp * REMAP_B * (2 + 4 + 4) + REMAP_B * 4,
                   3 * Tp * REMAP_B)]


def diagonal_references(layer, reads, dev, overlong=(), samples_per_base=9):
    """A reference of about L/9 bases for each DAC read: the kmers the
    model's posterior favours along the read's diagonal, kmer j at frame
    j * nframes / npos, each extending the one before by the best of the
    four bases.  (With random weights the posterior is nearly flat; a
    random reference would leave every banded path off its anchors.)  The
    reads indexed in ``overlong`` get REMAP_OVERLONG_EXCESS more kmers than
    frames instead: a band that moves a position a frame at most cannot
    reach their ends."""
    from sloika_tpu_torch import remap as tremap
    from sloika_tpu_torch.basecall import gather_normalise_dac
    L = np.array([len(d) for d, _ in reads], np.int64)
    T = tremap.bucket_length(int(L.max()))
    offsets = np.concatenate([[0], np.cumsum(L)[:-1]])
    flat = np.concatenate([d for d, _ in reads] + [np.zeros(T, np.int16)])
    norms = np.array([n4 for _, n4 in reads], np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    with torch.inference_mode():
        x = gather_normalise_dac(t(flat), t(offsets), t(L), t(norms), T)
        post, nframes = layer.apply_with_lengths(x, t(L))
        nkmer = L // samples_per_base - 4
        for i in overlong:
            nkmer[i] = int(nframes[i]) + REMAP_OVERLONG_EXCESS
        rows = torch.arange(len(reads), device=dev)
        j = torch.arange(int(nkmer.max()), device=dev)
        frame = torch.minimum(j[None, :] * nframes[:, None]
                              // t(nkmer)[:, None], nframes[:, None] - 1)
        state = torch.argmax(post[frame[:, 0], rows, 1:], dim=1)
        kmers = [state]
        four = torch.arange(4, device=dev)
        for i in range(1, frame.shape[1]):
            cand = (state % 256)[:, None] * 4 + four
            best = torch.argmax(torch.gather(post[frame[:, i], rows], 1,
                                             cand + 1), dim=1)
            state = cand[rows, best]
            kmers.append(state)
        kmers = torch.stack(kmers, dim=1).cpu().numpy()
        del post, x
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    refs = []
    for b, n in enumerate(nkmer):
        first = (kmers[b, 0] >> (2 * np.arange(4, -1, -1))) & 3
        refs.append(alphabet[np.concatenate([first, kmers[b, 1:n] & 3])]
                    .tobytes())
    return refs


def phase_remap(dev, counters):
    from sloika_tpu_torch import models
    from sloika_tpu_torch import remap as tremap
    from sloika_tpu_torch.basecall import normalise_dac_f32
    from sloika_tpu_torch.data.raw_chunkify import mapping_table_is_registered

    standin = models.pretrained_standin(sd=REMAP_SD, seed=0).to(dev).eval()
    reads = synthetic_reads(n=REMAP_B)
    overlong = np.argsort([len(d) for d, _ in reads])[:REMAP_OVERLONG]
    refs = diagonal_references(standin, reads, dev, overlong)
    remapper = tremap.Remapper(standin, 5, batch_size=REMAP_B, device=dev)
    remapper.remap_dac_signals(reads, refs)              # warm-up
    remapper.reruns.clear()
    remapper.windows.clear()
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = remapper.remap_dac_signals(reads, refs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(counters)
    launches = [counts[n] for n in PATH_KERNELS["remap"]]
    peak = torch.cuda.max_memory_allocated()
    nsamples = sum(len(d) for d, _ in reads)
    reruns = dict(remapper.reruns)
    print("remap main path: {} reads {} samples, references {}-{} bases, "
          "band {}, in {:.3f} s: {:.1f} samples/s, peak memory {:.1f} MiB, "
          "launches gru_fwd {} remap_banded {} remap_back {}; reads re-run "
          "by band (None: exact) {}; DP batches by window {} [{}]".format(
              len(reads), nsamples, min(map(len, refs)), max(map(len, refs)),
              remapper.band, dt, nsamples / dt, peak / 2 ** 20, *launches,
              reruns, dict(remapper.windows), card_line()), flush=True)
    if reruns.get(4 * remapper.band, 0) < REMAP_OVERLONG:
        raise AssertionError("the {} reads with overlong references were not "
                             "re-run at W = {}: {}".format(
                                 REMAP_OVERLONG, 4 * remapper.band, reruns))
    if min(launches) <= 0:
        raise AssertionError("a kernel of the remap path never launched: "
                             "{}".format(launches))

    # where the time goes: one more call under the profiler
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        remapper.remap_dac_signals(reads, refs)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    print("remap profile (one call, profiled): " +
          profile_table(prof.events(), 1, wall), flush=True)

    for i, ((d, n4), (score, table, path, _)) in enumerate(zip(reads, out)):
        if not (np.isfinite(score) and np.all(np.diff(path) >= 0)
                and mapping_table_is_registered(normalise_dac_f32(d, n4),
                                                table)):
            raise AssertionError("read {}: bad remap (score {}, path {}..{})"
                                 .format(i, score, path.min(), path.max()))

    # two shorter reads on the card and through the plain CPU path, at the
    # same band: their references bucket past the band, so both run banded
    short = [(d[:REMAP_SHORT], n4) for d, n4 in synthetic_reads(n=2, seed=9)]
    short_refs = diagonal_references(standin, short, dev)
    cpu = tremap.Remapper(copy.deepcopy(standin).cpu(), 5, batch_size=2,
                          band=remapper.band, device="cpu")
    remapper.windows.clear()
    got = remapper.remap_dac_signals(short, short_refs)
    ref = cpu.remap_dac_signals(short, short_refs)
    rel = max(abs(g[0] - r[0]) / abs(r[0]) for g, r in zip(got, ref))
    same = (sum(int((g[2] == r[2]).sum()) for g, r in zip(got, ref))
            / sum(len(r[2]) for r in ref))
    print("remap check (2 reads of {:,} samples, references {} bases, GPU "
          "kernels vs CPU plain path): DP windows {} and {}; score max rel "
          "err {:.3e}, frames on the same position {:.4f}".format(
              REMAP_SHORT, [len(r) for r in short_refs],
              dict(remapper.windows), dict(cpu.windows), rel, same),
          flush=True)
    if not (remapper.band in cpu.windows and remapper.windows == cpu.windows):
        raise AssertionError("the check did not run banded at W = {} on "
                             "both sides".format(remapper.band))
    if not (rel <= REMAP_SCORE_RTOL and same >= REMAP_SAME_POS):
        raise AssertionError("remap on the card differs from the CPU path: "
                             "score rel err {}, same position {}".format(
                                 rel, same))
    return counts


def event_reads(n=EVENTS_READS, seed=13):
    """Feature matrices (T, 4) of ``n`` event reads of EVENTS_MIN-EVENTS_MAX
    events, made from seeded event tables (mean, stdv, length) by the
    port's ``from_events``, as ``load_event_features`` makes them."""
    from sloika_tpu_torch.data.features import from_events
    rs = np.random.RandomState(seed)
    lengths = rs.randint(EVENTS_MIN, EVENTS_MAX + 1, size=n)
    lengths[0] = EVENTS_MAX
    reads = []
    for L in lengths:
        ev = np.zeros(L, dtype=[("mean", "f8"), ("stdv", "f8"),
                                ("length", "f8")])
        ev["mean"] = 90 + 12 * rs.normal(size=L)
        ev["stdv"] = rs.uniform(0.5, 3.0, size=L)
        ev["length"] = rs.geometric(0.1, size=L) / 4000.0
        reads.append(from_events(ev, tag=""))
    return reads


def seeded_weights(layer, seed, sd=0.5):
    """Draw every parameter of ``layer`` from numpy at sd / sqrt(fan-in)
    (baseline_lstm's first feed-forward layer starts at zero, as in the
    JAX model, which would make the layers after it see no signal)."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(
                (sd * rs.normal(size=tuple(p.shape))
                 / np.sqrt(p.shape[-1])).astype(np.float32)))
    return layer


def lstm_bound(steps, S, cout):
    """lstm_fwd: 8 S^2 flop a valid step of a row (the product with sWT,
    S x 4S; the cell's elementwise work adds ~4%); xp read, h (and c)
    written once, and the weights."""
    return 4 * ((5 + cout) * S * steps + 4 * S * S + 3 * S), 8 * S * S * steps


def phase_lstm(dev, serve_T):
    """The LSTM forward kernel against its twin at both event paths'
    shapes; returns its kernel entry (timed at the serving shape)."""
    from sloika_tpu_torch.nn.fused_lstm import (lstm_forward, lstm_fwd_plan,
                                                lstm_scan_plain)
    S = LSTM_S
    rs = np.random.RandomState(17)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    sWT = f32(rs.normal(size=(S, 4 * S)) / np.sqrt(2 * S))
    p = f32(rs.normal(size=(3, S)) / np.sqrt(S))
    worst, entry = 0.0, {}
    for name, T, B in (("serving", serve_T, EVENTS_READS),
                       ("training", EVENTS_TRAIN_T, EVENTS_TRAIN_B),
                       ("staged", EVENTS_TRAIN_T, EVENTS_TRAIN_B)):
        if name == "staged":
            # a width outside the registers mode: sWT staged in shared memory
            S = LSTM_S_STAGED
            sWT = f32(rs.normal(size=(S, 4 * S)) / np.sqrt(2 * S))
            p = f32(rs.normal(size=(3, S)) / np.sqrt(S))
        xp = f32(rs.normal(size=(T, B, 4 * S)))
        lengths = rs.randint(T // 3, T + 1, size=B)
        lengths[0] = T
        mask = torch.from_numpy(np.arange(T)[:, None]
                                < lengths[None, :]).to(dev)
        m = mask[:, :, None]
        steps = int(lengths.sum())
        for reverse in (False, True):
            h, c, gates = lstm_forward(xp, sWT, p, mask=mask,
                                       reverse=reverse, emit_gates=True)
            h2, _ = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                                 emit_cout=False)
            (href, cref, gref), plain_ms = timed_once(
                lambda: lstm_scan_plain(xp, sWT, p, mask, reverse,
                                        emit_gates=True))
            d = max([float(((a - b).abs() * m).max())
                     for a, b in ((h, href), (c, cref), (h2, href))]
                    + [float((gates - gref).abs().max())])
            ms = cuda_ms(lambda: lstm_forward(
                xp, sWT, p, mask=mask, reverse=reverse, emit_cout=False), 5)
            ms_t = cuda_ms(lambda: lstm_forward(
                xp, sWT, p, mask=mask, reverse=reverse, emit_gates=True), 5)
            worst = max(worst, d)
            print("lstm {} S={} reverse={} T={} B={} (mode {}): "
                  "max_abs_err {:.3e} inference variant {:.3f} ms ({:.3f} us "
                  "a step), training variant (cell and gate traces) {:.3f} "
                  "ms; plain {:.3f} ms".format(
                      name, S, reverse, T, B, lstm_fwd_plan(B, S)["mode"], d,
                      ms, 1e3 * ms / T, ms_t, plain_ms), flush=True)
            if not d <= GRU_TOL:
                raise AssertionError("LSTM forward kernel differs from its "
                                     "twin by {} > {}".format(d, GRU_TOL))
            if not reverse:
                entry[name] = with_bound(
                    {"shape": "T={} B={} S={}".format(T, B, S), "ms": ms,
                     "ms_training_variant": ms_t, "plain_ms": plain_ms},
                    *lstm_bound(steps, S, 0))
    # no PyTorch call computes this cell: cuDNN's LSTM has no peepholes
    serving = entry.pop("serving")
    serving.update({"name": "lstm_fwd", "route": "cuda",
                    "source": "sloika_tpu_torch/csrc/lstm_fwd.cu",
                    "replaces": "sloika_tpu/nn/pallas_lstm.py:69",
                    "max_abs_err": worst,
                    "at_training_shapes": entry["training"],
                    "outside_registers_mode": entry["staged"]})
    return serving


def phase_lstm_bwd(dev):
    from sloika_tpu_torch.nn.fused_lstm import (
        lstm_backward, lstm_forward, lstm_scan_bwd_gates_plain,
        lstm_scan_bwd_plain, lstm_wgrad, lstm_wgrad_plain)
    from sloika_tpu_torch.scripts import bench_lstm
    S, T, B = LSTM_S, EVENTS_TRAIN_T, EVENTS_TRAIN_B
    rs = np.random.RandomState(19)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    xp = f32(rs.normal(size=(T, B, 4 * S)))
    sWT = f32(rs.normal(size=(S, 4 * S)) / np.sqrt(2 * S))
    p = f32(rs.normal(size=(3, S)) / np.sqrt(S))
    g = f32(rs.normal(size=(T, B, S)))
    lengths = rs.randint(T // 2, T + 1, size=B)
    lengths[0] = T
    mask = holes(torch.from_numpy(np.arange(T)[:, None]
                                  < lengths[None, :]).to(dev), 20)
    worst_b = worst_w = 0.0
    times = {}
    for reverse in (False, True):
        h, c, gates = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                                   emit_gates=True)
        got = lstm_backward(gates, sWT, p, mask, reverse, g, h, c)
        ref = lstm_scan_bwd_plain(xp, sWT, p, mask, reverse, g, h, c)
        ref_g, plain_ms = timed_once(lambda: lstm_scan_bwd_gates_plain(
            gates, sWT, p, mask, reverse, g, h, c))
        e_dxp = rel_err(got[0], ref[0], mask)
        e_w = [rel_err(a, b) for a, b in zip(got[1:], ref[1:])]
        e_twin = [rel_err(a, b)[1] for a, b in zip(got, ref_g)]
        e_wt = [rel_err(a, b)[1] for a, b in zip(
            lstm_wgrad(h, c, got[0], reverse),
            lstm_wgrad_plain(h, c, got[0], reverse))]
        if not torch.equal(got[0], lstm_backward.recurrence(
                gates, sWT, p, mask, reverse, g, c)):
            raise AssertionError("lstm_bwd gave other bits on a second call")
        times[reverse] = (
            cuda_ms(lambda: lstm_backward.recurrence(
                gates, sWT, p, mask, reverse, g, c), 5), plain_ms,
            cuda_ms(lambda: lstm_wgrad(h, c, got[0], reverse), 20),
            cuda_ms(lambda: lstm_wgrad_plain(h, c, got[0], reverse), 20))
        worst_b = max(worst_b, e_dxp[0])
        worst_w = max([worst_w] + [e[0] for e in e_w])
        print("lstm backward S={} reverse={} T={} B={}: against the "
              "recompute twin dxp max_abs_err {:.3e} (rel {:.3e}), dsWT "
              "{:.3e} (rel {:.3e}), dp {:.3e} (rel {:.3e}); against the "
              "gate-trace twin rel {:.3e} {:.3e} {:.3e}; lstm_wgrad vs its "
              "einsum twin rel {:.3e} {:.3e} (lstm_bwd the same bits on two "
              "calls); lstm_bwd kernel {:.3f} ms ({:.3f} us a step), plain "
              "twin {:.3f} ms; lstm_wgrad kernel {:.3f} ms, einsum {:.3f} ms"
              .format(S, reverse, T, B, *e_dxp, *e_w[0], *e_w[1], *e_twin,
                      *e_wt, times[reverse][0], 1e3 * times[reverse][0] / T,
                      *times[reverse][1:]), flush=True)
        bad = [e for e in [e_dxp[1]] + [e[1] for e in e_w] + e_twin + e_wt
               if not e <= BWD_RTOL]
        if bad:
            raise AssertionError("LSTM backward kernels differ from their "
                                 "twins: relative errors {} > {}".format(
                                     bad, BWD_RTOL))
        if reverse is False:
            wgrad_in = (h, c, got[0])
    ms, plain_ms, wms, wplain_ms = times[False]
    wgrad = lstm_wgrad_split(*wgrad_in, wms, wplain_ms, int(mask.sum()))
    shape = "T={} B={} S={}".format(T, B, S)
    steps = int(mask.sum())
    # lstm_bwd from the gate trace: one product a valid step of a row
    # (dg . sW: 4 S^2 multiply-adds); the gates, c_out (c_prev is c_out a
    # step earlier, the same input) and g read and dxp written once, and
    # sWT, p.  Beside it the bound of the design that recomputed the gates
    # from xp (two products, 8 S^2 multiply-adds, xp, g, h, c read, both
    # weight layouts), the yardstick of earlier records.  lstm_wgrad: the
    # weight sum over the valid rows, 8 S^2 flop a row (the peephole sums
    # add 6 S); h, c and dxp read once.  Its library time is the einsums of
    # its twin; no PyTorch call computes lstm_bwd's recurrence
    bwd = with_bound({"name": "lstm_bwd", "route": "cuda",
                      "source": "sloika_tpu_torch/csrc/lstm_bwd.cu",
                      "replaces": "sloika_tpu/nn/pallas_lstm.py:119",
                      "shape": shape, "max_abs_err": worst_b, "ms": ms,
                      "plain_ms": plain_ms},
                     4 * (10 * S * steps + 4 * S * S + 3 * S),
                     8 * S * S * steps)
    bwd["bound_ms_recompute_design"] = bound(
        4 * (11 * S * steps + 8 * S * S + 3 * S), 16 * S * S * steps)[0]
    entry = with_bound({"name": "lstm_wgrad", "route": "cuda",
                        "source": "sloika_tpu_torch/csrc/lstm_wgrad.cu",
                        "replaces": "sloika_tpu/nn/pallas_lstm.py:119",
                        "shape": shape, "max_abs_err": worst_w, "ms": wms,
                        "plain_ms": wplain_ms},
                       *bench_lstm.wgrad_bound(steps, S),
                       library_ms=wplain_ms)
    entry.update(wgrad)
    return [bwd, entry]


def kernel_name(key):
    """A profiler's kernel name without its namespace and parameters."""
    return key.replace("(anonymous namespace)::", "").split("(")[0].split()[-1]


def lstm_wgrad_split(h, c, dxp, ms, einsum_ms, rows):
    """``lstm_wgrad`` at the event-training shape: its launches a call and
    their device ms (``torch.profiler``), its plan and a slice split by the
    clocked build (``bench_lstm --clocks``), beside its bound and the
    einsum twin."""
    from sloika_tpu_torch.nn import fused_lstm
    from sloika_tpu_torch.scripts import bench_lstm
    T, B, S = h.shape
    by_launch = bench_lstm.wgrad_launches(h, c, dxp)
    clocks = bench_lstm.wgrad_clocks(
        h, c, dxp, fused_lstm.lstm_wgrad(h, c, dxp, False))
    plan = fused_lstm.lstm_wgrad_plan(T, B, S)
    bound_ms, bound_by = bound(*bench_lstm.wgrad_bound(rows, S))
    print("lstm_wgrad T={} B={} S={}: kernel {:.4f} ms, bound {:.4f} ms "
          "({}), einsum {:.4f} ms; {} launches a call: {}; plan {} splits "
          "of {} rows, {} x {} threads, slices of {}; "
          "clocked build {:.0f} cycles a slice {} [{}]".format(
              T, B, S, ms, bound_ms, bound_by, einsum_ms,
              sum(v["launches_a_call"] for v in by_launch.values()),
              {kernel_name(k): round(v["ms_a_call"], 4)
               for k, v in by_launch.items()}, plan["nsplit"],
              plan["rows_per_split"], plan["ncb"], plan["threads"],
              plan["kb"],
              clocks["cycles_per_slice"],
              {k: round(v) for k, v in clocks["phases_mean"].items()},
              card_line()), flush=True)
    return {"launches_a_call": sum(v["launches_a_call"]
                                   for v in by_launch.values()),
            "ms_by_launch": {kernel_name(k): v["ms_a_call"]
                             for k, v in by_launch.items()},
            "plan": plan,
            "cycles_per_slice": clocks["cycles_per_slice"],
            "cycles_per_slice_by_phase": clocks["phases_mean"]}


def phase_basecall_events(dev, counters, reads):
    from torch.profiler import ProfilerActivity
    from sloika_tpu_torch import basecall as bc
    from sloika_tpu_torch import models
    layer = seeded_weights(models.network_factory("baseline_lstm")(
        klen=5, sd=0.5, size=LSTM_S), seed=21)
    cpu_layer = copy.deepcopy(layer)
    caller = bc.Basecaller(layer, 5, batch_size=EVENTS_READS,
                           output="states", device=dev)
    caller.basecall_signals(reads)                   # warm-up
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = caller.basecall_signals(reads)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(counters)
    launches = [counts[n] for n in PATH_KERNELS["basecall_events"]]
    peak = torch.cuda.max_memory_allocated()
    nev = sum(len(r) for r in reads)
    printer = bc.SeqPrinter(datatype="events", fh=io.StringIO())
    nbases = sum(printer.write("r", sc, call, 0) for sc, call in out)
    print("events basecall main path: baseline_lstm (size {}), {} reads "
          "{} events -> {} bases in {:.3f} s: {:.1f} events/s {:.1f} "
          "bases/s, peak memory {:.1f} MiB, launches lstm_fwd {} "
          "viterbi_fwd {} viterbi_back {} [{}]".format(
              LSTM_S, len(reads), nev, nbases, dt, nev / dt, nbases / dt,
              peak / 2 ** 20, *launches, card_line()), flush=True)
    if min(launches) <= 0:
        raise AssertionError("a kernel of the events basecall path never "
                             "launched: {}".format(launches))
    for i, (score, call) in enumerate(out):
        if len(call) == 0 or not np.isfinite(score):
            raise AssertionError("event read {}: bad call (score {}, {} "
                                 "states)".format(i, score, len(call)))

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        caller.basecall_signals(reads)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    print("events basecall profile (one call, profiled): " +
          profile_table(prof.events(), 1, wall), flush=True)

    # the posterior of 4 reads on the card against the plain CPU forward
    four = reads[:4]
    T = max(len(r) for r in four)
    x = np.zeros((T, 4, 4), np.float32)
    for b, r in enumerate(four):
        x[:len(r), b] = r
    lengths = torch.tensor([len(r) for r in four])
    with torch.inference_mode():
        got, _ = caller._floored_masked_post(torch.from_numpy(x).to(dev),
                                             lengths.to(dev))
        ref, _ = bc.Basecaller(cpu_layer, 5, output="states",
                               device="cpu")._floored_masked_post(
            torch.from_numpy(x), lengths)
    d = float((got.cpu() - ref).abs().max())
    print("events posterior check (4 reads, GPU kernels vs CPU plain "
          "forward): max_abs_err {:.3e}".format(d), flush=True)
    if not d <= POST_TOL:
        raise AssertionError("events posterior differs from the CPU forward "
                             "by {} > {}".format(d, POST_TOL))
    return counts


def phase_train_events(dev, counters):
    from torch.profiler import ProfilerActivity, schedule
    from sloika_tpu_torch import models, training
    from sloika_tpu_torch.profile_train import (StepMarks,
                                                synthetic_event_chunks)
    layer = seeded_weights(models.network_factory("baseline_lstm")(
        klen=5, sd=0.5, size=LSTM_S), seed=25)
    data = synthetic_event_chunks()
    clock = StepMarks(sync=True)
    kw = dict(batch_size=EVENTS_TRAIN_B, chunk_len_range=(1.0, 1.0),
              drop=20, seed=1, device=dev)
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, history = training.train(layer, data, niteration=TRAIN_STEPS,
                                log=clock, **kw)
    wall = time.perf_counter() - t0
    counts = read_counts(counters)
    launches = [counts[n] for n in PATH_KERNELS["train_events"]]
    peak = torch.cuda.max_memory_allocated()
    steps = len(clock.marks) - TRAIN_WARM
    dt = clock.marks[-1] - clock.marks[TRAIN_WARM - 1]
    print("events training main path: baseline_lstm (size {}), {} ADAMski "
          "steps of B={} x {} events in {:.3f} s; steady state (steps "
          "{}-{}): {:.2f} ms a step, {:.1f} chunks/s; peak memory {:.1f} "
          "MiB; loss {:.4f} -> {:.4f}; launches lstm_fwd {} lstm_bwd {} "
          "lstm_wgrad {} [{}]".format(
              LSTM_S, TRAIN_STEPS, EVENTS_TRAIN_B, EVENTS_TRAIN_T, wall,
              TRAIN_WARM + 1, TRAIN_STEPS, 1e3 * dt / steps,
              steps * EVENTS_TRAIN_B / dt, peak / 2 ** 20, history[0, 0],
              history[-1, 0], *launches, card_line()), flush=True)
    if len(history) != TRAIN_STEPS or not np.isfinite(history).all():
        raise AssertionError("events training losses not all finite: {}"
                             .format(history[:, 0]))
    if min(launches) <= 0:
        raise AssertionError("an LSTM kernel of the events training path "
                             "never launched: {}".format(launches))

    # one batch's gradients on the card against the plain CPU twins
    cpu_layer = copy.deepcopy(layer).cpu()
    x, labels, weights = training.ChunkSampler(
        data, 4, EVENTS_TRAIN_T, EVENTS_TRAIN_T, 1,
        np.ones(1025, np.float32), seed=2).sample()
    grads = []
    for lyr, d in ((layer, dev), (cpu_layer, torch.device("cpu"))):
        lyr.zero_grad(set_to_none=True)
        loss, _ = training.make_loss_fn(lyr, min_prob=1e-30, drop=20)(
            torch.from_numpy(x).to(d),
            torch.from_numpy(labels.astype(np.int64)).to(d),
            torch.from_numpy(weights).to(d))
        loss.backward()
        grads.append([p.grad.cpu() for p in lyr.parameters()])
    errs = [rel_err(a, b)[1] for a, b in zip(*grads)]
    names = [n for n, _ in layer.named_parameters()]
    print("events training gradients (B=4, T={}), GPU kernels vs CPU plain "
          "twins: worst max|d|/max|g_cpu| {:.3e} ({})".format(
              EVENTS_TRAIN_T, max(errs), names[int(np.argmax(errs))]),
          flush=True)
    if not max(errs) <= GRAD_RTOL:
        raise AssertionError("GPU gradients differ from the CPU ones: {}"
                             .format(dict(zip(names, errs))))

    # where a steady step's device time goes
    prof = torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=3, warmup=1, active=5, repeat=1))
    with prof:
        training.train(layer, data, niteration=10,
                       log=StepMarks(sync=True, prof=prof), **kw)
        torch.cuda.synchronize()
    print("events training profile (5 steady steps): " +
          profile_table(prof.events(), 5), flush=True)
    return counts, peak


def phase_diagnostics(dev, counters):
    """The three probes through their entry points (``run_case``,
    ``run_variant``) at the JAX scripts' default shapes, launches counted;
    then each output against its twin.  Returns the three kernel entries
    and the launch counts."""
    from sloika_tpu_torch.scripts import bench_dma as dma
    from sloika_tpu_torch.scripts import bench_gru_unroll as gu
    from sloika_tpu_torch.scripts import bench_viterbi_parts as vp
    B, T = DIAG_VITERBI
    post, stay = vp.device_inputs(B, T, 1024, dev)
    RB, RT = DIAG_RING
    x = torch.rand((RT, RB, 1024), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    zero_counts(counters)
    torch.cuda.synchronize()
    gru = {(S, p, U): gu.run_case(U, S=S, precision=p, device=dev)
           for S in gu.WIDTHS for p in gu.PRECISIONS for U in gu.UNROLLS}
    parts = {v: vp.run_variant(v, B, T, device=dev, inputs=(post, stay))
             for v in vp.VARIANTS}
    ring = {c: dma.run_case(*c, RB, RT, device=dev, x=x) for c in dma.CASES}
    torch.cuda.synchronize()
    counts = read_counts(counters)
    launches = [counts[n] for n in PATH_KERNELS["diagnostics"]]
    if min(launches) <= 0:
        raise AssertionError("a probe's kernel never launched: {}".format(
            launches))
    card = card_line()

    # GRU: each (S, precision, U) against the twin, and against U = 1; then
    # a step split by the clocked build at U = 1 and 8
    twin_ms, err, gru_clocks = {}, {p: 0.0 for p in gu.PRECISIONS}, {}
    for S in gu.WIDTHS:
        xp, sWT, sW2T = (torch.from_numpy(a).to(dev)
                         for a in gu.case_inputs(1, S=S))
        twin = {}
        for p in gu.PRECISIONS:
            twin[p], twin_ms[(S, p)] = timed_once(
                lambda: gu.gru_unroll_plain(xp, sWT, sW2T, p))
        bf16_effect = float((twin["default"] - twin["highest"]).abs().mean())
        for p in gu.PRECISIONS:
            base = gru[(S, p, 1)][0]
            d = [(gru[(S, p, U)][0] - twin[p]).abs() for U in gu.UNROLLS]
            e = max(float(x.max()) for x in d)
            err[p] = max(err[p], e)
            mean = max(float(x.mean()) for x in d)
            same = [gu.parity(base, gru[(S, p, U)][0])
                    for U in gu.UNROLLS[1:]]
            for U in (1, 8):
                gru_clocks[(S, p, U)] = gu.step_clocks(U, S=S,
                                                       precision=p)
            print("gru_unroll prec={} T=400 B=100 S={}: {} us a step at U "
                  "= {}; parity of U = 2, 4, 8 with U = 1: {}; max_abs_err "
                  "{:.3e} (mean {:.3e}) against the twin ({:.3f} ms); "
                  "clocked build, cycles a step at U = 1: {:.0f} {}, at U = "
                  "8: {:.0f} [{}]".format(
                      p, S, ", ".join("{:.3f}".format(
                          1e3 * gru[(S, p, U)][1] / 400)
                          for U in gu.UNROLLS),
                      ", ".join(map(str, gu.UNROLLS)), same, e, mean,
                      twin_ms[(S, p)],
                      gru_clocks[(S, p, 1)]["cycles_per_step"],
                      {k: round(v) for k, v in
                       gru_clocks[(S, p, 1)]["phases_mean"].items()},
                      gru_clocks[(S, p, 8)]["cycles_per_step"], card),
                  flush=True)
            tol = GRU_TOL if p == "highest" else DIAG_BF16_TOL
            if not (e <= tol and all(x == "EXACT" for x in same)):
                raise AssertionError("gru_unroll ({}, S={}) differs from its "
                                     "twin by {} > {} or across U: {}".format(
                                         p, S, e, tol, same))
            if p == "default" and not mean <= DIAG_BF16_MEAN * bf16_effect:
                raise AssertionError("gru_unroll (default, S={}) is {} from "
                                     "its bf16 twin on average, against the "
                                     "rounding's {}".format(S, mean,
                                                            bf16_effect))
        del xp, twin

    # Viterbi parts: every variant bit for bit
    ms = {v: parts[v][1] for v in vp.VARIANTS}
    plain_ms = {}
    for v in vp.VARIANTS:
        (tb_p, vf_p), plain_ms[v] = timed_once(
            lambda: vp.viterbi_parts_plain(v, post, stay))
        tb, vf = parts[v][0]
        if not (torch.equal(tb, tb_p) and torch.equal(vf, vf_p)):
            raise AssertionError("viterbi_parts ({}) differs from its twin"
                                 .format(v))
    del parts, tb, tb_p
    step = lambda a, b: 1e3 * (ms[a] - ms[b]) / T
    print("viterbi_parts B={} T={} K=1024: bit_identical all 8; ms {}; us "
          "a step priced: stream + barrier + store (noop) {:.3f}, scores "
          "(nolog - noop) {:+.3f}, log (copy - nolog) {:+.3f}, int8 of the "
          "log (copy - f32store) {:+.3f}, stay select (maxstay - copy) "
          "{:+.3f}, group max (full - maxstay) {:+.3f}, the k mod K/4 "
          "broadcast (reduce - full) {:+.3f}; twins up to {:.0f} ms [{}]"
          .format(B, T, {v: round(ms[v], 4) for v in vp.VARIANTS},
                  1e3 * ms["noop"] / T, step("nolog", "noop"),
                  step("copy", "nolog"), step("copy", "f32store"),
                  step("maxstay", "copy"), step("full", "maxstay"),
                  step("reduce", "full"), max(plain_ms.values()), card),
          flush=True)

    # the copy ring: every case bit for bit (each case's rows divide RT, so
    # all fold the same rows), its bandwidth beside torch.amax
    ring_plain, ring_plain_ms = timed_once(lambda: dma.hbm_ring_plain(x, 1))
    amax_ms = cuda_ms(lambda: torch.amax(x, dim=0), 8)
    nbytes = x.numel() * 4
    clocks = {}
    for (rows, nslots), (out, r_ms) in ring.items():
        if not torch.equal(out, ring_plain):
            raise AssertionError("hbm_ring ({}, {}) differs from its twin"
                                 .format(rows, nslots))
        clocks[(rows, nslots)] = dma.chunk_clocks(x, rows, nslots, out)
    print("hbm_ring B={} T={} K=1024 ({:.2f} GB): bit_identical all 4; "
          "{}; torch.amax {:.3f} ms, {:.1f} GB/s; twin {:.1f} ms [{}]".format(
              RB, RT, nbytes / 1e9, "; ".join(
                  "rows {} slots {}: {:.3f} ms, {:.1f} GB/s ({:.1%} of "
                  "3.35 TB/s), {:.0f} cycles a chunk (clocked build)".format(
                      r, s, m, nbytes / m / 1e6,
                      nbytes / m * 1e3 / HBM_BYTES_PER_S,
                      clocks[(r, s)]["cycles_per_chunk"])
                  for (r, s), (_, m) in ring.items()),
              amax_ms, nbytes / amax_ms / 1e6, ring_plain_ms, card),
          flush=True)

    # gru_unroll: as gru_fwd, 6 S^2 flop a step of a row, xp read and h
    # written once.  viterbi_parts ("full"): the posterior and stays read,
    # the codes and final scores written once; ~10 operations a state a
    # step.  hbm_ring: its input read once.  Only the ring has a PyTorch
    # call that computes the same function (torch.amax)
    steps = 400 * 100
    gru_bound = {S: bound(4 * (4 * S * steps + 3 * S * S), 6 * S * S * steps)
                 for S in gu.WIDTHS}
    by_case = lambda d: {" ".join(map(str, k)): v for k, v in d.items()}
    return [
        with_bound({"name": "gru_unroll", "route": "cuda",
                    "source": "sloika_tpu_torch/csrc/gru_unroll.cu",
                    "replaces": "scripts/bench_gru_unroll.py:26",
                    "shape": "T=400 B=100 S=96 U=1 precision=highest",
                    "max_abs_err": err["highest"],
                    "max_abs_err_bf16": err["default"],
                    "ms": gru[(96, "highest", 1)][1],
                    "plain_ms": twin_ms[(96, "highest")],
                    "ms_by_case": by_case({k: v[1] for k, v in gru.items()}),
                    "cycles_per_step_by_case": by_case(
                        {k: v["cycles_per_step"]
                         for k, v in gru_clocks.items()}),
                    "cycles_per_step_by_phase_by_case": by_case(
                        {k: v["phases_mean"] for k, v in gru_clocks.items()}),
                    "bound_ms_by_width": {S: b[0]
                                          for S, b in gru_bound.items()}},
                   4 * (4 * 96 * steps + 3 * 96 * 96), 6 * 96 * 96 * steps),
        with_bound({"name": "viterbi_parts", "route": "cuda",
                    "source": "sloika_tpu_torch/csrc/viterbi_parts.cu",
                    "replaces": "scripts/bench_viterbi_parts.py:25",
                    "shape": "T={} B={} K=1024 variant=full".format(T, B),
                    "max_abs_err": 0.0, "ms": ms["full"],
                    "plain_ms": plain_ms["full"], "ms_by_variant": ms,
                    "plain_ms_by_variant": plain_ms},
                   T * B * (1024 * 5 + 4) + B * 1024 * 4, 10 * T * B * 1024),
        with_bound({"name": "hbm_ring", "route": "cuda",
                    "source": "sloika_tpu_torch/csrc/hbm_ring.cu",
                    "replaces": "scripts/bench_dma.py:28",
                    "shape": "T={} B={} K=1024 rows=32 slots=3".format(RT, RB),
                    "max_abs_err": 0.0, "ms": ring[(32, 3)][1],
                    "plain_ms": ring_plain_ms,
                    "ms_by_case": by_case({k: v[1] for k, v in ring.items()}),
                    "cycles_per_chunk_by_case": by_case(
                        {k: v["cycles_per_chunk"]
                         for k, v in clocks.items()})},
                   nbytes + RB * 1024 * 4, nbytes // 4, library_ms=amax_ms),
    ], counts


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a GPU")
    dev = torch.device("cuda")
    print("environment: {} | torch {} cuda {} | {} device(s)".format(
        card_line(), torch.__version__, torch.version.cuda,
        torch.cuda.device_count()), flush=True)

    from sloika_tpu_torch import config, cuda_build, models
    from sloika_tpu_torch.nn.fused_gru import (gru_backward, gru_forward,
                                               gru_wgrad)
    from sloika_tpu_torch.nn.fused_lstm import (lstm_backward, lstm_forward,
                                                lstm_wgrad)
    from sloika_tpu_torch.ops import remap_kernel, viterbi_kernel
    from sloika_tpu_torch.scripts import bench_dma, bench_gru_unroll
    from sloika_tpu_torch.scripts import bench_viterbi_parts
    config.disable_tf32()
    t0 = time.time()
    cuda_build.build_all(KERNELS + CLOCKED)
    ptxas = " | ".join(
        "{} ({:.1f} s): {}".format(n, sec, " ".join(
            l.split(":", 1)[-1].strip() for l in log.splitlines()
            if "registers" in l or "spill" in l))
        for n, (sec, log) in sorted(cuda_build.BUILD_LOG.items())
        if n in KERNELS)
    print("build: {} kernels and {} clocked builds in {:.1f} s ({})".format(
        len(KERNELS), len(CLOCKED), time.time() - t0, ptxas), flush=True)

    standin = models.pretrained_standin(seed=0).to(dev).eval()
    gru_fwd = phase_gru(dev, standin)
    viterbi = phase_viterbi(dev, standin)
    gru_fwd_train, bwd = phase_gru_bwd(dev)
    # the forward kernel is held to its twin at both paths' shapes
    gru_fwd["max_abs_err"] = max(gru_fwd["max_abs_err"],
                                 gru_fwd_train["max_abs_err"])
    gru_fwd["at_training_shapes"] = gru_fwd_train
    remap = phase_remap_kernels(dev)
    reads = event_reads()
    lstm = [phase_lstm(dev, max(len(r) for r in reads))] \
        + phase_lstm_bwd(dev)
    kernels = [gru_fwd] + viterbi + bwd + remap + lstm
    by_name = {k["name"]: k for k in kernels}
    # every count is set to 0 before each path and all are read after it
    counters = dict(zip(KERNELS, (
        gru_forward, gru_backward, gru_wgrad, viterbi_kernel.viterbi_forward,
        viterbi_kernel.viterbi_backtrace, remap_kernel.remap_banded,
        remap_kernel.remap_backtrack, lstm_forward, lstm_backward,
        lstm_wgrad, bench_gru_unroll.gru_unroll,
        bench_viterbi_parts.viterbi_parts, bench_dma.hbm_ring)))
    launches = {"basecall": phase_main(dev, standin, counters)}
    launches["basecall_raw"] = phase_basecall_raw(dev, standin, counters)
    launches["train"], _ = phase_train(dev, counters)
    launches["remap"] = phase_remap(dev, counters)
    launches["basecall_events"] = phase_basecall_events(dev, counters, reads)
    launches["train_events"], _ = phase_train_events(dev, counters)
    diag, launches["diagnostics"] = phase_diagnostics(dev, counters)
    by_name.update((k["name"], k) for k in diag)
    for path, counts in launches.items():
        for name, n in counts.items():
            entry = by_name[name]
            entry.setdefault("launches_by_path", {})[path] = n
            entry["launches"] = entry.get("launches", 0) + n
    kernels = [by_name[n] for n in KERNELS]

    print(json.dumps({"kernels": kernels}))
    print("card: {}".format(card_line()))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:          # report and fail: no result line
        import traceback
        traceback.print_exc()
        sys.stderr.write("chip_smoke FAILED: {!r}\n".format(e))
        sys.exit(1)
