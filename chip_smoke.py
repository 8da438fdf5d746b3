"""GPU smoke run of the PyTorch/CUDA port (``sloika_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one.
Phases, each printing one line and raising on failure:

1. environment: the card's name and power limit, the CUDA version;
2. build: the fifteen kernels, from ``sloika_tpu_torch/csrc``, the
   clocked builds the phases split steps with (CLOCKED) and the parents of
   the two kernels redesigned last (PARENTS), one nvcc each, all started
   together;
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
   then klen 8 (65,536 states, T = 1,000, B = 8), both general kernels
   bit-identical to their twins, and klen 7 at the whole-read batch (B =
   8), both general kernels timed against their plain twins on the card
   and bit-identical to them, the forward's plan (a cluster of C blocks a
   row) and its step split by the clocked build, with its design floor;
   the general backtrace (redesigned: a shared-memory ring) timed at klen
   7 and 8 beside its parent's design (a thread a row) in the order
   parent, change, change, parent, and split by its clocked build, with
   its chain floor;
4b. output head: ``ops/output_head``'s kernel (projection, softmax,
   ``min_prob`` floor, pad mask and cast, writing the posterior once)
   against its plain version on the card, with the stand-in's softmax,
   GRU-like inputs in (-1, 1) and ragged lengths, at the chunked cell's
   batch (T = 3,277, B = 1,024, 112 -> 1,025) and at a whole-read batch
   (T' = 23,389, B = 8): max abs difference <= 1e-4 and the pad frames'
   stays bit for bit; each timed beside its bound, the plain version on
   the card (the parent's chain: a cuBLAS product and the elementwise
   passes) and cuBLAS's product alone;
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
   of ~14,848 positions (a 68 GB traceback at this batch).  Then the wide
   route of ``remap_banded`` (windows past 16,384 positions), on purpose,
   the only path that may take it (``wide_launches``): (a) two reads of
   10,000 samples whose references, 13,000 kmers longer than their
   frames, bucket to 22,145 positions, remapped exactly at W = 22,272; the DP's inputs of that call
   through the plain twins on the CPU give bit-identical scores and paths;
   both kernels timed there, with the bound; the wide route (redesigned: a
   cluster of blocks a row) beside its parent's design (one block a row,
   scores in device memory) in the order parent, change, change, parent,
   the parent's bits equal, its step split by its clocked build (its
   first two blocks) and its design floor (a cluster barrier a step); (b) reads of 15,500 samples
   whose references run 18,900 kmers past their frames, so that the bands
   of 768, 3,072 and 12,288 all miss their ends, in a batch sized from
   ``torch.cuda.mem_get_info()`` (a ballast tensor holds all but 16 GiB of
   the card) so that its exact re-run needs 1.2 times the free memory: a
   real ``torch.OutOfMemoryError`` halves it (the
   Remapper's ``_oom_sizes``), and the reads are identical to those
   remapped in batches of half;
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
12b. bonito's CRF-LSTM (``bonito_crf``; ``phase_crf``): (a) ``lstm_fwd``'s
    wide route (two gate columns a lane, S 257-384) at the CRF cell's batch
    (T' = 2,000, B = 512, S = 384, no peepholes, ragged lengths), forward
    and reverse, against the plain twin on the card (<= 1e-4 on valid
    steps, the same bits twice), timed beside its bound and cuDNN's LSTM
    (``torch.nn.LSTM``, less its input product); (b) the CRF kernels
    (``crf_decode``: ``crf_beta_kernel``, ``crf_forward_kernel``) at
    N = 256 on the same batch of frames against their plain twin on the
    card (at most 1e-4 of the labels differing, scores within 1e-5
    relative, the same bits twice, one launch a call), timed beside their
    bound; (c) the basecall path: ``Basecaller`` over the 16 synthetic DAC
    reads with the model at its published widths under the CRF cell's
    weight scheme, windows of 10,000 samples, overlap 250, batches of 64:
    ``lstm_fwd`` five times and ``crf_decode`` once a batch and no other
    kernel, every read called, and the two shortest reads' calls against
    the CPU route's (identical, or agreement >= 0.999; scores within 1e-4
    relative); (d) the ``basecall raw`` CLI on the card given the model as
    the port's JSON, the reads from memory (``rank_reads``): every read in
    order, the calls identical to (c)'s or agreeing >= 0.999;
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
    (``bench_dma.py --clocks``, the same bits);
15. bf16, the reference's bfloat16 configuration
    (``SLOIKA_TPU_COMPUTE_DTYPE=bfloat16``), changing none of the phases
    before it: ``viterbi_fwd`` on a bfloat16 posterior at the chunk
    (T = 3,277, B = 64, pair route), production (B = 1,024, single
    route), events (T = 9,000, B = 64) and whole-read (B = 8) shapes, and
    on the general route at klen 7 and at nbase 3, klen 4 (T = 200, B = 2,
    then the whole-read shape): codes, final scores and decoded paths
    bit-identical to the float32 kernel fed the upcast, the first 64
    frames' codes of rows 0-7 to the plain twin, both dtypes timed in turns
    (f32, bf16, bf16, f32) beside their bounds at every shape but
    T = 200; the chunked DAC, whole-read raw and events paths
    run in float32 and under ``config.compute_dtype`` bfloat16 (every
    kernel of the path launched, no general route), with samples/s or
    events/s, peak device memory and the share of reads called the same,
    and a batch's posterior against float32's (max abs difference < 0.05,
    argmax agreement > 0.95: tests/test_bf16.py:40-45; the events model at
    sd 1.5, whose posterior is peaked, and at phase 12's 0.5, printed);
    a profile of the chunked path's bfloat16 call, where the floor, mask
    and cast show as elementwise kernels;
16. zoo, the models the port loads besides the main paths': (a) the
    stand-in pickled in the reference's layout (``write_reference_pickle``:
    ``sloika.layers.*`` classes, parameters in Theano shared-variable
    stubs, GRU ``iW`` (3S, I) block-wise, ``sloika.activation.*``
    globals), read by ``cli.basecall.load_model``, basecalls the 16 reads
    whole as 5b does: calls, scores and a batch's posterior bit-identical
    to the stand-in's; (b) ``bigger_raw_gru`` at its published widths
    (32/96/128, stride 2, seeded weights) basecalls the 16 reads whole, two
    20,000-sample reads' posterior within 1e-4 of the CPU forward, then 10
    training steps at B = 100 x 2,000 samples (losses finite) and one
    batch's gradients against the CPU twins' (<= 1e-3 relative), with
    samples/s and chunks/s; (c) a pickle of every other convertible type
    at small widths (``zoo_graph``: ten cells on the eager scan route, a
    relu GRU among them, a peephole LSTM on the kernel, the parameter-free
    layers, ``Reverse`` over a feed-forward layer) forward on the card
    within 1e-4 of the CPU at T = 500, B = 4 (``scan_route`` counts the
    ten cells); a Studentise events model through ``Basecaller(chunked=
    True, output="bases")``, which falls back to whole reads at batch 1 (one Viterbi
    launch a read) with the CPU route's calls; ``baseline_gru`` (size 64)
    basecalling 4 event reads; ``verify`` and ``dump_json`` through their
    ``main`` on the card.

17. call and score (see ``phase_call_and_score``);
18. chunkify events remap: the ``remap`` chunkify's device part
    (``chunkify_tools.remap_event_records``) on 16 seeded event tables of
    3,000-9,000 events in memory, with ``baseline_lstm`` at full width
    (sd 1.5: a peaked posterior) and references its posterior favours
    along each read: ``lstm_fwd``, ``remap_banded`` and ``remap_back``
    must launch, every read must chunk, and the two shortest reads'
    chunks, labels and bad flags must equal the CPU path's; events/s;
19. train fused: ``training.train`` of raw_0.98_rgrgr (B = 100 x 2,000)
    and of ``baseline_lstm`` (B = 100 x 500), 30 steps each at K = 1
    (streaming, eager) and at K = 10 (the chunk set resident, a CUDA
    graph replay a group): ms a steady step, chunks/s, replays, launches
    a step and peak memory side by side; the losses within 1e-4
    relative; and the parameters after one group of 10 against 10 eager
    steps under cuDNN's deterministic algorithms (bit-identical is
    reported; held to 1e-6 absolute, the JAX test's);
20. ranks (``sloika_tpu_torch.parallel``; ``phase_ranks``): two ranks
    sharing cuda:0 over gloo, started by ``parallel.spawn.run`` as a
    launcher would, run (a) ``training.train`` of raw_0.98_rgrgr at
    global B = 100 x 2,000, K = 1, 5 steps (the ranks' parameters
    bit-identical; losses within 1e-5 relative and parameters within 1e-4
    of one rank on the same global batches; each rank's ms a step), (c)
    ``basecall raw --devices 2`` through the CLI's ``main`` on the 16
    synthetic reads, whole, with the stand-in (the merged FASTA byte for
    byte the merge of single-rank runs of each rank's strided share; names
    in order and call agreement >= 0.999 through ``align.
    evaluate_basecalls`` against one rank over all 16) and (d) ``chunkify
    raw_remap --dac --devices 2`` on 8 of phase 9's reads (chunks, labels,
    bad flags and strand rows against the shares' single-rank runs
    merged, scores within 1e-4 relative); the CLIs list and load the reads
    from memory and write the chunks with numpy (the card's machine has no
    h5py); (b) one rank of an NCCL group trains K = 10 steps as one CUDA
    graph with each all-reduce captured, bit-identical to 10 eager steps.
    Phase 20's launches are the ranks' own counts, summed.

Every path (5-20, 12b) sets the kernels' launch counts to 0 before it runs and
reads them after, and fails if a Viterbi wrapper took its general route
(``general_launches``): the paths decode klen 5 over 4 bases; if a remap
wrapper ran at a window wider than 16,384 (``wide_launches``) but in
phase 9's wide checks; and if a recurrence took the eager scan route (``nn.rnn.scan_route``), but for the
zoo pickle's ten cells.

Then one JSON line of per-kernel numbers (``viterbi_fwd``'s with the
bfloat16 phase's under "bf16"; with the least time the card
could take for each kernel's work, ``bound_ms``, from the shapes run: the
larger of its bytes at 3.35 TB/s and its float32 operations at
67 TFLOP/s), the card line again, and last ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX and no h5py.
"""
import contextlib
import copy
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
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
           "gru_unroll", "viterbi_parts", "hbm_ring", "output_head",
           "crf_decode")
#: the clocked builds the phases split steps with, compiled beside the
#: kernels (``scripts.clocked_library``)
CLOCKED = tuple((n, n.upper() + "_CLOCKS") for n in (
    "viterbi_fwd", "viterbi_back", "remap_banded", "remap_back",
    "lstm_wgrad", "gru_unroll", "hbm_ring"))
#: sources of a kernel's other routes, built and reported beside KERNELS
ROUTES = ("lstm_fwd_wide",)
#: the parents of the two kernels redesigned last, built beside them and
#: timed beside them in phases 4, 9a and 17c (``scripts.redesign_parents``:
#: no path loads them)
PARENTS = ("redesign_parents",)
#: the kernels each main path must launch (a basecall path's)
CALL = ("gru_fwd", "viterbi_fwd", "viterbi_back", "output_head")
PATH_KERNELS = {"basecall": CALL,
                "basecall_raw": CALL,
                "train": ("gru_fwd", "gru_bwd", "gru_wgrad"),
                "remap": ("gru_fwd", "remap_banded", "remap_back"),
                "basecall_events": ("lstm_fwd", "viterbi_fwd",
                                    "viterbi_back", "output_head"),
                "train_events": ("lstm_fwd", "lstm_bwd", "lstm_wgrad"),
                "diagnostics": ("gru_unroll", "viterbi_parts", "hbm_ring"),
                "call_chunked_states": CALL,
                "call_nbase5": CALL,
                "call_nontransducer": ("gru_fwd", "output_head"),
                "chunkify_events": ("lstm_fwd", "remap_banded",
                                    "remap_back"),
                "train_fused": ("gru_fwd", "gru_bwd", "gru_wgrad"),
                "train_fused_events": ("lstm_fwd", "lstm_bwd",
                                       "lstm_wgrad"),
                "ranks_train": ("gru_fwd", "gru_bwd", "gru_wgrad"),
                "ranks_graph": ("gru_fwd", "gru_bwd", "gru_wgrad"),
                "ranks_basecall": CALL,
                "ranks_chunkify": ("gru_fwd", "remap_banded", "remap_back"),
                "basecall_crf": ("lstm_fwd", "crf_decode")}
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
# phase 9's wide checks: (a) WIDE_READS reads of WIDE_SAMPLES samples (2,000
# frames) whose references, WIDE_EXCESS kmers longer than their frames,
# bucket to 22,145 positions, remapped exactly at W = 22,272; (b) reads of OOM_SAMPLES samples (3,100 frames,
# 3,328 with the bucket's stay frames and whole blocks) with references
# OOM_EXCESS kmers longer than their frames (22,000 positions, in the
# 22,145 bucket): a window that moves a position a frame at most reaches
# at most W positions past the frames, so the bands of 768, 3,072 and
# 12,288 all miss the ends (by more than a half band) and the re-run is
# exact; in a batch sized from the free memory so that its exact re-run
# needs OOM_OVERSIZE times it, with a ballast tensor holding all but
# OOM_FREE_BYTES of the card (the exhaustion is the card's all the same;
# at the whole card the batch is 628 reads and takes ~50 s)
WIDE_READS, WIDE_SAMPLES, WIDE_EXCESS, WIDE_W = 2, 10000, 13000, 22272
OOM_SAMPLES, OOM_EXCESS, OOM_OVERSIZE = 15500, 18900, 1.2
OOM_FREE_BYTES = 16 * 2 ** 30
# chunkify events remap: reads, their event counts, the reads checked
# against the CPU path, the stand-in's weight sd (a peaked posterior, see
# BF16_EVENTS_SD) and the chunks' events
CHUNK_EV_READS, CHUNK_EV_CPU, CHUNK_EV_SD, CHUNK_EV_LEN = 16, 2, 1.5, 500
# train fused: optimiser steps a group; the eager check's tolerance where
# an op picks another algorithm under capture (tests/test_training.py's)
FUSED_K, FUSED_ATOL, FUSED_LOSS_RTOL = 10, 1e-6, 1e-4
# ranks (phase 20): ranks sharing the card; training steps, the losses'
# tolerance against one rank (tests/test_multihost.py:70) and the
# parameters' (max abs difference over max abs value, per parameter: where
# a weight's gradient is near round-off, ADAMski's step g / sqrt(v) moves
# by a share of the learning rate when the ranks sum in another order; the
# softmax weights read 3.3e-5 on the H100, the rest below 4e-7); the
# basecall CLI's call agreement with one rank over all reads; phase 9's
# reads the chunkify CLI remaps, and its scores' tolerance against the
# shares' single-rank runs (tests/test_multihost.py:236-239); seconds the
# ranks may take
RANKS, RANKS_STEPS = 2, 5
RANKS_TRAIN_RTOL, RANKS_PARAM_RTOL = 1e-5, 1e-4
RANKS_CALL_AGREEMENT = 0.999
RANKS_REMAP_READS, RANKS_SCORE_RTOL = 8, 1e-4
RANKS_TIMEOUT = 300
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
# klen 8 (65,536 states) through the general route at T frames
KLEN8_T = 1000
EVENTS_TRAIN_B, EVENTS_TRAIN_T = 100, 500
# the diagnostic probes at the JAX scripts' defaults: Viterbi parts (B, T),
# the copy ring (B, T); gru_unroll "default" against its bf16 twin: max abs,
# and mean abs as a share of the rounding's own (tests/test_torch_diag_kernels)
DIAG_VITERBI, DIAG_RING = (128, 3277), (128, 3264)
DIAG_BF16_TOL, DIAG_BF16_MEAN = 2e-3, 0.2
# the bfloat16 phase: frames of the Viterbi codes held to the plain twin
# (rows 0-7); the posterior against float32 (tests/test_bf16.py:40-45): max
# abs difference below, argmax agreement above
BF16_TWIN_T = 64
BF16_POST_TOL, BF16_ARGMAX = 0.05, 0.95
# the events model's weight sd in that check: at phase 12's 0.5 its
# posterior is near-uniform over 1,025 states, so bf16 moves it by ~4e-6
# and yet moves the argmax of ~9% of frames, each a tie that the bf16
# rounding makes (the JAX package's own bf16 stream does the same:
# tests/test_torch_bf16_events.py); at 1.5 it is peaked, as a trained
# model's is (the stand-in remaps at 1.5 for the same reason, phase 9).
# Both are printed; the check holds at 1.5
BF16_EVENTS_SD = 1.5
# the zoo (phase 16): the zoo pickle's input (T, B), its tolerance against
# the CPU, and its cells on the scan route (zoo_graph); the events of each
# read the Studentise model basecalls; bigger_raw_gru's training steps, the
# first BIG_TRAIN_WARM of them left out of the rate
ZOO_T, ZOO_B, ZOO_TOL, ZOO_SCAN_CELLS = 500, 4, 1e-4, 10
STUDENTISE_EVENTS = 1000
BIG_TRAIN_STEPS, BIG_TRAIN_WARM = 10, 2
# call and score (phase 17): CALL_READS reads of CALL_BASES bases simulated
# from one genome; the chunked "states" route's windows and batch; its CPU
# twin on the first CALL_TWIN_READS reads, the least agreement (mean
# accuracy of the card's calls aligned to the twin's) held; the 5-letter
# transducer's batch of whole reads (its CPU twin on two reads cut to
# RAW_SHORT samples); the non-transducer's reads (shorter: the host decoder
# takes ~0.5 ms a frame); the stand-in's FLOPs a sample
CALL_READS, CALL_BASES, CALL_GENOME = 16, 6000, 200000
CALL_CHUNK, CALL_OVERLAP, CALL_BATCH = 8192, 400, 64
CALL_TWIN_READS, CALL_AGREEMENT = 4, 0.99
NBASE5_BATCH = 8
NONTRANS_READS, NONTRANS_BASES = 4, 1000
STANDIN_FLOPS = 157382.4
# bonito's CRF-LSTM (phase 12b): the CRF cell's window batch (T' frames of
# B windows, LSTM width S, N CRF states), its traffic's windows and overlap
# (samples), the basecall path's batch (several batches a call), the weight
# sd and head gain and bias of its traffic; the share of the CRF kernels'
# labels that may differ from the twin's on the card (the cell's own limit,
# base_error 2e-3, over twenty times), their scores' relative tolerance; the
# reads of the path's CPU twin, and the least call agreement (align) of the
# card's path against the twin and of the CLI against the path
CRF_T, CRF_B, CRF_S, CRF_N = 2000, 512, 384, 256
CRF_CHUNK, CRF_OVERLAP, CRF_BATCH = 10000, 250, 64
CRF_SD, CRF_GAIN, CRF_BIAS = 4.0, 2.0, -1.3
CRF_LABEL_TOL, CRF_SCORE_RTOL = 1e-4, 1e-5
CRF_TWIN_READS, CRF_AGREEMENT = 2, 0.999
# the output head's timed shapes (name, T, B): the chunked cell's batch of
# 1,024 windows and the whole-read cell's longest batch of 8 reads
HEAD_SHAPES = (("chunked batch", T_FRAMES, 1024), ("whole-read batch", 23389,
                                                   8))
HEAD_MIN_PROB = 1e-5
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
    """Set every wrapper's launch count, the Viterbi wrappers' count of
    general-route launches, the remap wrappers' count of wide-window
    launches and the recurrences' scan-route calls to 0."""
    from sloika_tpu_torch.nn.rnn import scan_route
    for k in counters.values():
        k.launches = 0
        for extra in ("general_launches", "wide_launches"):
            if hasattr(k, extra):
                setattr(k, extra, 0)
    scan_route.calls = 0


def read_counts(counters, scan_calls=0, general=False, wide=False,
                lstm_wide=0):
    """The launches of each kernel since :func:`zero_counts`; raises if a
    Viterbi wrapper launched its general route (``general_launches``)
    unless ``general``: the main paths decode klen 5 over 4 bases, the
    tuned kernels' range, and only phase 17's 5-letter transducer takes the
    general route; and unless the recurrences took the eager scan route
    (``nn.rnn.scan_route``) ``scan_calls`` times: 0 on every main path,
    whose GRUs and LSTMs are the kernels' tanh/sigmoid cells; if a remap
    wrapper ran at a window wider than the tuned route's
    (``wide_launches``) unless ``wide``: only phase 9's wide checks do;
    and unless the LSTM forward took its wide route (S above 256)
    ``lstm_wide`` times: only phase 12b's CRF-LSTM does."""
    from sloika_tpu_torch.nn.rnn import scan_route
    gen = {n: k.general_launches for n, k in counters.items()
           if getattr(k, "general_launches", 0)}
    if gen and not general:
        raise AssertionError("a main path took the general Viterbi route: "
                             "general_launches {}".format(gen))
    wide_n = {n: k.wide_launches for n, k in counters.items()
              if getattr(k, "wide_launches", 0) and n != "lstm_fwd"}
    if wide_n and not wide:
        raise AssertionError("a main path took the wide remap route: "
                             "wide_launches {}".format(wide_n))
    if counters["lstm_fwd"].wide_launches != lstm_wide:
        raise AssertionError("the LSTM forward's wide route ran {} times, {} "
                             "expected".format(
                                 counters["lstm_fwd"].wide_launches,
                                 lstm_wide))
    if scan_route.calls != scan_calls:
        raise AssertionError("the scan route ran {} times, {} expected"
                             .format(scan_route.calls, scan_calls))
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


def against_parent(change, parent, reps=3):
    """Milliseconds of a redesigned kernel's call ``change`` and of its
    parent's design ``parent`` on the same inputs, in one process in the
    order parent, change, change, parent (each the best of 2 rounds of
    ``reps`` calls by CUDA events): (change's two, parent's two)."""
    p1 = cuda_ms(parent, reps, 2)
    c1 = cuda_ms(change, reps, 2)
    c2 = cuda_ms(change, reps, 2)
    p2 = cuda_ms(parent, reps, 2)
    return [c1, c2], [p1, p2]


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


def phase_output_head(dev, standin):
    """The output head's kernel against its plain version at HEAD_SHAPES
    (see the module docstring, 4b); the entry of the first shape, the
    other's under "whole_read"."""
    from sloika_tpu_torch.ops import output_head as oh
    softmax = standin.layers[-1]
    W, b = softmax.W.detach(), softmax.b.detach()
    I, K = softmax.insize, softmax.size
    rs = np.random.RandomState(22)
    entries = []
    for name, T, B in HEAD_SHAPES:
        lengths = rs.randint(T // 2, T + 1, size=B)
        lengths[0] = T
        ln = torch.from_numpy(lengths).to(dev)
        # a GRU's outputs lie in (-1, 1)
        x = torch.from_numpy(rs.uniform(-1, 1, size=(T, B, I)).astype(
            np.float32)).to(dev)

        def kernel():
            return oh.output_head(x, W, b, ln, HEAD_MIN_PROB, torch.float32)

        def plain():
            return oh.output_head_plain(x, W, b, ln, HEAD_MIN_PROB,
                                        torch.float32)

        with torch.inference_mode():
            got, ref = kernel(), plain()
            mask = torch.arange(T, device=dev)[:, None] < ln[None, :]
            err, same_stays = 0.0, True
            for t0 in range(0, T, 256):
                g, r = got[t0:t0 + 256], ref[t0:t0 + 256]
                m = mask[t0:t0 + 256]
                err = max(err, float((g - r).abs().max()))
                same_stays &= torch.equal(g[~m], r[~m])
            del got, ref
            ms = cuda_ms(kernel, 3, 2)
            plain_ms = cuda_ms(plain, 2, 1)
            library_ms = cuda_ms(lambda: torch.addmm(b, x.reshape(-1, I),
                                                     W.t()), 3, 2)
        del x
        torch.cuda.empty_cache()
        entry = with_bound({"shape": "T={} B={} I={} K={}".format(
            T, B, I, K), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}, 4 * T * B * (I + K), 2 * T * B * I * K,
            library_ms)
        entries.append(entry)
        print("output head at the {} ({}): kernel {:.3f} ms, {:.1f}% of its "
              "bound {:.3f} ms ({}); plain version (the parent's chain) "
              "{:.3f} ms; cuBLAS product alone {:.3f} ms; max_abs_err "
              "{:.3e} (<= {}), stays {} [{}]".format(
                  name, entry["shape"], ms, 100 * entry["bound_ms"] / ms,
                  entry["bound_ms"], entry["bound_by"], plain_ms, library_ms,
                  err, POST_TOL, "bit-identical" if same_stays else "DIFFER",
                  card_line()), flush=True)
        if not (err <= POST_TOL and same_stays):
            raise AssertionError("the output head departs from its plain "
                                 "version at T={} B={}: {} {}".format(
                                     T, B, err, same_stays))
    return dict(entries[0], name="output_head", whole_read=entries[1])


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
    klen 8 (65,536 states) at KLEN8_T, RAW_BATCH, the forward bit-identical
    to its twin, its plan printed; then klen 7 at the whole-read raw path's
    batch (RAW_BATCH reads of ``whole_T`` frames), both kernels timed
    against their plain twins on the card, bit-identical to them, the
    forward's plan (a cluster of C blocks a row) and its step split by the
    clocked build (``bench_viterbi.fwd_clocks``), with its design floor.

    :returns: (viterbi_fwd's, viterbi_back's) general-route entries
    """
    from sloika_tpu_torch.ops import decode, viterbi_kernel as vk
    from sloika_tpu_torch.scripts import redesign_parents
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
    # klen 8 (65,536 states) at KLEN8_T, RAW_BATCH: the forward against its
    # twin on the card
    from sloika_tpu_torch.scripts import bench_viterbi
    K8 = 4 ** 8
    post = bench_viterbi.posterior(KLEN8_T, RAW_BATCH, dev, seed=88,
                                   nstate=K8 + 1)
    plan8 = bench_viterbi.general_plan(RAW_BATCH, K8, dev)
    before = vk.viterbi_forward.general_launches
    (v, tb), ms8 = timed_once(lambda: vk.viterbi_forward(post, 8, 5.0))
    launched8 = vk.viterbi_forward.general_launches - before
    (v_ref, tb_ref), plain8 = timed_once(
        lambda: decode.viterbi_forward_plain(post, 8, skip_pen=5.0))
    same8 = torch.equal(v, v_ref) and torch.equal(tb, tb_ref)
    # the general backtrace at klen 8 (a 65,552-byte frame a slot): its
    # twin's bits, then timed beside its parent's design
    last8 = torch.argmax(v, dim=1)
    before = vk.viterbi_backtrace.general_launches
    got8 = vk.viterbi_backtrace(tb, last8)
    launched8b = vk.viterbi_backtrace.general_launches - before
    ref8 = decode.viterbi_backtrace_plain(tb, last8)
    same8b = all(map(torch.equal, got8, ref8))
    back8, back8_parent = against_parent(
        lambda: vk.viterbi_backtrace(tb, last8),
        lambda: redesign_parents.viterbi_back_general_parent(tb, last8, 4))
    del post, v, tb, v_ref, tb_ref
    torch.cuda.empty_cache()
    print("viterbi general route klen 8 (K = 65,536) T={} B={}: plan C={} "
          "threads={} nslots={} shared={}; bit_identical to the twin on the "
          "card {}; forward kernel {:.3f} ms ({:.3f} us a step, the first "
          "call) plain {:.1f} ms; launches {}; backtrace bit_identical {} "
          "(general launches {}), {:.3f} / {:.3f} ms, the parent's design "
          "{:.3f} / {:.3f} ms (parent, change, change, parent)".format(
              KLEN8_T, RAW_BATCH, plan8["C"], plan8["threads"],
              plan8["nslots"], plan8["shared"], same8, ms8,
              1e3 * ms8 / KLEN8_T, plain8, launched8, same8b, launched8b,
              *back8, *back8_parent), flush=True)
    if not (same8 and launched8 == 1 and same8b and launched8b == 1):
        raise AssertionError("the general Viterbi route differs from its "
                             "twins at klen 8")
    checks["klen 8 nbase 4"] = {"bit_identical_to_twin": same8,
                                "shape": "T={} B={}".format(KLEN8_T,
                                                            RAW_BATCH),
                                "plan": plan8, "ms_first_call": ms8,
                                "back_bit_identical_to_twin": same8b,
                                "back_ms": back8,
                                "back_parent_ms": back8_parent}
    # klen 7 at the whole-read batch: the kernels against the twins on the
    # card, the forward's plan and its step split by the clocked build
    T, B, K = whole_T, RAW_BATCH, 4 ** 7
    post = bench_viterbi.posterior(T, B, dev, seed=77, nstate=K + 1)
    plan = bench_viterbi.general_plan(B, K, dev)
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
    # the general backtrace beside its parent's design (a thread a row),
    # then split by its clocked build
    back_runs, back_parent = against_parent(
        lambda: vk.viterbi_backtrace(tb, last),
        lambda: redesign_parents.viterbi_back_general_parent(tb, last, 4))
    back_ms = min(back_runs)
    split = bench_viterbi.fwd_clocks(post, (v, tb), klen=7)
    bsplit = bench_viterbi.back_clocks(tb, last, (path, moved))
    back_floors = bench_viterbi.back_design_bounds(T, B, K, bsplit)
    del post, tb
    torch.cuda.empty_cache()
    back_plan = vk.viterbi_back_general_plan(B, K, T, 4)
    print("viterbi general backtrace klen 7 (K = 16,384) T={} B={} "
          "(redesigned: frames streamed through a shared-memory ring, plan "
          "F={} nslots={} frame_bytes={}): {:.3f} / {:.3f} ms ({:.1f} / "
          "{:.1f} ns a frame), the parent's design (a thread a row) {:.3f} / "
          "{:.3f} ms, in the order parent, change, change, parent; walker "
          "{:.1f} cycles a frame {} at {:.2f} GHz, copier {}, "
          "{:.1f} cycles a shared-memory read: chain floor {:.3f} ms, the "
          "traceback's bytes {:.3f} ms [{}]".format(
              T, B, back_plan["F"], back_plan["nslots"],
              back_plan["frame_bytes"], *back_runs,
              *(1e6 * x / T for x in back_runs), *back_parent,
              bsplit["cycles_per_step"],
              {k: round(x, 1) for k, x in bsplit["walker"].items()},
              bsplit["ghz"],
              {k: round(x, 1) for k, x in bsplit["copier"].items()},
              bsplit["smem_chase_cycles"], back_floors["chain_floor_ms"],
              back_floors["design_bytes_ms"], card_line()), flush=True)
    clusters = vk.viterbi_forward.general_clusters(K, 4, dev)
    print("viterbi general route klen 7 (K = 16,384) T={} B={}: plan C={} "
          "threads={} nslots={} (the card runs {} clusters of C blocks at "
          "once); bit_identical to the twins on the card {}; "
          "forward kernel {:.3f} ms ({:.3f} us a step) plain {:.1f} ms; "
          "backtrace kernel {:.3f} ms plain {:.1f} ms; launches {}; the "
          "forward's step by phase (cycles, clocked build at {:.2f} GHz, "
          "{:.3f} ms): {:.0f} {}; a cluster barrier {:.0f} cycles, a remote "
          "load {:.0f}, a store's hop with its release arrival {:.0f}: "
          "design floor {:.3f} ms [{}]"
          .format(T, B, plan["C"], plan["threads"], plan["nslots"],
                  clusters, same_fwd and same_back, ms, 1e3 * ms / T,
                  plain_ms,
                  back_ms, back_plain_ms, launched, split["ghz"],
                  split["ms"], split["cycles_per_step"],
                  {k: round(x) for k, x in split["phases_mean"].items()},
                  split["cluster_barrier_cycles"],
                  split["remote_load_cycles"], split["push_hop_cycles"],
                  split["design_floor_ms"], card_line()), flush=True)
    if not (same_fwd and same_back and launched == [1, 1]):
        raise AssertionError("the general Viterbi route differs from its "
                             "twins at T={} B={}".format(T, B))
    shape = "T={} B={} K={} (klen 7)".format(T, B, K)
    fwd = with_bound({"shape": shape, "max_abs_err": err_fwd, "ms": ms,
                      "plain_ms": plain_ms, "checks": checks, "plan": plan,
                      "cards_clusters": clusters,
                      "cycles_per_step": split["cycles_per_step"],
                      "cycles_per_step_by_phase": split["phases_mean"],
                      "design_floor_ms": split["design_floor_ms"],
                      "barrier_floor_ms": split["barrier_floor_ms"],
                      "floor_cycles": {
                          k: split[k] for k in (
                              "cluster_barrier_cycles",
                              "remote_load_cycles", "push_hop_cycles",
                              "ghz")}},
                     *viterbi_fwd_bound(T, B, K))
    back = with_bound({"shape": shape, "max_abs_err": err_back,
                       "ms": back_ms, "plain_ms": back_plain_ms,
                       "redesigned": "frames streamed through a "
                       "shared-memory ring (tensor-map boxes at klen 7, 1-D "
                       "bulk copies otherwise), a walker and a copier warp "
                       "a row",
                       "ms_runs": back_runs, "parent_ms": back_parent,
                       "plan": back_plan,
                       "cycles_per_frame": bsplit["cycles_per_step"],
                       "cycles_per_frame_by_phase": {
                           "walker": bsplit["walker"],
                           "copier": bsplit["copier"]},
                       "smem_chase_cycles": bsplit["smem_chase_cycles"],
                       **back_floors},
                      *viterbi_back_bound(T, B))
    return fwd, back


def viterbi_fwd_bound(T, B, K=1024, esize=4):
    """viterbi_fwd's bytes and operations at (T, B), on a posterior of
    ``esize``-byte elements (4: float32, 2: bfloat16)."""
    return (T * B * (K + 1) * esize + T * B * K + B * K * 4,
            42 * T * B * K)


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
    gradients_against_cpu(layer, data, 5, dev, "training gradients (B=4, "
                          "T={})".format(TRAIN_T))
    return counts, peak


def gradients_against_cpu(layer, data, stride, dev, what):
    """One batch's gradients (B = 4 chunks of TRAIN_SAMPLES) on the card
    against the plain CPU twins': max|gpu - cpu| / max|cpu| <= GRAD_RTOL for
    every parameter."""
    from sloika_tpu_torch import training
    cpu_layer = copy.deepcopy(layer).cpu()
    x, labels, weights = training.ChunkSampler(
        data, 4, TRAIN_SAMPLES, TRAIN_SAMPLES, stride,
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
    print("{}, GPU kernels vs CPU plain twins: worst max|d|/max|g_cpu| "
          "{:.3e} ({})".format(what, max(errs),
                               names[int(np.argmax(errs))]), flush=True)
    if not max(errs) <= GRAD_RTOL:
        raise AssertionError("GPU gradients differ from the CPU ones: {}"
                             .format(dict(zip(names, errs))))


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
                           batch_size=BATCH, chunked=True, output="bases",
                           device=dev)
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
          "launches gru_fwd {} viterbi_fwd {} viterbi_back {} output_head "
          "{} [{}]".format(
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
                               overlap=OVERLAP, chunked=True,
                               output="bases", device="cpu") \
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
          "MiB, launches gru_fwd {} viterbi_fwd {} viterbi_back {} "
          "output_head {} [{}]"
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
    print("whole-read raw basecall profile (one call, profiled; batches of "
          "{} reads at T = {} frames): ".format(
              RAW_BATCH, raw_batch_frames(standin, sigs)) +
          profiled_call(lambda: caller.basecall_signals(sigs)), flush=True)
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
    return counts, out


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


def profiled_call(fn):
    """``profile_table`` of one call of ``fn`` under the profiler."""
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    return profile_table(prof.events(), 1, wall)


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


def diagonal_references(layer, reads, dev, overlong=(), samples_per_base=9,
                        excess=REMAP_OVERLONG_EXCESS):
    """A reference of about L/9 bases for each DAC read: the kmers the
    model's posterior favours along the read's diagonal, kmer j at frame
    j * nframes / npos, each extending the one before by the best of the
    four bases.  (With random weights the posterior is nearly flat; a
    random reference would leave every banded path off its anchors.)  The
    reads indexed in ``overlong`` get ``excess`` more kmers than frames
    instead: a band that moves a position a frame at most cannot reach
    their ends."""
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
            nkmer[i] = int(nframes[i]) + excess
        refs = favoured_references(post, nframes, nkmer)
        del post, x
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
    print("remap profile (one call, profiled): " + profiled_call(
        lambda: remapper.remap_dac_signals(reads, refs)), flush=True)

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


def phase_remap_wide(dev, counters, card_clocks):
    """Phase 9's wide checks (a) and (b); returns the wide route's entries
    for ``remap_banded`` and ``remap_back``.  ``card_clocks``: the cycles
    of a cluster barrier and the clock they were read at
    (``cluster_barrier_cycles``, ``ghz``), as phase 4's clocked general
    forward measures them (its entry's ``general_route["floor_cycles"]``),
    for the wide route's design floor."""
    if not {"cluster_barrier_cycles", "ghz"} <= set(card_clocks):
        raise ValueError("phase_remap_wide needs phase 4's cluster barrier "
                         "cycles and clock, got {}".format(card_clocks))
    from sloika_tpu_torch import models
    from sloika_tpu_torch import remap as tremap
    from sloika_tpu_torch.ops import remap_kernel as rk
    from sloika_tpu_torch.scripts import bench_remap, redesign_parents
    standin = models.pretrained_standin(sd=REMAP_SD, seed=0).to(dev).eval()

    # (a) two reads remapped exactly at W = 22,272: the wide route, its DP
    # inputs recorded and run through the plain twins on the CPU
    reads = [(d[:WIDE_SAMPLES], n4)
             for d, n4 in synthetic_reads(n=WIDE_READS, seed=21)]
    refs = diagonal_references(standin, reads, dev,
                               overlong=range(WIDE_READS), excess=WIDE_EXCESS)
    remapper = tremap.Remapper(standin, 5, batch_size=WIDE_READS, band=None,
                               device=dev)
    recorded = []
    real = rk.map_to_sequence_banded

    def record(*args):
        out = real(*args)
        recorded.append((args, out))
        return out
    tremap.remap_kernel.map_to_sequence_banded = record
    try:
        zero_counts(counters)
        out, ms_call = timed_once(
            lambda: remapper.remap_dac_signals(reads, refs))
        counts = read_counts(counters, wide=True)
    finally:
        tremap.remap_kernel.map_to_sequence_banded = real
    wide = (rk.remap_banded.wide_launches, rk.remap_backtrack.wide_launches)
    args, (score, path) = recorded[0]
    W = args[-1]
    if dict(remapper.windows) != {WIDE_W: 1} or wide != (1, 1):
        raise AssertionError("the exact remap did not take the wide route "
                             "once at W = {}: windows {}, wide_launches {}"
                             .format(WIDE_W, dict(remapper.windows), wide))
    cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
    (score_p, path_p), plain_ms = timed_once(
        lambda: rk.map_to_sequence_banded(*cpu_args))
    same = (torch.equal(score.cpu(), score_p) and
            torch.equal(path.cpu(), path_p))
    rel = float(((score.cpu() - score_p).abs() / score_p.abs()).max())
    ltrans_t, seq, slip, p0, p1, mask, nframes, npos, _ = args
    T, B = ltrans_t.shape[:2]
    P = seq.shape[1]
    TB = rk.block_len(W)
    Tp = -(-T // TB) * TB
    starts = rk.band_starts_blocked(nframes, npos, Tp, W, TB)
    kargs = (ltrans_t, seq, mask, p0, starts, slip, W)
    # the redesigned wide route beside its parent's design (one block of
    # 1,024 threads a row, the scores in device memory), parent, change,
    # change, parent; the parent gives the same bits
    runs, parent = against_parent(
        lambda: rk.remap_banded(*kargs),
        lambda: redesign_parents.remap_banded_wide_parent(*kargs), reps=2)
    ms = min(runs)
    tb, vfinal = rk.remap_banded(*kargs)
    same_parent = all(map(torch.equal, (tb, vfinal),
                          redesign_parents.remap_banded_wide_parent(*kargs)))
    plan = rk.remap_banded_plan(W, ltrans_t.shape[2])
    split = bench_remap.banded_clocks(kargs, (tb, vfinal))
    # the design floor: a cluster barrier a step (its cycles measured by
    # phase 4's clocked general forward, at the clock it ran at)
    floor_ms = Tp * card_clocks["cluster_barrier_cycles"] / (
        card_clocks["ghz"] * 1e6)
    last = rk.finish_banded(tb, vfinal, starts, p1, rk.remap_backtrack)[1][-1]
    back_ms = cuda_ms(lambda: rk.remap_backtrack(tb, starts, last), 3)
    back_plan = rk.remap_back_plan(W)
    shape = "T={} Tp={} B={} W={} P={}".format(T, Tp, B, W, P)
    print("remap wide route (a) redesigned (a cluster of {} blocks a row "
          "of {} positions, {} warps x {} positions, ring {} x {}): {:.3f} / "
          "{:.3f} ms ({:.2f} / {:.2f} us a step), the parent's design (one "
          "block a row, scores in device memory) {:.3f} / {:.3f} ms ({:.2f} "
          "/ {:.2f} us a step), parent, change, change, parent; the same "
          "bits {}; the step by phase (cycles, clocked build at {:.2f} GHz, "
          "{:.3f} ms): block 0 {:.0f} {}, block 1 {:.0f} {}; design floor "
          "(a cluster barrier of {:.0f} cycles a step) {:.3f} ms [{}]".format(
              plan["cluster"], plan["blocks"], plan["warps"], plan["ppt"],
              plan["rows"],
              plan["nslots"], *runs, *(1e3 * x / Tp for x in runs),
              *parent, *(1e3 * x / Tp for x in parent), same_parent,
              split["ghz"], split["ms"], split["cycles_per_step"],
              {k: round(x) for k, x in split["phases_mean"].items()},
              split["block1"]["cycles_per_step"],
              {k: round(x) for k, x in
               split["block1"]["phases_mean"].items()},
              card_clocks["cluster_barrier_cycles"], floor_ms, card_line()),
          flush=True)
    if not same_parent:
        raise AssertionError("the wide route's parent gave other bits")
    print("remap wide route (a): {} reads of {:,} samples, references {} "
          "kmers, exact at W={} ({}): paths and scores bit-identical to the "
          "plain CPU twins {} (score max rel err {:.1e}); remap_banded "
          "{:.3f} ms ({:.2f} us a step, bound {:.3f} ms by {}), remap_back "
          "{:.3f} ms (copy {}); twins on the CPU {:.0f} ms; the call {:.0f} "
          "ms; wide_launches {}; launches {} [{}]".format(
              WIDE_READS, WIDE_SAMPLES, [len(r) - 4 for r in refs], W, shape,
              same, rel, ms, 1e3 * ms / Tp,
              *bound(remap_bytes(T, Tp, B, W, P), 13 * Tp * B * W), back_ms,
              back_plan["copy"], plain_ms, ms_call, wide,
              {n: c for n, c in counts.items() if c}, card_line()),
          flush=True)
    if not (same and rel <= REMAP_SCORE_RTOL):
        raise AssertionError("the wide route differs from the plain twins")
    entries = [
        with_bound({"shape": shape, "ms": ms, "us_per_step": 1e3 * ms / Tp,
                    "plain_ms": plain_ms, "max_abs_err": 0.0 if same else
                    float((path.cpu() - path_p).abs().max()),
                    "launches": wide[0],
                    "redesigned": "a cluster of blocks a row, each "
                    "holding its share of the window in registers and "
                    "shared memory",
                    "ms_runs": runs, "parent_ms": parent,
                    "parent_us_per_step": [1e3 * x / Tp for x in parent],
                    "plan": plan, "design_floor_ms": floor_ms,
                    "cycles_per_step": split["cycles_per_step"],
                    "cycles_per_step_by_phase": {
                        "block0": split["phases_mean"],
                        "block1": split["block1"]["phases_mean"]}},
                   remap_bytes(T, Tp, B, W, P), 13 * Tp * B * W),
        with_bound({"shape": shape, "ms": back_ms, "copy": back_plan["copy"],
                    "max_abs_err": 0.0 if same else
                    float((path.cpu() - path_p).abs().max()),
                    "launches": wide[1]},
                   Tp * B * (2 + 4 + 4) + B * 4, 3 * Tp * B)]
    del recorded, args, kargs, tb, vfinal, ltrans_t
    torch.cuda.empty_cache()

    # (b) a batch whose exact re-run exhausts the card: halved on a real
    # torch.OutOfMemoryError; the same reads in batches that fit
    frames = tremap.bucket_length(OOM_SAMPLES) // 5
    per_read = -(-frames // 256) * 256 * WIDE_W * 2 + frames * 1025 * 4
    free, total = torch.cuda.mem_get_info()
    ballast = torch.empty(max(0, free - OOM_FREE_BYTES), dtype=torch.uint8,
                          device=dev)
    free, total = torch.cuda.mem_get_info()
    half = int(np.ceil(OOM_OVERSIZE * free / per_read / 2))
    # each read cut or repeated to OOM_SAMPLES samples
    reads = [(np.resize(d, OOM_SAMPLES), n4)
             for d, n4 in synthetic_reads(n=2 * half, seed=31)]
    refs = diagonal_references(standin, reads, dev,
                               overlong=range(len(reads)), excess=OOM_EXCESS)
    big = tremap.Remapper(standin, 5, batch_size=2 * half, device=dev)
    torch.cuda.empty_cache()
    zero_counts(counters)
    out, ms_big = timed_once(lambda: big.remap_dac_signals(reads, refs))
    read_counts(counters, wide=True)
    fits = tremap.Remapper(standin, 5, batch_size=half, device=dev)
    ref, ms_fit = timed_once(lambda: fits.remap_dac_signals(reads, refs))
    identical = all(
        np.array_equal(a[2], b[2]) and a[0] == b[0] for a, b in zip(out, ref))
    print("remap wide route (b): {} reads of {:,} samples, references {}-{} "
          "kmers, {:.1f} GB free of {:.1f} GB (a ballast holds the rest), "
          "~{:.2f} GB a read at the "
          "exact window; reads re-run by band {}; DP batches by window {}; "
          "oom_sizes {}; in {:.1f} s, and in batches of {} that fit in "
          "{:.1f} s (windows {}): reads identical {}".format(
              len(reads), OOM_SAMPLES, min(map(len, refs)) - 4,
              max(map(len, refs)) - 4, free / 1e9, total / 1e9,
              per_read / 1e9, dict(big.reruns), dict(big.windows),
              sorted(big._oom_sizes), ms_big / 1e3, half, ms_fit / 1e3,
              dict(fits.windows), identical), flush=True)
    if (not big._oom_sizes or big.windows.get(WIDE_W, 0) < 2
            or big.reruns.get(None, 0) != len(reads)):
        raise AssertionError("no out-of-memory halving at the exact window: "
                             "{} {}".format(big._oom_sizes,
                                            dict(big.windows)))
    if not identical:
        raise AssertionError("reads remapped after the halving differ from "
                             "those remapped in batches that fit")
    entries[0]["oom_halving"] = {"reads": len(reads),
                                 "oom_sizes": sorted(map(list,
                                                         big._oom_sizes)),
                                 "windows": dict(big.windows)}
    del big, fits, out, ref, ballast
    torch.cuda.empty_cache()
    return entries


def event_tables(n, seed):
    """``n`` seeded event tables (mean, stdv, start, length) of
    EVENTS_MIN-EVENTS_MAX events, as ``data.fast5.read_section_events``
    gives them."""
    rs = np.random.RandomState(seed)
    tables = []
    for L in rs.randint(EVENTS_MIN, EVENTS_MAX + 1, size=n):
        ev = np.zeros(L, dtype=[("mean", "f8"), ("stdv", "f8"),
                                ("start", "f8"), ("length", "f8")])
        ev["mean"] = 90 + 12 * rs.normal(size=L)
        ev["stdv"] = rs.uniform(0.5, 3.0, size=L)
        ev["length"] = rs.geometric(0.1, size=L) / 4000.0
        ev["start"] = np.cumsum(ev["length"])
        tables.append(ev)
    return tables


def favoured_references(post, nframes, nkmer):
    """A reference a read: kmer j the state the posterior ``post`` (T, B,
    1025) favours at frame j * nframes / nkmer, each kmer extending the one
    before by the best of the four bases (see diagonal_references)."""
    dev = post.device
    B = post.shape[1]
    rows = torch.arange(B, device=dev)
    nk = torch.as_tensor(nkmer, device=dev)
    j = torch.arange(int(nk.max()), device=dev)
    frame = torch.minimum(j[None, :] * nframes[:, None] // nk[:, None],
                          nframes[:, None] - 1)
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
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    refs = []
    for b, n in enumerate(np.asarray(nkmer)):
        first = (kmers[b, 0] >> (2 * np.arange(4, -1, -1))) & 3
        refs.append(alphabet[np.concatenate([first, kmers[b, 1:n] & 3])]
                    .tobytes())
    return refs


def phase_chunkify_events(dev, counters):
    """The ``remap`` chunkify's device part (``chunkify_tools.
    remap_event_records``) on event tables in memory."""
    import argparse
    from sloika_tpu_torch import models
    from sloika_tpu_torch import remap as tremap
    from sloika_tpu_torch.data import chunkify_tools
    from sloika_tpu_torch.data.features import from_events
    layer = seeded_weights(models.network_factory("baseline_lstm")(
        klen=5, sd=0.5, size=LSTM_S), seed=41, sd=CHUNK_EV_SD).to(dev).eval()
    tables = event_tables(CHUNK_EV_READS, seed=43)
    names = ["read_{:02d}".format(i) for i in range(len(tables))]
    x, lengths = padded_batch([from_events(ev, tag="") for ev in tables])
    with torch.inference_mode():
        post, nframes = layer.apply_with_lengths(x.to(dev), lengths.to(dev))
        refs = favoured_references(post, nframes, lengths.numpy() // 2)
        del post
    args = argparse.Namespace(chunk_len=CHUNK_EV_LEN, kmer_len=5,
                              use_scaled=False, normalisation="per-read",
                              alphabet=b"ACGT")
    remapper = tremap.Remapper(layer, 5, batch_size=CHUNK_EV_READS,
                               device=dev)
    with contextlib.redirect_stdout(io.StringIO()):      # warm-up
        chunkify_tools.remap_event_records(remapper, names, tables, refs,
                                           args)
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        records = chunkify_tools.remap_event_records(remapper, names, tables,
                                                     refs, args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(counters)
    launches = [counts[n] for n in PATH_KERNELS["chunkify_events"]]
    nev = sum(len(ev) for ev in tables)
    # the shortest reads through the CPU path: the same chunks and labels
    short = list(np.argsort([len(ev) for ev in tables])[:CHUNK_EV_CPU])
    cpu = tremap.Remapper(copy.deepcopy(layer).cpu(), 5, band=remapper.band,
                          batch_size=CHUNK_EV_CPU, device="cpu")
    sub = lambda xs: [xs[i] for i in short]
    with contextlib.redirect_stdout(io.StringIO()):
        got = chunkify_tools.remap_event_records(
            remapper, sub(names), sub(tables), sub(refs), args)
        want = chunkify_tools.remap_event_records(
            cpu, sub(names), sub(tables), sub(refs), args)
    same = len(got) == len(want) == CHUNK_EV_CPU and all(
        np.array_equal(g[k], w[k]) for g, w in zip(got, want)
        for k in ("chunks", "labels", "bad"))
    print("chunkify events remap: {} reads, {} events, references {}-{} "
          "kmers, baseline_lstm (size {}, sd {}), band {}: {} reads "
          "chunked into {} chunks of {} events in {:.3f} s, {:.0f} events/s; "
          "launches lstm_fwd {} remap_banded {} remap_back {}; {} reads' "
          "chunks and labels equal to the CPU path's {} [{}]".format(
              len(tables), nev, min(map(len, refs)) - 4,
              max(map(len, refs)) - 4, LSTM_S, CHUNK_EV_SD, remapper.band,
              len(records), sum(len(r["chunks"]) for r in records),
              CHUNK_EV_LEN, dt, nev / dt, *launches, CHUNK_EV_CPU, same,
              card_line()), flush=True)
    if len(records) != len(tables) or min(launches) <= 0:
        raise AssertionError("the chunkify events remap path did not chunk "
                             "every read through its kernels: {} records, "
                             "launches {}".format(len(records), launches))
    if not same:
        raise AssertionError("chunks on the card differ from the CPU path's")
    return counts


def fused_run(counters, layer, data, K, steps, dev, **kw):
    """``training.train`` of ``steps`` steps at K a group, timed by a sync
    at each group's progress mark: (history, stats, counts, ms a steady
    step, chunks/s, peak bytes, launches a step), the first group left out
    of the steady state (its graph's warm-up and capture)."""
    from sloika_tpu_torch import training
    from sloika_tpu_torch.profile_train import StepMarks
    clock = StepMarks(sync=True)
    stats = {}
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, history = training.train(layer, data, niteration=steps, log=clock,
                                steps_per_dispatch=K, stats=stats,
                                device=dev, **kw)
    counts = read_counts(counters)
    warm = max(K, TRAIN_WARM)
    first = warm // K - 1
    dt = clock.marks[-1] - clock.marks[first]
    n = steps - warm
    if stats["captured"]:
        per_step = sum(c for (_, kind), c in stats["captured"].items()
                       if kind == "launches") / K
    else:
        per_step = sum(counts.values()) / steps
    return (history, stats, counts, 1e3 * dt / n, n * kw["batch_size"] / dt,
            torch.cuda.max_memory_allocated(), per_step)


def phase_train_fused(dev, counters):
    """raw_0.98_rgrgr at K = 1 (streaming) and K = FUSED_K (resident), then
    baseline_lstm at both; the parameters after one group held to the eager
    steps'."""
    from sloika_tpu_torch import models, training
    from sloika_tpu_torch.profile_train import (synthetic_chunks,
                                                synthetic_event_chunks)
    cases = (("raw", "raw_0.98_rgrgr", synthetic_chunks(), TRAIN_B,
              TRAIN_SAMPLES, "train_fused"),
             ("events", "baseline_lstm", synthetic_event_chunks(),
              EVENTS_TRAIN_B, EVENTS_TRAIN_T, "train_fused_events"))
    launches = {}
    for name, model, data, B, T, path in cases:
        def fresh():
            layer = models.network_factory(model)(klen=5, sd=0.5, seed=0)
            return (seeded_weights(layer, seed=25, sd=0.5)
                    if name == "events" else layer).to(dev)
        kw = dict(batch_size=B, chunk_len_range=(1.0, 1.0), drop=20, seed=1)
        eager = fused_run(counters, fresh(), data, 1, TRAIN_STEPS, dev,
                          data_on_device=False, **kw)
        fused = fused_run(counters, fresh(), data, FUSED_K, TRAIN_STEPS, dev,
                          data_on_device=True, **kw)
        launches[path] = fused[2]
        rel = float(np.max(np.abs(fused[0][:, 0] - eager[0][:, 0])
                           / np.abs(eager[0][:, 0])))
        # one group against FUSED_K eager steps, cuDNN's deterministic
        # algorithms for the check (its convolution weight gradient may
        # sum with atomics)
        torch.backends.cudnn.deterministic = True
        try:
            layers = [fresh(), fresh()]
            for layer, K in zip(layers, (FUSED_K, 1)):
                training.train(layer, data, niteration=FUSED_K,
                               steps_per_dispatch=K, data_on_device=K > 1,
                               log=training.Logger(None, True), device=dev,
                               **kw)
            torch.cuda.synchronize()
            diffs = {n: float((a - b).detach().abs().max()) for (n, a), b in zip(
                layers[0].named_parameters(), layers[1].parameters())}
        finally:
            torch.backends.cudnn.deterministic = False
        bits = all(d == 0.0 for d in diffs.values())
        worst = max(diffs, key=diffs.get)
        print("train fused {}: {} at B={} x {} {}, {} steps, resident: K=1 "
              "{:.3f} ms a step, {:.1f} chunks/s, {:.1f} launches a step, "
              "peak {:.1f} MiB; K={} {:.3f} ms a step, {:.1f} chunks/s, "
              "{} graph replays, {:.1f} launches a step (captured), peak "
              "{:.1f} MiB; losses over {} steps max rel diff {:.2e}; "
              "parameters after one group bit-identical to {} eager steps "
              "{} (worst {} {:.2e}) [{}]".format(
                  name, model, B, T, "samples" if name == "raw" else "events",
                  TRAIN_STEPS, eager[3], eager[4], eager[6], eager[5] / 2 ** 20,
                  FUSED_K, fused[3], fused[4], fused[1]["replays"], fused[6],
                  fused[5] / 2 ** 20, TRAIN_STEPS, rel, FUSED_K, bits, worst,
                  diffs[worst], card_line()), flush=True)
        if fused[1]["replays"] != TRAIN_STEPS // FUSED_K or not (
                fused[1]["resident"]):
            raise AssertionError("the fused run did not replay its graph "
                                 "each group: {}".format(fused[1]))
        if not (np.isfinite(fused[0]).all() and rel <= FUSED_LOSS_RTOL):
            raise AssertionError("fused losses differ from the eager ones "
                                 "by {} relative".format(rel))
        if not all(d <= FUSED_ATOL for d in diffs.values()):
            raise AssertionError("parameters after one group differ from "
                                 "the eager steps': {}".format(diffs))
        if min(fused[2][k] for k in PATH_KERNELS[path]) <= 0:
            raise AssertionError("a kernel of {} never launched".format(path))
    return launches


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
          "viterbi_fwd {} viterbi_back {} output_head {} [{}]".format(
              LSTM_S, len(reads), nev, nbases, dt, nev / dt, nbases / dt,
              peak / 2 ** 20, *launches, card_line()), flush=True)
    if min(launches) <= 0:
        raise AssertionError("a kernel of the events basecall path never "
                             "launched: {}".format(launches))
    for i, (score, call) in enumerate(out):
        if len(call) == 0 or not np.isfinite(score):
            raise AssertionError("event read {}: bad call (score {}, {} "
                                 "states)".format(i, score, len(call)))

    print("events basecall profile (one call, profiled): " + profiled_call(
        lambda: caller.basecall_signals(reads)), flush=True)

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


def crf_bound(frames, N):
    """crf_decode: the scores (5N float32 a valid row-frame) read once and
    the labels (a byte a frame) written once; no operation count bounds
    it (a few exp and log a transition)."""
    return frames * (4 * 5 * N + 1), 0


def cudnn_lstm_ms(T, B, S, dev):
    """cuDNN's LSTM (``torch.nn.LSTM`` of S to S, float32, TF32 off) at
    (T, B), and cuBLAS's input product of that layer alone: (layer ms,
    product ms)."""
    torch.manual_seed(3)
    lstm = torch.nn.LSTM(S, S).to(dev)
    x = torch.randn((T, B, S), device=dev)
    W, b = lstm.weight_ih_l0, lstm.bias_ih_l0
    with torch.inference_mode():
        layer = cuda_ms(lambda: lstm(x), 3, 2)
        product = cuda_ms(lambda: torch.addmm(b, x.view(-1, S), W.t()), 3, 2)
    return layer, product


def crf_network(seed=23):
    """``bonito_crf`` at its published widths under the CRF cell's weight
    scheme: weights at sd ``CRF_SD`` of the layers' own scale, biases 0,
    the head's weights times ``CRF_GAIN`` and its biases ``CRF_BIAS``
    (about half a base a frame)."""
    from sloika_tpu_torch import models
    layer = models.network_factory("bonito_crf")(sd=CRF_SD, seed=seed)
    head = layer.layers[-1]
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if name.rsplit(".", 1)[-1] == "b":
                p.zero_()
        head.W.mul_(CRF_GAIN)
        head.b.fill_(CRF_BIAS)
    return layer


def bases_text(codes):
    return "".join("ACGT"[c] for c in codes)


def phase_crf(dev, counters):
    """12b: bonito's CRF-LSTM.  ``lstm_fwd``'s wide route (a cluster of 16
    blocks, ``lstm_fwd_wide.cu``) and the CRF kernels against their plain
    twins on the card at the CRF cell's batch on ragged rows, each timed
    beside its bound (and the LSTM beside cuDNN's recurrence); the basecall
    path at the published widths
    (``lstm_fwd`` five times and ``crf_decode`` once a batch) against its
    CPU twin; and the ``basecall raw`` CLI given the model as the port's
    JSON.  Returns (lstm_fwd's entry at this width, crf_decode's entry, the
    path's launches)."""
    from sloika_tpu_torch import align, serialize
    from sloika_tpu_torch import basecall as bc
    from sloika_tpu_torch.cli import basecall as bcli
    from sloika_tpu_torch.nn.fused_lstm import (lstm_forward, lstm_fwd_plan,
                                                lstm_scan_plain)
    from sloika_tpu_torch.ops import crf_decode as cd
    T, B, S, N = CRF_T, CRF_B, CRF_S, CRF_N
    gen = torch.Generator(device=dev).manual_seed(29)
    rs = np.random.RandomState(29)
    lengths = rs.randint(T // 3, T + 1, size=B)
    lengths[0], lengths[1] = T, 1
    frames = torch.from_numpy(lengths).to(dev)
    mask = torch.arange(T, device=dev)[:, None] < frames[None, :]
    m = mask[:, :, None]
    steps = int(lengths.sum())

    # (a) lstm_fwd at S = 384, no peepholes, both directions
    xp = torch.randn((T, B, 4 * S), generator=gen, device=dev)
    sWT = torch.randn((S, 4 * S), generator=gen, device=dev) / np.sqrt(2 * S)
    p = torch.zeros((3, S), device=dev)
    plan = lstm_fwd_plan(B, S, clusters=lstm_forward.wide_clusters(dev))
    worst, lstm_entry = 0.0, None
    for reverse in (False, True):
        wide0 = lstm_forward.wide_launches
        h, none = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                               emit_cout=False)
        again, _ = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                                emit_cout=False)
        if lstm_forward.wide_launches != wide0 + 2:
            raise AssertionError("S {} did not take the LSTM forward's wide "
                                 "route".format(S))
        (href, _), plain_ms = timed_once(
            lambda: lstm_scan_plain(xp, sWT, p, mask, reverse))
        d = float(((h - href).abs() * m).max())
        same = bool(torch.equal(h, again))
        del href, again
        ms = cuda_ms(lambda: lstm_forward(xp, sWT, p, mask=mask,
                                          reverse=reverse, emit_cout=False),
                     3, 2)
        worst = max(worst, d)
        print("crf lstm S={} reverse={} T={} B={} (plan {}): max_abs_err "
              "{:.3e}, same bits twice {}, {:.3f} ms ({:.3f} us a step); "
              "plain {:.3f} ms".format(S, reverse, T, B, plan, d, same, ms,
                                       1e3 * ms / T, plain_ms), flush=True)
        if not (d <= GRU_TOL and same and none is None):
            raise AssertionError("the LSTM forward's wide route differs from "
                                 "its twin by {} (same bits twice {})"
                                 .format(d, same))
        if not reverse:
            lstm_entry = {"shape": "T={} B={} S={}".format(T, B, S),
                          "plan": plan, "ms": ms, "plain_ms": plain_ms}
    del xp, h
    layer_ms, product_ms = cudnn_lstm_ms(T, B, S, dev)
    with_bound(lstm_entry, *lstm_bound(steps, S, 0),
               library_ms=layer_ms - product_ms)
    lstm_entry.update({"max_abs_err": worst, "library": "torch.nn.LSTM "
                       "(cuDNN) {:.3f} ms less its input product {:.3f} ms"
                       .format(layer_ms, product_ms)})
    print("crf lstm: cuDNN's LSTM layer {:.3f} ms, its input product "
          "{:.3f} ms; bound {:.3f} ms ({})".format(
              layer_ms, product_ms, lstm_entry["bound_ms"],
              lstm_entry["bound_by"]), flush=True)

    # (b) the CRF kernels at N = 256, rows ragged (all, one, ~T/3.. frames)
    scores = torch.tanh(torch.randn((T, B, 5 * N), generator=gen,
                                    device=dev)) * 5
    scores.view(T, B, N, 5)[..., 0] = 2.0
    before = cd.crf_decode.launches
    score, labels = cd.crf_decode(scores, frames)
    again = cd.crf_decode(scores, frames)
    one_call = cd.crf_decode.launches - before == 2
    (want_score, want_labels), plain_ms = timed_once(
        lambda: cd.crf_decode_plain(scores, frames))
    differ = int((labels != want_labels).sum())
    share = differ / steps
    rel = float(((score - want_score).abs()
                 / want_score.abs().clamp(min=1.0)).max())
    same = bool(torch.equal(again[0], score) and torch.equal(again[1], labels))
    ms = cuda_ms(lambda: cd.crf_decode(scores, frames), 3, 2)
    crf_entry = with_bound(
        {"name": "crf_decode", "route": "cuda",
         "source": "sloika_tpu_torch/csrc/crf_decode.cu", "replaces": None,
         "shape": "T={} B={} N={}".format(T, B, N), "ms": ms,
         "plain_ms": plain_ms, "max_abs_err": rel,
         "labels_differing": differ}, *crf_bound(steps, N))
    print("crf decode T={} B={} N={}: labels differing from the twin {} of "
          "{} ({:.2e}), score max rel err {:.3e}, same bits twice {}, one "
          "launch a call {}; {:.3f} ms, bound {:.3f} ms ({}); plain {:.3f} "
          "ms".format(T, B, N, differ, steps, share, rel, same, one_call, ms,
                      crf_entry["bound_ms"], crf_entry["bound_by"],
                      plain_ms), flush=True)
    if not (share <= CRF_LABEL_TOL and rel <= CRF_SCORE_RTOL and same
            and one_call):
        raise AssertionError("the CRF kernels depart from their twin")
    del scores, want_labels, labels, again

    # (c) the basecall path at the published widths
    reads = synthetic_reads()
    layer = crf_network()
    cpu_layer = copy.deepcopy(layer)
    caller = bc.Basecaller(layer, None, batch_size=CRF_BATCH,
                           chunk_size=CRF_CHUNK, overlap=CRF_OVERLAP,
                           device=dev)
    caller.basecall_dac_reads(reads)                 # warm-up
    nwin = len(bc._window_jobs([len(d) for d, _ in reads], CRF_CHUNK,
                               CRF_OVERLAP))
    nbatch = -(-nwin // CRF_BATCH)
    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = caller.basecall_dac_reads(reads)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(counters, lstm_wide=5 * nbatch)
    peak = torch.cuda.max_memory_allocated()
    others = {k: n for k, n in counts.items()
              if n and k not in PATH_KERNELS["basecall_crf"]}
    nsamples = sum(len(d) for d, _ in reads)
    nbases = sum(len(c) for _, c in out)
    print("crf basecall path: bonito_crf (S {}), {} reads {} windows in {} "
          "batches, {} samples -> {} bases in {:.3f} s: {:.1f} samples/s, "
          "peak memory {:.1f} MiB, launches lstm_fwd {} crf_decode {} "
          "(others {}) [{}]".format(
              S, len(reads), nwin, nbatch, nsamples, nbases, dt,
              nsamples / dt, peak / 2 ** 20, counts["lstm_fwd"],
              counts["crf_decode"], others, card_line()), flush=True)
    if (counts["lstm_fwd"] != 5 * nbatch or counts["crf_decode"] != nbatch
            or others):
        raise AssertionError("the CRF path launched {}, {} batches expected"
                             .format(counts, nbatch))
    for i, (score, codes) in enumerate(out):
        if len(codes) == 0 or not np.isfinite(score) or codes.max() > 3:
            raise AssertionError("read {}: bad call (score {}, {} bases)"
                                 .format(i, score, len(codes)))
    twin_reads = sorted(range(len(reads)), key=lambda r: len(reads[r][0]))
    twin_reads = twin_reads[:CRF_TWIN_READS]
    twin = bc.Basecaller(cpu_layer, None, batch_size=CRF_BATCH,
                         chunk_size=CRF_CHUNK, overlap=CRF_OVERLAP,
                         device="cpu").basecall_dac_reads(
        [reads[r] for r in twin_reads])
    got = [out[r] for r in twin_reads]
    same, rel, _ = same_calls(got, twin, "crf basecall path (reads {})"
                              .format(twin_reads))
    rows = [row for g, w in zip(got, twin)
            for row in align.evaluate_basecalls({"r": bases_text(g[1])},
                                                {"r": bases_text(w[1])})]
    agree = (float(np.mean([r["accuracy"] for r in rows]))
             if len(rows) == len(got) else 0.0)
    print("crf basecall path against its CPU twin: agreement {:.5f} (held "
          ">= {} unless identical)".format(agree, CRF_AGREEMENT), flush=True)
    if not (rel <= POST_TOL and (same or agree >= CRF_AGREEMENT)):
        raise AssertionError("the CRF path departs from its CPU twin")

    # (d) the basecall CLI, the model as the port's JSON, reads from memory
    names = read_names(len(reads))
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "bonito_crf.json")
        serialize.save_model_json(model, cpu_layer)
        calls = os.path.join(tmp, "calls.fa")
        t0 = time.perf_counter()
        with rank_reads(names, dacs=dict(zip(names, reads))):
            code = bcli.main(["raw", model, tmp, "--output", calls,
                              "--chunk_size", str(CRF_CHUNK), "--overlap",
                              str(CRF_OVERLAP), "--batch", str(CRF_BATCH)])
        cli_s = time.perf_counter() - t0
        records = fasta_records(calls) if code == 0 else []
    seqs = {n: t.splitlines()[1] for n, t in records}
    path = {n: bases_text(c) for n, (_, c) in zip(names, out)}
    rows = [row for n in names if n in seqs
            for row in align.evaluate_basecalls({n: seqs[n]}, {n: path[n]})]
    agree = (float(np.mean([r["accuracy"] for r in rows]))
             if len(rows) == len(names) else 0.0)
    print("crf basecall raw CLI (model JSON, {} reads, on the card): exit "
          "{}, {:.1f} s, names in order {}, calls identical to the path's "
          "{}, agreement {:.5f} (held >= {} unless identical)".format(
              len(names), code, cli_s, [n for n, _ in records] == names,
              seqs == path, agree, CRF_AGREEMENT), flush=True)
    if not (code == 0 and [n for n, _ in records] == names
            and (seqs == path or agree >= CRF_AGREEMENT)):
        raise AssertionError("the basecall CLI departs from the CRF path")
    return lstm_entry, crf_entry, counts


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

def phase_bf16(dev, standin, counters, event_feats):
    """The reference's bfloat16 configuration (``SLOIKA_TPU_COMPUTE_DTYPE=
    bfloat16``): ``viterbi_fwd`` on bfloat16 posteriors on every route, then
    the three basecall paths under ``config.compute_dtype`` bfloat16.

    :returns: viterbi_fwd's bfloat16 entry (its times beside the float32
        ones at each shape, and the paths' numbers)
    """
    whole_T = max(raw_batch_frames(standin, [d for d, _ in
                                             synthetic_reads()]))
    shapes = bf16_viterbi_shapes(dev, whole_T)
    general = bf16_viterbi_general(dev, whole_T)
    paths = bf16_basecall_paths(dev, standin, counters, event_feats)
    return {"at_shapes": shapes, "general_route": general,
            "basecall_paths": paths}


def bf16_against_f32(post16, klen, nbase=4):
    """``viterbi_fwd`` on a bfloat16 posterior and on its float32 upcast:
    whether codes, final scores and decoded paths are the same bits, and
    whether the first BF16_TWIN_T frames' codes of rows 0-7 equal the plain
    twin's on those rows (the DP is causal: a frame's codes depend on no
    later frame)."""
    from sloika_tpu_torch.ops import decode, viterbi_kernel as vk
    up = post16.float()
    v16, tb16 = vk.viterbi_forward(post16, klen, 5.0, nbase)
    v32, tb32 = vk.viterbi_forward(up, klen, 5.0, nbase)
    same = torch.equal(v16, v32) and torch.equal(tb16, tb32)
    paths = [vk.viterbi_backtrace(tb, torch.argmax(v, dim=1), nbase)
             for v, tb in ((v16, tb16), (v32, tb32))]
    same_path = all(map(torch.equal, *paths))
    del v32, tb32, paths
    Ts, n = min(BF16_TWIN_T, post16.shape[0]), min(RAW_BATCH,
                                                   post16.shape[1])
    _, tb_ref = decode.viterbi_forward_plain(
        post16[:Ts, :n].contiguous(), klen, skip_pen=5.0, nbase=nbase)
    same_twin = torch.equal(tb16[:Ts, :n], tb_ref)
    return up, same, same_path, same_twin


def f32_bf16_ms(post16, up, klen, nbase=4):
    """(float32 ms, bfloat16 ms) of ``viterbi_fwd`` on the upcast and on
    the bfloat16 posterior, timed in turns f32, bf16, bf16, f32; each the
    mean of its two."""
    from sloika_tpu_torch.ops import viterbi_kernel as vk
    runs = [cuda_ms(lambda: vk.viterbi_forward(p, klen, 5.0, nbase), 3)
            for p in (up, post16, post16, up)]
    return (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2


def bf16_viterbi_shapes(dev, whole_T):
    """The tuned routes at the decode paths' shapes (K = 1,024), on a
    bfloat16 posterior drawn on the card: bit-identical to the float32
    kernel on its upcast (codes, final scores, paths), rows 0-7's first
    codes to the twin; both dtypes timed, each beside its bound."""
    from sloika_tpu_torch.ops import viterbi_kernel as vk
    from sloika_tpu_torch.scripts import bench_viterbi
    out = {}
    for name, T, B in ((("chunk", T_FRAMES, BATCH),) + VITERBI_EXTRA_SHAPES
                       + (("whole read", whole_T, RAW_BATCH),)):
        post16 = bench_viterbi.posterior(T, B, dev, seed=T + B).to(
            torch.bfloat16)
        route = vk.viterbi_fwd_plan(
            B, 1024, *vk._device_limits(dev), esize=2,
            pairs=vk.viterbi_forward.pairs(1024, dev))["route"]
        up, same, same_path, same_twin = bf16_against_f32(post16, 5)
        ms32, ms16 = f32_bf16_ms(post16, up, 5)
        del post16, up
        torch.cuda.empty_cache()
        b32 = bound(*viterbi_fwd_bound(T, B))
        b16 = bound(*viterbi_fwd_bound(T, B, esize=2))
        print("viterbi_fwd bf16 {} T={} B={} ({} route): bit_identical to "
              "the f32 kernel on the upcast {} (paths {}), rows 0-{} codes "
              "of {} frames equal to the twin {}; f32 {:.3f} ms (bound "
              "{:.3f} ms, {}), bf16 {:.3f} ms (bound {:.3f} ms, {}), "
              "bf16/f32 {:.3f} [{}]".format(
                  name, T, B, route, same, same_path, min(B, RAW_BATCH) - 1,
                  min(T, BF16_TWIN_T), same_twin, ms32, *b32, ms16, *b16,
                  ms16 / ms32, card_line()), flush=True)
        if not (same and same_path and same_twin):
            raise AssertionError("viterbi_fwd on a bf16 posterior differs "
                                 "at {} (T={} B={})".format(name, T, B))
        out[name] = {"shape": "T={} B={} K=1024".format(T, B),
                     "route": route, "ms_f32": ms32, "ms_bf16": ms16,
                     "bound_ms_f32": b32[0], "bound_ms_bf16": b16[0],
                     "bound_by": b16[1]}
    return out


def bf16_viterbi_general(dev, whole_T):
    """The general route on bfloat16 posteriors, klen 7 and nbase 3 at klen
    4: at KLEN7_T, KLEN7_B the float32 kernel's bits on the upcast and the
    twin's codes; at the whole-read raw path's batch (RAW_BATCH reads of
    ``whole_T`` frames, the shape a klen-7 model decodes at) the float32
    kernel's bits on the upcast and both dtypes timed in turns, each beside
    its bound and its plan.  Each check takes the general route twice
    (``general_launches`` up by two)."""
    from sloika_tpu_torch.ops import viterbi_kernel as vk
    from sloika_tpu_torch.scripts import bench_viterbi
    optin = vk._device_limits(dev)[1]
    out = {}
    for klen, nbase in ((7, 4), (4, 3)):
        K = nbase ** klen
        entry = out["klen {} nbase {}".format(klen, nbase)] = {}
        for T, B, seed in ((KLEN7_T, KLEN7_B, 171 + nbase),
                           (whole_T, RAW_BATCH, 271 + nbase)):
            post16 = bench_viterbi.posterior(T, B, dev, seed=seed,
                                             nstate=K + 1).to(torch.bfloat16)
            before = vk.viterbi_forward.general_launches
            up, same, same_path, same_twin = bf16_against_f32(post16, klen,
                                                              nbase)
            routed = vk.viterbi_forward.general_launches - before == 2
            print("viterbi_fwd bf16 general route klen {} nbase {} T={} "
                  "B={}: general route {}; bit_identical to the f32 kernel "
                  "on the upcast {} (paths {}), rows 0-{} codes of {} frames "
                  "equal to the twin {}".format(
                      klen, nbase, T, B, routed, same, same_path,
                      min(B, RAW_BATCH) - 1, min(T, BF16_TWIN_T), same_twin),
                  flush=True)
            if not (routed and same and same_path and same_twin):
                raise AssertionError("the general route on a bf16 posterior "
                                     "differs at klen {} nbase {} T={} B={}"
                                     .format(klen, nbase, T, B))
            if T == KLEN7_T:
                entry["checked_at"] = "T={} B={}".format(T, B)
                del post16, up
                continue
            ms32, ms16 = f32_bf16_ms(post16, up, klen, nbase)
            del post16, up
            torch.cuda.empty_cache()
            clusters = vk.viterbi_forward.general_clusters(K, nbase, dev)
            C = {e: vk.viterbi_general_plan(B, K, nbase, optin, clusters,
                                            e)["C"] for e in (4, 2)}
            b32 = bound(*viterbi_fwd_bound(T, B, K))
            b16 = bound(*viterbi_fwd_bound(T, B, K, esize=2))
            print("viterbi_fwd bf16 general route klen {} nbase {} T={} B={} "
                  "(f32, bf16, bf16, f32): f32 {:.3f} ms (plan C={}, bound "
                  "{:.3f} ms, {}), bf16 {:.3f} ms (plan C={}, bound {:.3f} "
                  "ms, {}), bf16/f32 {:.3f} [{}]".format(
                      klen, nbase, T, B, ms32, C[4], *b32, ms16, C[2], *b16,
                      ms16 / ms32, card_line()), flush=True)
            entry.update(shape="T={} B={} K={}".format(T, B, K),
                         plan_C_f32=C[4], plan_C_bf16=C[2], ms_f32=ms32,
                         ms_bf16=ms16, bound_ms_f32=b32[0],
                         bound_ms_bf16=b16[0], bound_by=b16[1])
    return out


def valid_post(post, lengths):
    """(T', nstate) float32 rows of a (T, B, nstate) posterior's valid
    frames."""
    T = post.shape[0]
    mask = torch.arange(T, device=post.device)[:, None] < lengths[None, :]
    return post.float()[mask]


def bf16_basecall_paths(dev, standin, counters, event_feats):
    """The chunked DAC, whole-read raw and events basecall paths, each run
    in float32 and under ``config.compute_dtype`` bfloat16 (bfloat16 affine
    products, a bfloat16 posterior stream): every kernel of the path
    launched and none took the general Viterbi route; throughput, peak
    device memory, the share of reads called the same; the posterior of a
    batch against float32's (max abs difference < BF16_POST_TOL, argmax
    agreement > BF16_ARGMAX over its valid frames; the events model at
    BF16_EVENTS_SD, and at phase 12's sd, whose check is printed, not
    held); then a profile of the chunked path's bfloat16 call (the cast is
    the floor's add, written in bfloat16)."""
    from sloika_tpu_torch import basecall as bc, config, models
    dac = synthetic_reads()
    sigs = raw_signals(dac)
    ev_net = lambda sd: seeded_weights(models.network_factory(
        "baseline_lstm")(klen=5, sd=0.5, size=LSTM_S), seed=21, sd=sd)
    ev_layer = ev_net(BF16_EVENTS_SD)
    # a batch of each path for the posterior check: 4 windows; 2 whole
    # reads of RAW_SHORT samples; 4 event reads
    wins = np.concatenate([bc.normalise_dac_f32(d, n) for d, n in dac])
    wins = wins[:4 * CHUNK].reshape(4, CHUNK).T.copy()[:, :, None]
    short = raw_signals([(d[:RAW_SHORT], n4) for d, n4 in
                         synthetic_reads(n=2, seed=9)])
    paths = (
        ("chunked DAC", "basecall", standin,
         dict(chunk_size=CHUNK, overlap=OVERLAP, batch_size=BATCH,
              chunked=True, output="bases"),
         lambda c: c.basecall_dac_reads(dac), sum(len(d) for d, _ in dac),
         "samples", [wins[:, b] for b in range(4)]),
        ("whole-read raw", "basecall_raw", standin,
         dict(batch_size=RAW_BATCH, output="states"),
         lambda c: c.basecall_signals(sigs), sum(len(x) for x in sigs),
         "samples", short),
        ("events", "basecall_events", ev_layer,
         dict(batch_size=EVENTS_READS, output="states"),
         lambda c: c.basecall_signals(event_feats),
         sum(len(r) for r in event_feats), "events", event_feats[:4]))
    out = {}
    dtypes = (torch.float32, torch.bfloat16)
    try:
        for name, key, layer, kw, run, n, unit, check in paths:
            callers = {}
            for dtype in dtypes:
                config.compute_dtype = dtype
                callers[dtype] = bc.Basecaller(layer, 5, device=dev, **kw)
                run(callers[dtype])                      # warm-up
            res = {d: {"s": [], "peak_mib": 0.0} for d in dtypes}
            # in turns, so that neither dtype always runs first
            for dtype in dtypes + dtypes[::-1]:
                config.compute_dtype = dtype
                zero_counts(counters)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                calls = run(callers[dtype])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = read_counts(counters)
                launched = [counts[k] for k in PATH_KERNELS[key]]
                if min(launched) <= 0:
                    raise AssertionError("a kernel of the {} path never "
                                         "launched under {}: {}".format(
                                             name, dtype, launched))
                r = res[dtype]
                r.update(calls=calls, launches=launched)
                r["s"].append(dt)
                r["peak_mib"] = max(r["peak_mib"],
                                    torch.cuda.max_memory_allocated()
                                    / 2 ** 20)
            for r in res.values():
                r["rate"] = n * len(r["s"]) / sum(r["s"])
            if key == "basecall":
                config.compute_dtype = torch.bfloat16
                prof_line = profiled_call(
                    lambda: run(callers[torch.bfloat16]))
            diff, agree, frames = bf16_posterior_check(layer, kw, check,
                                                       dev)
            a, b = res[torch.float32], res[torch.bfloat16]
            same = [len(c1) == len(c2) and bool(np.all(c1 == c2))
                    for (_, c1), (_, c2) in zip(a["calls"], b["calls"])]
            print("bf16 {} basecall path (f32, bf16, bf16, f32): f32 {:.1f} "
                  "{}/s peak {:.1f} MiB; "
                  "bf16 {:.1f} {}/s peak {:.1f} MiB (launches {} {}); reads "
                  "called the same {}/{}; posterior of a batch ({} frames) "
                  "bf16 vs f32: max_abs_diff {:.3e} (< {}), argmax "
                  "agreement {:.4f} (> {}) [{}]".format(
                      name, a["rate"], unit, a["peak_mib"], b["rate"], unit,
                      b["peak_mib"], PATH_KERNELS[key], b["launches"],
                      sum(same), len(same), frames, diff, BF16_POST_TOL,
                      agree, BF16_ARGMAX, card_line()), flush=True)
            if not (diff < BF16_POST_TOL and agree > BF16_ARGMAX):
                raise AssertionError("the {} path's bf16 posterior departs "
                                     "from f32: {} {}".format(name, diff,
                                                              agree))
            for c in res.values():
                if any(len(call) == 0 or not np.isfinite(sc)
                       for sc, call in c["calls"]):
                    raise AssertionError("the {} path gave an empty or "
                                         "non-finite call".format(name))
                del c["calls"]
            out[name] = {"f32": a, "bf16": b, "reads_called_the_same":
                         sum(same) / len(same), "posterior_max_abs_diff":
                         diff, "argmax_agreement": agree, "unit": unit}
        flat = bf16_posterior_check(ev_net(0.5), paths[2][3],
                                    event_feats[:4], dev)
    finally:
        config.compute_dtype = torch.float32
    print("bf16 events posterior at phase 12's weights (sd 0.5, near-"
          "uniform: not held): max_abs_diff {:.3e}, argmax agreement {:.4f} "
          "over {} frames".format(*flat), flush=True)
    out["events"]["at_sd_0.5"] = {"posterior_max_abs_diff": flat[0],
                                  "argmax_agreement": flat[1]}
    print("bf16 chunked DAC basecall profile (one call, profiled): "
          + prof_line, flush=True)
    return out


def bf16_posterior_check(layer, kw, seqs, dev):
    """(max abs difference, argmax agreement, frames) of the posterior
    that a Basecaller of ``layer`` streams to the Viterbi under bfloat16
    against float32's, over the valid frames of a batch of ``seqs``."""
    from sloika_tpu_torch import basecall as bc, config
    x, lengths = padded_batch(seqs)
    posts, prev = {}, config.compute_dtype
    try:
        for dtype in (torch.float32, torch.bfloat16):
            config.compute_dtype = dtype
            caller = bc.Basecaller(layer, 5, device=dev, **kw)
            with torch.inference_mode():
                post, out_len = caller._floored_masked_post(
                    x.to(dev), lengths.to(dev))
            if post.dtype != dtype:
                raise AssertionError("a {} posterior under {}".format(
                    post.dtype, dtype))
            posts[dtype] = valid_post(post, out_len)
    finally:
        config.compute_dtype = prev
    p32, p16 = posts[torch.float32], posts[torch.bfloat16]
    return (float((p16 - p32).abs().max()),
            float((p16.argmax(1) == p32.argmax(1)).float().mean()),
            len(p32))


def padded_batch(seqs):
    """(T, B, F) float32 zero-padded batch of 1-D signals or (T, F)
    feature matrices, and their lengths."""
    nfeat = 1 if seqs[0].ndim == 1 else seqs[0].shape[1]
    lengths = np.array([len(s) for s in seqs], np.int64)
    x = np.zeros((int(lengths.max()), len(seqs), nfeat), np.float32)
    for b, s in enumerate(seqs):
        x[:len(s), b] = s.reshape(len(s), nfeat)
    return torch.from_numpy(x), torch.from_numpy(lengths)


# ---------------------------------------------------------------------------
# Phase 16: the zoo.  Reference-layout pickles are written here from the
# port's layers, as the reference's train_network.py pickled its layers
# (tests/test_torch_theano_pickle.py feeds the same bytes to both packages)
# ---------------------------------------------------------------------------

class RefGlobal:
    """A module-level global of the reference (an activation function),
    pickled by its module and name."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __reduce__(self):
        return self.name


_REF_CLASSES = {}


def ref_object(module, name, **state):
    """An object whose class pickles as the global ``module.name``, with
    ``state`` as its attributes."""
    key = (module, name)
    if key not in _REF_CLASSES:
        _REF_CLASSES[key] = type(name, (), {"ref_module": module})
    obj = _REF_CLASSES[key]()
    obj.__dict__.update(state)
    return obj


class RefPickler(pickle._Pickler):
    """Pickle protocol 2 (the reference's cPickle.HIGHEST_PROTOCOL), each
    global under the reference's name for it: the stub classes and
    activations under ``sloika.*`` and ``theano.*``, numpy's array
    reconstruction under ``numpy.core`` (numpy 2 calls it ``numpy._core``).
    The pure-Python pickler lets ``save_global`` write the names."""

    def __init__(self, fh):
        super().__init__(fh, protocol=2)

    def save_global(self, obj, name=None):
        if isinstance(obj, RefGlobal):
            module, name = obj.module, obj.name
        else:
            module = getattr(obj, "ref_module", None) or obj.__module__
            name = name or obj.__qualname__
        if module.startswith("numpy._core"):
            module = "numpy.core" + module[len("numpy._core"):]
        self.write(pickle.GLOBAL + "{}\n{}\n".format(module, name).encode())
        self.memoize(obj)


def ref_shared(a):
    """A Theano shared variable: its container's storage holds the array."""
    return ref_object("theano.tensor.sharedvar", "TensorSharedVariable",
                      container=ref_object("theano.gof.link", "Container",
                                           storage=[np.asarray(a,
                                                               np.float32)]))


def reference_stub(layer):
    """The object the reference pickles for a port layer: class
    ``sloika.layers.<kind>``, parameters in shared variables in its flat
    layouts (GRU, Forget, Genmut and LstmO block-wise; Lstm and LstmCIFG
    row G*u + g for unit u, gate g), activations as ``sloika.activation``
    globals, and Scrn's alpha on the diagonal of ``ssW``."""
    kind = type(layer).__name__
    t = {k: v.detach().cpu().numpy()
         for k, v in layer.named_parameters(recurse=False)}

    def obj(**state):
        return ref_object("sloika.layers", kind, **state)

    def act(f):
        return RefGlobal("sloika.activation", f.__name__)

    if kind in ("Serial", "Parallel"):
        return obj(layers=[reference_stub(l) for l in layer.layers])
    if kind in ("Reverse", "Residual"):
        return obj(layer=reference_stub(layer.layer))
    if kind in ("Identity", "Studentise", "NormaliseL1"):
        return obj(_insize=layer.insize)
    if kind == "Window":
        return obj(insize=layer.insize, w=layer.w)
    if kind == "MaxPool":
        return obj(_insize=layer.insize, pool_size=layer.pool_size,
                   stride=layer.stride, padding_mode=layer.padding_mode)
    st = {k: ref_shared(v) for k, v in t.items()}
    if hasattr(layer, "fun"):
        st["fun"] = act(layer.fun)
    # the reference's Forget never assigns its gate function
    if hasattr(layer, "gatefun") and kind != "Forget":
        st["gatefun"] = act(layer.gatefun)
    if kind != "Scrn":
        st["has_bias"] = layer.has_bias
    if hasattr(layer, "has_peep"):
        st["has_peep"] = layer.has_peep
    S = layer.size
    if kind == "Convolution":
        st.update(stride=layer.stride, padding_mode=layer.padding_mode)
    elif kind in ("Gru", "Forget", "Genmut", "LstmO"):
        for k in ("iW", "xW", "sW", "b"):
            if k in t:
                st[k] = ref_shared(t[k].reshape(-1, *t[k].shape[2:]))
    elif kind in ("Lstm", "LstmCIFG"):
        for k in ("iW", "sW", "b"):
            gm = t[k]            # (G, S, ...) -> row G*u + g is (u, g)
            st[k] = ref_shared(np.swapaxes(gm, 0, 1).reshape(
                gm.shape[0] * S, *gm.shape[2:]))
    elif kind == "Scrn":
        st["ssW"] = ref_shared(layer.alpha * np.eye(layer.slow_size))
    return obj(**st)


def write_reference_pickle(layer):
    """The bytes of ``layer`` pickled in the reference's layout."""
    buf = io.BytesIO()
    RefPickler(buf).dump(reference_stub(layer))
    return buf.getvalue()


def load_pickled(layer, name, tmp):
    """``layer`` written as a reference pickle ``name`` in ``tmp`` and read
    back through the basecall CLI's ``load_model``; returns (the loaded
    layer, the path)."""
    from sloika_tpu_torch.cli.basecall import load_model
    path = os.path.join(tmp, name)
    with open(path, "wb") as fh:
        fh.write(write_reference_pickle(layer))
    return load_model(path), path


def zoo_graph(seed=31):
    """Every type the pickle bridge converts but the stand-in's, at small
    widths over 4 features: ZOO_SCAN_CELLS cells on the scan route (a GRU
    with relu among them), a peephole LSTM on the kernels, and the
    parameter-free layers."""
    from sloika_tpu_torch import activations, nn
    F, S = 4, 16
    return seeded_weights(nn.Serial([
        nn.Identity(F), nn.NormaliseL1(F), nn.Window(F, 3),
        nn.Recurrent(3 * F, S, has_bias=True),
        nn.Parallel([nn.LstmCIFG(S, S // 2, has_bias=True, has_peep=True),
                     nn.Reverse(nn.LstmO(S, S // 2, has_bias=True,
                                         has_peep=True))]),
        nn.Forget(S, S, has_bias=True),
        nn.Scrn(S, 10, S - 10, alpha=0.9),
        nn.Residual(nn.Mut1(S, S, has_bias=True)),
        nn.Mut2(S, S, has_bias=True), nn.Mut3(S, S, has_bias=True),
        nn.Genmut(S, S, has_bias=True),
        nn.Lstm(S, S, has_bias=True, has_peep=True),
        nn.Reverse(nn.Gru(S, S, has_bias=True, fun=activations.relu)),
        nn.MaxPool(S, 3, 2),
        nn.Reverse(nn.FeedForward(S, S, has_bias=True)),
        nn.SoftmaxTheano(S, S, has_bias=True)]), seed)


def studentise_graph(seed=43):
    """An events model with a Studentise front: Studentise -> Window ->
    biGRU -> Softmax over the 1,025 states of k = 5, weights at sd 1.5 (a
    peaked posterior, as a trained model's: few near-ties)."""
    from sloika_tpu_torch import nn
    return seeded_weights(nn.Serial([
        nn.Studentise(4), nn.Window(4, 3),
        nn.birnn(nn.Gru(12, 32, has_bias=True),
                 nn.Gru(12, 32, has_bias=True)),
        nn.Softmax(64, 1025, has_bias=True)]), seed, sd=1.5)


def timed_path(counters, fn, scan_calls=0, general=False):
    """(result, seconds, launches by kernel) of one run of ``fn``."""
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts(counters, scan_calls,
                                                      general)


def need_launches(counts, names, what):
    """The launches of ``names``; raises unless each launched."""
    launched = [counts[n] for n in names]
    if min(launched) <= 0:
        raise AssertionError("a kernel of the {} path never launched: {}"
                             .format(what, dict(zip(names, launched))))
    return launched


def check_calls(out, what):
    for i, (score, call) in enumerate(out):
        if len(call) == 0 or not np.isfinite(score):
            raise AssertionError("{} read {}: bad call (score {}, {} states)"
                                 .format(what, i, score, len(call)))


def phase_zoo(dev, standin, counters, raw_calls, event_feats):
    """16a: the stand-in through a reference pickle; 16b: bigger_raw_gru
    basecalling and training; 16c: the zoo pickle, a Studentise model,
    baseline_gru, ``verify`` and ``dump_json``.

    :returns: the launches of each path"""
    with tempfile.TemporaryDirectory() as tmp:
        launches = {"zoo_pkl": zoo_pickled_standin(dev, standin, counters,
                                                   raw_calls, tmp)}
        launches.update(zoo_bigger_raw_gru(dev, counters))
        launches.update(zoo_cells(dev, counters, event_feats, tmp))
    return launches


def zoo_pickled_standin(dev, standin, counters, raw_calls, tmp):
    """16a: the stand-in's weights written as a reference pickle, loaded by
    ``load_model``, basecall the 16 reads whole as phase 5b does: posterior
    and calls bit-identical to the stand-in's own."""
    from sloika_tpu_torch import basecall as bc
    loaded, _ = load_pickled(standin, "standin.pkl", tmp)
    sigs = raw_signals(synthetic_reads())
    caller = bc.Basecaller(loaded, 5, batch_size=RAW_BATCH, output="states",
                           device=dev)
    caller.basecall_signals(sigs)                    # warm-up
    out, dt, counts = timed_path(counters,
                                 lambda: caller.basecall_signals(sigs))
    launched = need_launches(counts, PATH_KERNELS["basecall_raw"], ".pkl")
    same = [s1 == s2 and np.array_equal(c1, c2)
            for (s1, c1), (s2, c2) in zip(out, raw_calls)]
    x, lengths = padded_batch(sigs[:2])
    with torch.inference_mode():
        got, _ = caller._floored_masked_post(x.to(dev), lengths.to(dev))
        ref, _ = bc.Basecaller(standin, 5, output="states", device=dev) \
            ._floored_masked_post(x.to(dev), lengths.to(dev))
    same_post = torch.equal(got, ref)
    nsamples = sum(len(s) for s in sigs)
    print("zoo .pkl path: the stand-in pickled in the reference's layout, "
          "loaded by load_model: {} reads {} samples in {:.3f} s: {:.1f} "
          "samples/s, launches gru_fwd {} viterbi_fwd {} viterbi_back {} "
          "output_head {}; "
          "calls and scores bit-identical to phase 5b's {}/{}, posterior of "
          "2 reads bit-identical {} [{}]".format(
              len(sigs), nsamples, dt, nsamples / dt, *launched, sum(same),
              len(same), same_post, card_line()), flush=True)
    if not (all(same) and same_post):
        raise AssertionError("the pickled stand-in departs from the stand-in")
    return counts


def zoo_bigger_raw_gru(dev, counters):
    """16b: bigger_raw_gru at its published widths basecalls the 16 reads
    whole, two short reads' posterior against the CPU forward, then
    BIG_TRAIN_STEPS steps of training at B = 100 x 2,000 samples and one
    batch's gradients against the CPU twins'."""
    from sloika_tpu_torch import basecall as bc, models, training
    from sloika_tpu_torch.profile_train import StepMarks, synthetic_chunks
    layer = models.network_factory("bigger_raw_gru")(klen=5, sd=0.5, seed=0)
    cpu_layer = copy.deepcopy(layer)
    sigs = raw_signals(synthetic_reads())
    caller = bc.Basecaller(layer, 5, batch_size=RAW_BATCH, output="states",
                           device=dev)
    caller.basecall_signals(sigs)                    # warm-up
    out, dt, counts = timed_path(counters,
                                 lambda: caller.basecall_signals(sigs))
    launched = need_launches(counts, PATH_KERNELS["basecall_raw"],
                             "bigger_raw_gru basecall")
    check_calls(out, "bigger_raw_gru")
    nsamples = sum(len(s) for s in sigs)
    short = raw_signals([(d[:RAW_SHORT], n4) for d, n4 in
                         synthetic_reads(n=2, seed=9)])
    x, lengths = padded_batch(short)
    with torch.inference_mode():
        got, _ = caller._floored_masked_post(x.to(dev), lengths.to(dev))
        ref, _ = bc.Basecaller(cpu_layer, 5, output="states", device="cpu") \
            ._floored_masked_post(x, lengths)
    d = float((got.cpu().float() - ref.float()).abs().max())
    print("zoo bigger_raw_gru (32/96/128, stride 2) whole-read basecall: {} "
          "reads {} samples in {:.3f} s: {:.1f} samples/s, launches gru_fwd "
          "{} viterbi_fwd {} viterbi_back {}; posterior of 2 reads of {:,} "
          "samples vs the CPU forward: max_abs_err {:.3e} [{}]".format(
              len(sigs), nsamples, dt, nsamples / dt, *launched, RAW_SHORT,
              d, card_line()), flush=True)
    if not d <= POST_TOL:
        raise AssertionError("bigger_raw_gru posterior differs from the CPU "
                             "forward by {} > {}".format(d, POST_TOL))

    data = synthetic_chunks(stride=2)
    clock = StepMarks(sync=True)
    (_, history), wall, train_counts = timed_path(
        counters, lambda: training.train(
            layer, data, batch_size=TRAIN_B, chunk_len_range=(1.0, 1.0),
            drop=20, niteration=BIG_TRAIN_STEPS, seed=1, log=clock,
            device=dev))
    trained = need_launches(train_counts, PATH_KERNELS["train"],
                            "bigger_raw_gru training")
    steps = BIG_TRAIN_STEPS - BIG_TRAIN_WARM
    sdt = clock.marks[-1] - clock.marks[BIG_TRAIN_WARM - 1]
    print("zoo bigger_raw_gru training: {} ADAMski steps of B={} x {} "
          "samples in {:.3f} s; steps {}-{}: {:.2f} ms a step, {:.1f} "
          "chunks/s; loss {:.4f} -> {:.4f}; launches gru_fwd {} gru_bwd {} "
          "gru_wgrad {} [{}]".format(
              BIG_TRAIN_STEPS, TRAIN_B, TRAIN_SAMPLES, wall,
              BIG_TRAIN_WARM + 1, BIG_TRAIN_STEPS, 1e3 * sdt / steps,
              steps * TRAIN_B / sdt, history[0, 0], history[-1, 0],
              *trained, card_line()), flush=True)
    if len(history) != BIG_TRAIN_STEPS or not np.isfinite(history).all():
        raise AssertionError("bigger_raw_gru losses not all finite: {}"
                             .format(history[:, 0]))
    gradients_against_cpu(layer, data, 2, dev, "bigger_raw_gru gradients "
                          "(B=4, T={})".format(TRAIN_SAMPLES // 2))
    return {"zoo_bigger_raw_gru": counts,
            "zoo_bigger_raw_gru_train": train_counts}


def zoo_cells(dev, counters, event_feats, tmp):
    """16c: the zoo pickle on the card against the CPU; a Studentise model
    through ``Basecaller(chunked=True, output="bases")``, which falls back
    to whole reads at batch 1; baseline_gru on 4 event reads; ``verify``
    and ``dump_json`` through their ``main``."""
    from sloika_tpu_torch import basecall as bc, models
    from sloika_tpu_torch.cli import dump_json, verify
    launches = {}
    zoo, zoo_pkl = load_pickled(zoo_graph(), "zoo.pkl", tmp)
    cpu_zoo = copy.deepcopy(zoo)
    zoo.to(dev).eval()
    x = torch.from_numpy(np.random.RandomState(41).normal(
        size=(ZOO_T, ZOO_B, 4)).astype(np.float32))
    with torch.inference_mode():
        got, dt, counts = timed_path(counters, lambda: zoo(x.to(dev)),
                                     scan_calls=ZOO_SCAN_CELLS)
        ref = cpu_zoo(x)
    launches["zoo_cells"] = counts
    d = float((got.cpu() - ref).abs().max())
    print("zoo pickle (every other convertible type, T={} B={}) on the "
          "card: {:.3f} s, {} scan-route cells ({:.1f} us a cell-step), "
          "lstm_fwd launches {}; vs the CPU forward: max_abs_err {:.3e} [{}]"
          .format(ZOO_T, ZOO_B, dt, ZOO_SCAN_CELLS,
                  1e6 * dt / (ZOO_SCAN_CELLS * ZOO_T), counts["lstm_fwd"], d,
                  card_line()), flush=True)
    need_launches(counts, ("lstm_fwd",), "zoo pickle")
    if not d <= ZOO_TOL:
        raise AssertionError("the zoo pickle's card forward differs from "
                             "the CPU's by {} > {}".format(d, ZOO_TOL))

    feats = [r[:STUDENTISE_EVENTS] for r in event_feats[:4]]
    stud = studentise_graph()
    callers = [bc.Basecaller(layer, 5, chunked=True, output="bases",
                             device=d)
               for layer, d in ((copy.deepcopy(stud), "cpu"), (stud, dev))]
    if any(c.output != "states" for c in callers):
        raise AssertionError("the Studentise model did not fall back to "
                             "whole reads")
    out, dt, counts = timed_path(
        counters, lambda: callers[1].basecall_signals(feats))
    launches["zoo_studentise"] = counts
    ref = callers[0].basecall_signals(feats)
    same = [np.array_equal(a[1], b[1]) for a, b in zip(out, ref)]
    rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(out, ref))
    print("zoo Studentise events model through Basecaller(chunked=True, "
          "output=\"bases\"):"
          " whole reads at batch 1, {} reads of {} events in {:.3f} s, "
          "launches gru_fwd {} viterbi_fwd {}; calls identical to the CPU "
          "route's {}/{}, score max rel err {:.3e}".format(
              len(feats), STUDENTISE_EVENTS, dt, counts["gru_fwd"],
              counts["viterbi_fwd"], sum(same), len(same), rel), flush=True)
    if counts["viterbi_fwd"] != len(feats) or \
            counts["gru_fwd"] != 2 * len(feats):
        raise AssertionError("the Studentise route did not run one read a "
                             "batch: {}".format(counts))
    if not (all(same) and rel <= RAW_SCORE_RTOL):
        raise AssertionError("the Studentise route's calls depart from the "
                             "CPU's")

    bg = seeded_weights(models.network_factory("baseline_gru")(
        klen=5, sd=0.5), seed=47)
    caller = bc.Basecaller(bg, 5, batch_size=4, output="states", device=dev)
    out, dt, counts = timed_path(
        counters, lambda: caller.basecall_signals(event_feats[:4]))
    launches["zoo_baseline_gru"] = counts
    launched = need_launches(counts, ("gru_fwd", "viterbi_fwd",
                                      "viterbi_back"), "baseline_gru")
    check_calls(out, "baseline_gru")
    nev = sum(len(r) for r in event_feats[:4])
    print("zoo baseline_gru (size 64) events basecall: 4 reads {} events in "
          "{:.3f} s: {:.1f} events/s, launches gru_fwd {} viterbi_fwd {} "
          "viterbi_back {}".format(nev, dt, nev / dt, *launched), flush=True)

    buf = io.StringIO()
    zero_counts(counters)
    with contextlib.redirect_stdout(buf):
        rc = verify.main(["baseline_raw_gru", "--stride", "2"])
    read_counts(counters)
    json_path = os.path.join(tmp, "zoo.json")
    rc_dump = dump_json.main(["--out_file", json_path, zoo_pkl])
    with open(json_path) as fh:
        dumped = json.load(fh)
    same_json = dumped == json.loads(json.dumps(cpu_zoo.to_json(True)))
    print("zoo CLIs on the card: verify baseline_raw_gru rc {} ({}); "
          "dump_json of the zoo pickle rc {}, equal to the CPU layer's JSON "
          "{}".format(rc, buf.getvalue().strip().splitlines()[0], rc_dump,
                      same_json), flush=True)
    if rc != 0 or "* OK" not in buf.getvalue() or rc_dump != 0 \
            or not same_json:
        raise AssertionError("verify or dump_json failed on the card")
    return launches


# ---------------------------------------------------------------------------
# Phase 17: call and score.  Reads simulated with known references
# (``data/simulate.py``) go through the basecall routes beside the main
# paths (the chunked "states" route, a 5-letter transducer on the general
# Viterbi route, a non-transducer decoded on the host), and ``align.py``
# scores the card's calls against the references and the CPU twin's calls
# ---------------------------------------------------------------------------

def simulated_call_reads(n, bases, seed=0):
    """(references, signals) of ``n`` reads of ``bases`` bases from one
    random genome, simulated in memory (the card's machine has no h5py):
    the int16 counts ``write_fast5`` would store, read back as pA as the
    file's channel scaling does (unchanged), trimmed and normalised as
    ``load_raw_signal`` does."""
    from sloika_tpu_torch.basecall import prepare_raw_signal
    from sloika_tpu_torch.data import simulate
    genome = simulate.random_genome(CALL_GENOME, seed=seed)
    levels = simulate.pore_model(5)
    rs = np.random.RandomState(seed + 1)
    refs, sigs = [], []
    for _ in range(n):
        read = simulate.simulate_read(genome, rs, read_len=bases,
                                      levels=levels, noise_sd=0.3)
        refs.append(read["sequence"].decode())
        sigs.append(prepare_raw_signal(
            simulate.quantise(read["signal"]).astype(np.float32)))
    return refs, sigs


def call_sequence(call, alphabet="ACGT", klen=5):
    """The bases of a transducer's kmer-state call, as ``SeqPrinter.write``
    writes them."""
    from sloika_tpu_torch import bio
    kmers = bio.all_kmers(klen, alphabet=alphabet)
    return bio.kmers_to_sequence([kmers[i] for i in call], always_move=True)


def same_calls(got, ref, what):
    """(identical, max score rel err, first differing state of each read)
    of two lists of (score, call); prints them."""
    rel = max(abs(g[0] - r[0]) / abs(r[0]) for g, r in zip(got, ref))
    same = [len(g[1]) == len(r[1]) and bool(np.all(g[1] == r[1]))
            for g, r in zip(got, ref)]
    first = [None if s else first_difference(np.asarray(g[1]),
                                             np.asarray(r[1]))
             for s, g, r in zip(same, got, ref)]
    print("{} against the CPU twin: calls identical {}/{} (first differing "
          "state {}), score max rel err {:.3e}".format(
              what, sum(same), len(same), first, rel), flush=True)
    return all(same), rel, first


def phase_call_and_score(dev, standin, counters):
    """17a: CALL_READS simulated reads; 17b: the chunked "states" route;
    17c: a 5-letter transducer on the general Viterbi route; 17d: a
    non-transducer with a bad state, decoded on the host; 17e: the card's
    calls scored by ``align.evaluate_basecalls``; 17f: the stand-in's FLOPs
    a sample.

    :returns: ({path: launches}, the general route's entry at nbase 5)
    """
    from sloika_tpu_torch.nn import flops
    t0 = time.perf_counter()
    refs, sigs = simulated_call_reads(CALL_READS, CALL_BASES)
    print("call and score (17a): {} reads of {:,} bases from one genome of "
          "{:,}, {:,} samples, normalised as load_raw_signal does".format(
              len(sigs), CALL_BASES, CALL_GENOME, sum(len(s) for s in sigs)),
          flush=True)
    launches = {}
    calls, twin, launches["call_chunked_states"] = call_chunked_states(
        dev, standin, counters, sigs)
    launches["call_nbase5"], nbase5 = call_nbase5(dev, counters, sigs)
    launches["call_nontransducer"] = call_nontransducer(dev, standin,
                                                        counters)
    score_calls(calls, twin, refs)
    fl = flops.flops_per_input_frame(standin)
    print("call and score (17f): the stand-in's forward {:,.1f} FLOP a "
          "sample ({:,.1f} a training sample), nn/flops.py".format(
              fl, flops.training_flops_per_input_frame(standin)), flush=True)
    if abs(fl - STANDIN_FLOPS) > 1e-6:
        raise AssertionError("the stand-in counts {} FLOP a sample, {} "
                             "expected".format(fl, STANDIN_FLOPS))
    print("call and score took {:.1f} s".format(time.perf_counter() - t0),
          flush=True)
    return launches, nbase5


def call_chunked_states(dev, standin, counters, sigs):
    """17b: ``Basecaller(chunked=True, output="states")``: window batches
    through the forward, the floor and the tuned Viterbi kernels on the
    card, stitched on the host; the CPU twin on the first CALL_TWIN_READS
    reads, calls identical and scores within RAW_SCORE_RTOL.

    :returns: (card calls, twin calls, launches)"""
    from sloika_tpu_torch import basecall as bc
    kw = dict(chunked=True, output="states", chunk_size=CALL_CHUNK,
              overlap=CALL_OVERLAP, batch_size=CALL_BATCH)
    caller = bc.Basecaller(standin, 5, device=dev, **kw)
    caller.basecall_signals(sigs)                    # warm-up
    out, dt, counts = timed_path(counters,
                                 lambda: caller.basecall_signals(sigs))
    check_calls(out, "chunked states")
    nwin = len(bc._window_jobs([len(s) for s in sigs], CALL_CHUNK,
                               CALL_OVERLAP))
    nbatch = -(-nwin // CALL_BATCH)
    launched = {n: counts[n] for n in PATH_KERNELS["call_chunked_states"]}
    nsamples = sum(len(s) for s in sigs)
    print("call and score (17b) chunked states route: {} reads {} windows "
          "{} samples -> {} states in {:.3f} s: {:.1f} samples/s, launches "
          "{} in {} batches of {} [{}]".format(
              len(sigs), nwin, nsamples, sum(len(c) for _, c in out), dt,
              nsamples / dt, launched, nbatch, CALL_BATCH, card_line()),
          flush=True)
    if launched != {"gru_fwd": 3 * nbatch, "viterbi_fwd": nbatch,
                    "viterbi_back": nbatch, "output_head": nbatch}:
        raise AssertionError("the chunked states route launched {}, "
                             "{} batches expected".format(launched, nbatch))
    twin = bc.Basecaller(copy.deepcopy(standin).cpu(), 5, device="cpu",
                         **kw).basecall_signals(sigs[:CALL_TWIN_READS])
    same, rel, first = same_calls(out[:CALL_TWIN_READS], twin,
                                  "call and score (17b) chunked states, {} "
                                  "reads".format(CALL_TWIN_READS))
    if not (same and rel <= RAW_SCORE_RTOL):
        raise AssertionError("the chunked states calls depart from the CPU "
                             "twin's: first differing states {}, score rel "
                             "err {}".format(first, rel))
    return out, twin, counts


def call_nbase5(dev, counters, sigs):
    """17c: the stand-in's widths over 5 bases (softmax 3,126, K = 3,125)
    on whole reads in batches of NBASE5_BATCH: the general Viterbi route
    (``general_launches`` of both wrappers > 0); two reads cut to RAW_SHORT
    samples against the CPU twin, calls identical; at the longest batch
    (the path's own T, B and K) both general kernels bit-identical to their
    plain twins on the card, then timed beside their bounds, and the
    general backtrace beside its parent's design (parent, change, change,
    parent) and split by its clocked build.

    :returns: (launches, the route's entry)"""
    from sloika_tpu_torch import basecall as bc, models
    from sloika_tpu_torch.ops import viterbi_kernel as vk
    layer = models.pretrained_standin(nbase=5)
    cpu_layer = copy.deepcopy(layer)
    caller = bc.Basecaller(layer, 5, alphabet=b"ACGTX",
                           batch_size=NBASE5_BATCH, device=dev)
    caller.basecall_signals(sigs[:NBASE5_BATCH])     # warm-up
    out, dt, counts = timed_path(
        counters, lambda: caller.basecall_signals(sigs), general=True)
    general = [vk.viterbi_forward.general_launches,
               vk.viterbi_backtrace.general_launches]
    check_calls(out, "nbase 5")
    nbatch = -(-len(sigs) // NBASE5_BATCH)
    launched = {n: counts[n] for n in PATH_KERNELS["call_nbase5"]}
    nsamples = sum(len(s) for s in sigs)
    print("call and score (17c) 5-letter transducer (K = 3,125) whole "
          "reads: {} reads {} samples in {:.3f} s: {:.1f} samples/s, "
          "launches {}, general route launches viterbi_fwd {} viterbi_back "
          "{} [{}]".format(len(sigs), nsamples, dt, nsamples / dt, launched,
                           *general, card_line()), flush=True)
    if general != [nbatch, nbatch] or launched != {
            "gru_fwd": 3 * nbatch, "viterbi_fwd": nbatch,
            "viterbi_back": nbatch, "output_head": nbatch}:
        raise AssertionError("the 5-letter transducer did not take the "
                             "general route once a batch: {} {}".format(
                                 launched, general))

    short = [s[:RAW_SHORT] for s in sigs[:2]]
    got = caller.basecall_signals(short)
    ref = bc.Basecaller(cpu_layer, 5, alphabet=b"ACGTX", batch_size=2,
                        device="cpu").basecall_signals(short)
    same, rel, first = same_calls(got, ref, "call and score (17c) 5-letter "
                                  "transducer, 2 reads of {:,} samples"
                                  .format(RAW_SHORT))
    if not (same and rel <= RAW_SCORE_RTOL):
        raise AssertionError("the 5-letter transducer's calls depart from "
                             "the CPU twin's: first differing states {}, "
                             "score rel err {}".format(first, rel))

    # the general route at the longest batch's floored posterior: held
    # bit for bit against the plain twins on the card, then timed
    from sloika_tpu_torch.ops import decode
    from sloika_tpu_torch.scripts import bench_viterbi, redesign_parents
    order = np.argsort([len(s) for s in sigs])
    x, lengths = padded_batch([sigs[i] for i in order[-NBASE5_BATCH:]])
    with torch.inference_mode():
        post, _ = caller._floored_masked_post(x.to(dev), lengths.to(dev))
        T, B, nst = post.shape
        K = nst - 1
        fwd = lambda: vk.viterbi_forward(post, 5, skip_pen=5.0, nbase=5)
        vfinal, tb = fwd()
        last = torch.argmax(vfinal, dim=1)
        path, moved = vk.viterbi_backtrace(tb, last, nbase=5)
        (v_ref, tb_ref), plain_ms = timed_once(
            lambda: decode.viterbi_forward_plain(post, 5, skip_pen=5.0,
                                                 nbase=5))
        same_fwd = torch.equal(vfinal, v_ref) and torch.equal(tb, tb_ref)
        err_fwd = max(float((vfinal - v_ref).abs().max()),
                      float((tb != tb_ref).any()))
        del v_ref, tb_ref
        (path_ref, moved_ref), back_plain_ms = timed_once(
            lambda: decode.viterbi_backtrace_plain(tb, last, nbase=5))
        same_back = (torch.equal(path, path_ref)
                     and torch.equal(moved, moved_ref))
        err_back = max(float((path - path_ref).abs().max()),
                       float((moved != moved_ref).any()))
        fwd_ms = cuda_ms(fwd, 3)
        # the general backtrace beside its parent's design
        back_runs, back_parent = against_parent(
            lambda: vk.viterbi_backtrace(tb, last, nbase=5),
            lambda: redesign_parents.viterbi_back_general_parent(tb, last,
                                                                 5), reps=5)
        back_ms = min(back_runs)
        bsplit = bench_viterbi.back_clocks(tb, last, (path, moved), 5)
        back_floors = bench_viterbi.back_design_bounds(T, B, K, bsplit)
    del tb
    torch.cuda.empty_cache()
    print("call and score (17c) general route at T={} B={} K={}: forward "
          "bit_identical to its plain twin on the card {} (max_abs_err "
          "{:.3e}), backtrace bit_identical {}".format(
              T, B, K, same_fwd, err_fwd, same_back), flush=True)
    if not (same_fwd and same_back):
        raise AssertionError("the general Viterbi route differs from its "
                             "twins at T={} B={} K={}".format(T, B, K))
    plan = vk.viterbi_general_plan(
        B, K, 5, vk._device_limits(post.device)[1],
        vk.viterbi_forward.general_clusters(K, 5, post.device))
    fwd_bound = bound(*viterbi_fwd_bound(T, B, K))
    back_bound = bound(*viterbi_back_bound(T, B))
    print("call and score (17c) general route at T={} B={} K={}: "
          "viterbi_fwd {:.3f} ms ({:.3f} us a step; bound {:.3f} ms, {}; "
          "plain {:.1f} ms; plan C={} threads={} nslots={}), viterbi_back "
          "{:.3f} ms (bound {:.4f} ms, {}; plain {:.1f} ms) [{}]".format(
              T, B, K, fwd_ms, 1e3 * fwd_ms / T, fwd_bound[0], fwd_bound[1],
              plain_ms, plan["C"], plan["threads"], plan["nslots"], back_ms,
              back_bound[0], back_bound[1], back_plain_ms, card_line()),
          flush=True)
    print("call and score (17c) general backtrace (redesigned: a "
          "shared-memory ring) at T={} B={} K={}: {:.3f} / {:.3f} ms ({:.1f} "
          "/ {:.1f} ns a frame), the parent's design (a thread a row) {:.3f} "
          "/ {:.3f} ms, parent, change, change, parent; walker {:.1f} "
          "cycles a frame at {:.2f} GHz, chain floor {:.3f} ms, the "
          "traceback's bytes {:.3f} ms [{}]".format(
              T, B, K, *back_runs, *(1e6 * x / T for x in back_runs),
              *back_parent, bsplit["cycles_per_step"], bsplit["ghz"],
              back_floors["chain_floor_ms"], back_floors["design_bytes_ms"],
              card_line()), flush=True)
    entry = {"T": T, "B": B, "K": K, "fwd_ms": fwd_ms,
             "fwd_bound_ms": fwd_bound[0], "fwd_plain_ms": plain_ms,
             "fwd_bit_identical_to_twin": same_fwd,
             "fwd_max_abs_err": err_fwd, "back_ms": back_ms,
             "back_bound_ms": back_bound[0], "back_plain_ms": back_plain_ms,
             "back_bit_identical_to_twin": same_back,
             "back_max_abs_err": err_back, "back_ms_runs": back_runs,
             "back_parent_ms": back_parent,
             "back_plan": vk.viterbi_back_general_plan(B, K, T, 5),
             "back_cycles_per_frame": bsplit["cycles_per_step"],
             "back_cycles_per_frame_by_phase": {
                 "walker": bsplit["walker"], "copier": bsplit["copier"]},
             "back_chain_floor_ms": back_floors["chain_floor_ms"],
             "back_design_bytes_ms": back_floors["design_bytes_ms"],
             "plan": plan,
             "general_launches": general,
             "short_calls_equal_to_cpu_twin": same,
             "short_calls_shape": "2 reads of {} samples".format(RAW_SHORT),
             "score_rel_err": rel}
    return counts, entry


def call_nontransducer(dev, standin, counters):
    """17d: the stand-in's 1,025 outputs read as a non-transducer with a
    bad state, on NONTRANS_READS whole reads: the forward and the floor on
    the card, the legacy decoder on the host; calls equal to the CPU
    forward's through the same decoder.

    :returns: launches"""
    from sloika_tpu_torch import basecall as bc
    _, sigs = simulated_call_reads(NONTRANS_READS, NONTRANS_BASES, seed=3)
    kw = dict(transducer=False, bad=True, batch_size=NONTRANS_READS)
    caller = bc.Basecaller(standin, 5, device=dev, **kw)
    out, dt, counts = timed_path(counters,
                                 lambda: caller.basecall_signals(sigs))
    check_calls(out, "non-transducer")
    launched = {n: counts[n] for n in ("gru_fwd", "viterbi_fwd",
                                       "viterbi_back", "output_head")}
    # the device's share: the forward, the floor and the copy to the host
    x, lengths = padded_batch(sigs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        post, _ = caller._floored_masked_post(x.to(dev), lengths.to(dev))
        post = post.cpu()
    dev_dt = time.perf_counter() - t0
    nframes = sum(len(c) for _, c in out)
    print("call and score (17d) non-transducer with a bad state: {} reads "
          "{} samples -> {} events in {:.3f} s: device (forward, floor, "
          "copy of the {:.1f} MB posterior) {:.1f} ms, host decode {:.1f} "
          "ms ({:.1f} us a frame); launches {} [{}]".format(
              len(sigs), sum(len(s) for s in sigs), nframes, dt,
              post.numel() * 4 / 1e6, 1e3 * dev_dt, 1e3 * (dt - dev_dt),
              1e6 * (dt - dev_dt) / nframes, launched, card_line()),
          flush=True)
    if launched != {"gru_fwd": 3, "viterbi_fwd": 0, "viterbi_back": 0,
                    "output_head": 1}:
        raise AssertionError("the non-transducer launched {}".format(
            launched))
    ref = bc.Basecaller(copy.deepcopy(standin).cpu(), 5, device="cpu",
                        **kw).basecall_signals(sigs)
    same, rel, first = same_calls(out, ref, "call and score (17d) "
                                  "non-transducer, the same host decoder")
    if not (same and rel <= RAW_SCORE_RTOL):
        raise AssertionError("the non-transducer's calls depart from the "
                             "CPU forward's: first differing states {}, "
                             "score rel err {}".format(first, rel))
    return counts


def score_calls(calls, twin, refs):
    """17e: the native aligner is built; the card's chunked-states calls of
    the first CALL_TWIN_READS reads aligned (``align.evaluate_basecalls``,
    one thread a read: the aligner releases the interpreter lock) to their
    simulated references and to the CPU twin's calls.  Accuracy against
    the references means nothing with random weights; the agreement with
    the twin is held."""
    from concurrent.futures import ThreadPoolExecutor
    from sloika_tpu_torch import align, native
    if not native.available():
        raise AssertionError("the native aligner did not build")
    names = ["read_{:02d}".format(i) for i in range(CALL_TWIN_READS)]
    seqs = [call_sequence(c) for _, c in calls[:CALL_TWIN_READS]]
    jobs = [(n, s, r) for n, s, r in zip(names, seqs, refs)] + \
        [(n, s, call_sequence(t[1])) for n, s, t in zip(names, seqs, twin)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        rows = list(pool.map(lambda j: align.evaluate_basecalls(
            {j[0]: j[1]}, {j[0]: j[2]}), jobs))
    dt = time.perf_counter() - t0
    to_ref = [r for rs in rows[:CALL_TWIN_READS] for r in rs]
    to_twin = [r for rs in rows[CALL_TWIN_READS:] for r in rs]
    for rs, what in ((to_ref, "the simulated references (random weights: "
                      "the accuracy means nothing)"),
                     (to_twin, "the CPU twin's calls (the agreement)")):
        print("call and score (17e) card calls of {} reads against {}: {}"
              .format(CALL_TWIN_READS, what, " | ".join(
                  l.strip() for l in align.summary(rs, "17b").splitlines()
                  if l.strip() and not l.startswith("***"))), flush=True)
    agreement = np.mean([r["accuracy"] for r in to_twin]) if to_twin else 0
    print("call and score (17e): {} alignments in {:.1f} s on {} threads; "
          "agreement with the CPU twin {:.5f} (held >= {})".format(
              len(jobs), dt, len(jobs), agreement, CALL_AGREEMENT),
          flush=True)
    if len(to_twin) != CALL_TWIN_READS or agreement < CALL_AGREEMENT:
        raise AssertionError("the card's calls agree with the CPU twin's "
                             "at {} < {}".format(agreement, CALL_AGREEMENT))


# ---------------------------------------------------------------------------
# Phase 20: ranks.  The port's process groups (``sloika_tpu_torch.parallel``)
# on the one card.  Two ranks sharing cuda:0 over gloo (``ranks_body``, one
# spawn) run (a) training, (c) the ``basecall raw`` CLI with ``--devices 2``
# and (d) the ``chunkify raw_remap`` CLI with ``--devices 2``, each held to
# single-rank runs in this process; (b) one rank of an NCCL group trains a
# group of K steps as one CUDA graph, its all-reduce captured.  The card's
# machine has no h5py: the CLIs list and load the synthetic reads from
# memory and write the chunks with numpy (``rank_reads``).
# ---------------------------------------------------------------------------

def kernel_counters():
    """{kernel name: its wrapper}, whose launch counts the paths read."""
    from sloika_tpu_torch.nn.fused_gru import (gru_backward, gru_forward,
                                               gru_wgrad)
    from sloika_tpu_torch.nn.fused_lstm import (lstm_backward, lstm_forward,
                                                lstm_wgrad)
    from sloika_tpu_torch.ops import (crf_decode, output_head, remap_kernel,
                                      viterbi_kernel)
    from sloika_tpu_torch.scripts import bench_dma, bench_gru_unroll
    from sloika_tpu_torch.scripts import bench_viterbi_parts
    return dict(zip(KERNELS, (
        gru_forward, gru_backward, gru_wgrad, viterbi_kernel.viterbi_forward,
        viterbi_kernel.viterbi_backtrace, remap_kernel.remap_banded,
        remap_kernel.remap_backtrack, lstm_forward, lstm_backward,
        lstm_wgrad, bench_gru_unroll.gru_unroll,
        bench_viterbi_parts.viterbi_parts, bench_dma.hbm_ring,
        output_head.output_head, crf_decode.crf_decode)))


def read_names(n):
    return ["read_{:02d}".format(i) for i in range(n)]


@contextlib.contextmanager
def rank_reads(listing, signals=None, dacs=None):
    """The CLIs' fast5 listing and loaders read ``listing`` from memory
    (``signals``: name -> normalised signal, as ``load_raw_signal`` gives;
    ``dacs``: name -> (dac, norm4), as ``load_raw_dac``), and the chunkify
    HDF5 writer writes its arrays with numpy (each read's chunk count in
    ``counts``)."""
    from sloika_tpu_torch import basecall as bc
    from sloika_tpu_torch.cli import basecall as bcli
    from sloika_tpu_torch.data import chunkify_tools, hdf5

    def write_chunks(path, blanks, attrs, chunks, labels, bad):
        with open(path, "wb") as fh:
            np.savez(fh, chunks=np.concatenate(chunks),
                     labels=np.concatenate(labels), bad=np.concatenate(bad),
                     counts=np.array([len(c) for c in chunks]),
                     blanks=blanks)

    saved = [(bcli, "iterate_fast5"), (chunkify_tools, "iterate_fast5"),
             (bc, "load_raw_signal"), (bc, "load_raw_dac"),
             (hdf5, "create_labelled_chunks_hdf5")]
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    bcli.iterate_fast5 = chunkify_tools.iterate_fast5 = \
        lambda *a, **k: list(listing)
    bc.load_raw_signal = lambda fn, **k: (fn, signals[fn])
    bc.load_raw_dac = lambda fn, **k: (fn,) + tuple(dacs[fn])
    hdf5.create_labelled_chunks_hdf5 = write_chunks
    try:
        yield
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


def ranks_train_kwargs():
    return dict(niteration=RANKS_STEPS, batch_size=TRAIN_B,
                chunk_len_range=(1.0, 1.0), drop=20, seed=1)


def ranks_basecall_argv(tmp, model, out):
    return ["raw", model, tmp, "--output", out]


def ranks_chunkify_argv(tmp, model, refs, out):
    return ["raw_remap", tmp, out, model, refs, "--dac", "--overwrite",
            "--output_strand_list", out + ".txt"]


def ranks_body(argv):
    """One of phase 20's two ranks, sharing cuda:0 over gloo: (a), (c) and
    (d), each between :func:`zero_counts` and :func:`read_counts`; writes
    rank<r>.json and train<r>.npz in ``argv[0]``."""
    tmp, standin, remap_model, refs = argv
    from sloika_tpu_torch import config, models, training
    from sloika_tpu_torch.cli import basecall as bcli
    from sloika_tpu_torch.cli import chunkify as ccli
    from sloika_tpu_torch.parallel import mesh
    from sloika_tpu_torch.profile_train import StepMarks, synthetic_chunks
    mesh.maybe_init_distributed("cuda", RANKS)
    dev = mesh.local_device("cuda")
    config.disable_tf32()
    counters, r = kernel_counters(), mesh.rank()
    out = {"device": str(dev), "backend": mesh.backend(),
           "ranks_per_card": mesh.ranks_per_card(),
           "describe": mesh.describe(dev)}

    layer = models.network_factory("raw_0.98_rgrgr")(klen=5, sd=0.5, seed=0)
    clock = StepMarks(sync=True)
    zero_counts(counters)
    _, hist = training.train(layer, synthetic_chunks(), log=clock,
                             device=dev, **ranks_train_kwargs())
    out["train"] = read_counts(counters)
    out["ms_a_step"] = (1e3 * (clock.marks[-1] - clock.marks[0])
                        / (len(clock.marks) - 1))
    np.savez(os.path.join(tmp, "train{}.npz".format(r)), history=hist,
             **{n: p.detach().cpu().numpy()
                for n, p in layer.named_parameters()})

    reads = synthetic_reads()
    names = read_names(len(reads))
    with rank_reads(names, signals=dict(zip(names, raw_signals(reads)))):
        zero_counts(counters)
        t0 = time.perf_counter()
        rc = bcli.main(ranks_basecall_argv(
            tmp, standin, os.path.join(tmp, "calls.ranks.fa"))
            + ["--devices", str(RANKS)])
        out["basecall_s"] = time.perf_counter() - t0
        out["basecall"] = read_counts(counters)
    if rc:
        raise AssertionError("basecall --devices {} returned {}".format(
            RANKS, rc))

    reads = synthetic_reads(n=REMAP_B)[:RANKS_REMAP_READS]
    names = read_names(len(reads))
    with rank_reads(names, dacs=dict(zip(names, reads))):
        zero_counts(counters)
        t0 = time.perf_counter()
        rc = ccli.main(ranks_chunkify_argv(
            tmp, remap_model, refs, os.path.join(tmp, "chunks.ranks"))
            + ["--devices", str(RANKS)])
        out["chunkify_s"] = time.perf_counter() - t0
        out["chunkify"] = read_counts(counters)
    if rc:
        raise AssertionError("chunkify --devices {} returned {}".format(
            RANKS, rc))
    with open(os.path.join(tmp, "rank{}.json".format(r)), "w") as fh:
        json.dump(out, fh)
    return 0


def fasta_records(path):
    """[(name, record text)] of a FASTA of one sequence line a record."""
    lines = open(path).read().splitlines(keepends=True)
    return [(lines[i][1:].split()[0], lines[i] + lines[i + 1])
            for i in range(0, len(lines), 2)]


def chunk_records(path):
    """[(name, strand row fields, chunks, labels, bad)] of each read of a
    chunkify output written by :func:`rank_reads`."""
    z = np.load(path)
    rows = [l.rstrip("\n").split("\t")
            for l in open(path + ".txt").readlines()[1:]]
    cut = np.cumsum(z["counts"])[:-1]
    return [(row[0].split(".")[0], row, c, lab, b) for row, c, lab, b in zip(
        rows, *(np.split(z[k], cut) for k in ("chunks", "labels", "bad")))]


def merged(shares, names):
    """Per-read records of each rank's share merged in read order."""
    got = {r[0]: r for share in shares for r in share}
    return [got[n] for n in names if n in got]


def phase_ranks(dev, counters):
    """Phase 20, parts (a)-(d): the launches of each part's main path."""
    from sloika_tpu_torch import models, serialize
    from sloika_tpu_torch.parallel import spawn
    with tempfile.TemporaryDirectory() as tmp:
        standin = os.path.join(tmp, "standin.json")
        serialize.save_model_json(standin, models.pretrained_standin(seed=0))
        remap_layer = models.pretrained_standin(sd=REMAP_SD, seed=0)
        remap_model = os.path.join(tmp, "remap.json")
        serialize.save_model_json(remap_model, remap_layer)
        reads = synthetic_reads(n=REMAP_B)[:RANKS_REMAP_READS]
        refs = diagonal_references(remap_layer.to(dev).eval(), reads, dev)
        refs_fa = os.path.join(tmp, "refs.fa")
        with open(refs_fa, "w") as fh:
            for n, ref in zip(read_names(len(reads)), refs):
                fh.write(">{}\n{}\n".format(n, ref.decode()))
        t0 = time.perf_counter()
        rc = spawn.run(ranks_body, [tmp, standin, remap_model, refs_fa],
                       RANKS, timeout=RANKS_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        if rc:
            raise AssertionError("a rank of phase 20 failed ({})".format(rc))
        ranks = [json.load(open(os.path.join(tmp, "rank{}.json".format(r))))
                 for r in range(RANKS)]
        print("ranks: {} ranks spawned and joined in {:.1f} s: {} [{}]"
              .format(RANKS, spawn_s, ranks[0]["describe"], card_line()),
              flush=True)
        if not (ranks[0]["backend"] == "gloo"
                and ranks[0]["ranks_per_card"] == RANKS):
            raise AssertionError("two ranks on one card must share it over "
                                 "gloo: {}".format(ranks[0]))
        # the ranks' launches on each path, summed over the ranks
        launches = {"ranks_" + part: {n: sum(r[part][n] for r in ranks)
                                      for n in KERNELS}
                    for part in ("train", "basecall", "chunkify")}
        ranks_train(dev, tmp, ranks)
        launches["ranks_graph"] = ranks_graph(dev, counters, tmp)
        ranks_basecall(tmp, standin, ranks)
        ranks_chunkify(tmp, remap_model, refs_fa, ranks)
    for path, counts in launches.items():
        if min(counts[k] for k in PATH_KERNELS[path]) <= 0:
            raise AssertionError("a kernel of {} never launched: {}".format(
                path, counts))
    return launches


def ranks_train(dev, tmp, ranks):
    """(a): the ranks' parameters bit-identical to each other; losses and
    parameters after RANKS_STEPS steps within RANKS_TRAIN_RTOL and
    RANKS_PARAM_RTOL of one rank on the same global batches."""
    from sloika_tpu_torch import models, training
    from sloika_tpu_torch.profile_train import StepMarks, synthetic_chunks
    got = [np.load(os.path.join(tmp, "train{}.npz".format(r)))
           for r in range(RANKS)]
    names = [k for k in got[0].files if k != "history"]
    same = all(np.array_equal(got[0][k], g[k]) for g in got[1:]
               for k in got[0].files)
    layer = models.network_factory("raw_0.98_rgrgr")(klen=5, sd=0.5, seed=0)
    clock = StepMarks(sync=True)
    _, hist = training.train(layer, synthetic_chunks(), log=clock,
                             device=dev, **ranks_train_kwargs())
    one_ms = 1e3 * (clock.marks[-1] - clock.marks[0]) / (len(clock.marks)
                                                         - 1)
    loss_rel = float(np.max(np.abs(got[0]["history"][:, 0] - hist[:, 0])
                            / np.abs(hist[:, 0])))
    params = {n: p.detach().cpu().numpy()
              for n, p in layer.named_parameters()}
    rel = {n: float(np.abs(got[0][n] - params[n]).max()
                    / np.abs(params[n]).max()) for n in names}
    worst = max(rel, key=rel.get)
    print("ranks (a) training raw_0.98_rgrgr, global B={} x {} samples, "
          "{} steps, K=1, {} ranks on {} over {}: ms a step (steps 2-{}) "
          "{}; one rank {:.3f}; ranks' parameters bit-identical {}; losses "
          "against one rank max rel diff {:.2e} (held <= {}), parameters "
          "max rel diff {:.2e} ({}) (held <= {}) [{}]".format(
              TRAIN_B, TRAIN_SAMPLES, RANKS_STEPS, RANKS,
              sorted({r["device"] for r in ranks}), ranks[0]["backend"],
              RANKS_STEPS, " / ".join("rank {} {:.3f}".format(i, r[
                  "ms_a_step"]) for i, r in enumerate(ranks)), one_ms, same,
              loss_rel, RANKS_TRAIN_RTOL, rel[worst], worst, RANKS_PARAM_RTOL,
              card_line()),
          flush=True)
    if not (same and np.isfinite(hist).all() and loss_rel <= RANKS_TRAIN_RTOL
            and rel[worst] <= RANKS_PARAM_RTOL):
        raise AssertionError("two-rank training departs from one rank: "
                             "same {}, loss {}, parameters {}".format(
                                 same, loss_rel, rel))


def ranks_graph(dev, counters, tmp):
    """(b): one rank of an NCCL group, a group of FUSED_K steps as one CUDA
    graph with each step's all-reduce captured, against FUSED_K eager steps
    of the same group, bit for bit (cuDNN's deterministic algorithms)."""
    import datetime
    import torch.distributed as dist
    from sloika_tpu_torch import models, training
    from sloika_tpu_torch.parallel import mesh
    from sloika_tpu_torch.profile_train import synthetic_chunks
    data = synthetic_chunks()
    kw = dict(ranks_train_kwargs(), niteration=FUSED_K, device=dev,
              log=training.Logger(None, True))
    reduce_calls, real = [], mesh.all_reduce_grads

    def counted(*a, **k):
        reduce_calls.append(1)
        return real(*a, **k)

    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(tmp, "nccl_store"),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=RANKS_TIMEOUT))
    torch.backends.cudnn.deterministic = True
    mesh.all_reduce_grads = counted
    try:
        layers = [models.network_factory("raw_0.98_rgrgr")(
            klen=5, sd=0.5, seed=0).to(dev) for _ in range(2)]
        stats = {}
        zero_counts(counters)
        training.train(layers[0], data, steps_per_dispatch=FUSED_K,
                       data_on_device=True, stats=stats, **kw)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        in_graph = len(reduce_calls)
        training.train(layers[1], data, steps_per_dispatch=1,
                       data_on_device=False, **kw)
        torch.cuda.synchronize()
        diffs = {n: float((a - b).detach().abs().max()) for (n, a), b in zip(
            layers[0].named_parameters(), layers[1].parameters())}
        backend = mesh.backend()
        names = {id(w): n for n, w in counters.items()}
        captured = {names[id(w)]: n for (w, c), n in stats["captured"].items()
                    if c == "launches"}
    finally:
        mesh.all_reduce_grads = real
        torch.backends.cudnn.deterministic = False
        mesh.shutdown()
    bits = all(d == 0.0 for d in diffs.values())
    print("ranks (b) one rank of an {} group, raw_0.98_rgrgr B={} x {}: "
          "K={} steps one CUDA graph ({} replay, all-reduce calls in its "
          "warm-up and capture {}, captured launches {}); parameters after "
          "the group bit-identical to {} eager steps {} (worst {:.2e}) [{}]"
          .format(backend, TRAIN_B, TRAIN_SAMPLES, FUSED_K, stats["replays"],
                  in_graph, captured,
                  FUSED_K, bits, max(diffs.values()), card_line()),
          flush=True)
    if not (backend == "nccl" and stats["replays"] == 1
            and in_graph == 2 * FUSED_K and bits):
        raise AssertionError("the NCCL group's graph departs from the eager "
                             "steps: {} {}".format(stats, diffs))
    return counts


def ranks_basecall(tmp, standin, ranks):
    """(c): the ranks' merged FASTA against single-rank runs of each rank's
    strided share merged in read order (byte for byte), and against one
    single-rank run of all reads (names and order; call agreement through
    ``align.evaluate_basecalls``)."""
    from concurrent.futures import ThreadPoolExecutor
    from sloika_tpu_torch import align
    from sloika_tpu_torch.cli import basecall as bcli
    reads = synthetic_reads()
    names = read_names(len(reads))
    sigs = dict(zip(names, raw_signals(reads)))
    runs = {}
    for tag, listing in [("share{}".format(r), names[r::RANKS])
                         for r in range(RANKS)] + [("all", names)]:
        path = os.path.join(tmp, "calls.{}.fa".format(tag))
        with rank_reads(listing, signals=sigs):
            if bcli.main(ranks_basecall_argv(tmp, standin, path)):
                raise AssertionError("basecall of {} failed".format(tag))
        runs[tag] = fasta_records(path)
    got = fasta_records(os.path.join(tmp, "calls.ranks.fa"))
    merge = merged([runs["share{}".format(r)] for r in range(RANKS)], names)
    bytes_equal = "".join(t for _, t in got) == "".join(t for _, t in merge)
    seq = lambda recs: {n: t.splitlines()[1] for n, t in recs}
    ours, one = seq(got), seq(runs["all"])
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        rows = list(pool.map(lambda n: align.evaluate_basecalls(
            {n: ours[n]}, {n: one[n]}), names))
    agree = float(np.mean([r["accuracy"] for rs in rows for r in rs]))
    same_order = [n for n, _ in got] == [n for n, _ in runs["all"]] == names
    print("ranks (c) basecall raw --devices {} through the CLI, {} reads "
          "whole: {:.2f} s a rank; merged FASTA byte-identical to the merged "
          "single-rank runs of each share {}; against one rank over all "
          "reads: names in order {}, calls identical {}, agreement {:.5f} "
          "(held >= {}) [{}]".format(
              RANKS, len(names), max(r["basecall_s"] for r in ranks),
              bytes_equal, same_order, ours == one, agree,
              RANKS_CALL_AGREEMENT, card_line()), flush=True)
    if not (bytes_equal and same_order and len(rows) == len(names)
            and agree >= RANKS_CALL_AGREEMENT):
        raise AssertionError("basecall --devices {} departs from its single-"
                             "rank runs".format(RANKS))


def ranks_chunkify(tmp, remap_model, refs_fa, ranks):
    """(d): the ranks' chunks, labels, bad flags and strand list against
    single-rank runs of each share merged in read order (the score column
    within RANKS_SCORE_RTOL, the rest equal)."""
    from sloika_tpu_torch.cli import chunkify as ccli
    reads = synthetic_reads(n=REMAP_B)[:RANKS_REMAP_READS]
    names = read_names(len(reads))
    dacs = dict(zip(names, reads))
    shares = []
    for r in range(RANKS):
        path = os.path.join(tmp, "chunks.share{}".format(r))
        with rank_reads(names[r::RANKS], dacs=dacs):
            if ccli.main(ranks_chunkify_argv(tmp, remap_model, refs_fa,
                                             path)):
                raise AssertionError("chunkify of share {} failed".format(r))
        shares.append(chunk_records(path))
    got = chunk_records(os.path.join(tmp, "chunks.ranks"))
    merge = merged(shares, names)
    arrays = all(all(np.array_equal(a, b) for a, b in zip(g[2:], m[2:]))
                 for g, m in zip(got, merge))
    rows = all(g[1][:2] + g[1][3:] == m[1][:2] + m[1][3:]
               for g, m in zip(got, merge))
    rel = max(abs(float(g[1][2]) - float(m[1][2])) / abs(float(m[1][2]))
              for g, m in zip(got, merge))
    order = [g[0] for g in got] == [m[0] for m in merge] == names
    bytes_equal = (open(os.path.join(tmp, "chunks.ranks.txt")).read()
                   == "".join(["\t".join(["filename", "nblocks", "score",
                                          "nstay", "seqlen", "start",
                                          "end"]) + "\n"]
                              + ["\t".join(m[1]) + "\n" for m in merge]))
    nchunk = sum(len(g[2]) for g in got)
    print("ranks (d) chunkify raw_remap --devices {} through the CLI, {} "
          "reads, {} chunks: {:.2f} s a rank; against single-rank runs of "
          "each share merged in read order: reads in order {}, chunks, "
          "labels and bad flags identical {}, strand rows identical but the "
          "score {}, score max rel diff {:.2e} (held <= {}), strand list "
          "byte-identical {} [{}]".format(
              RANKS, len(names), nchunk, max(r["chunkify_s"] for r in ranks),
              order, arrays, rows, rel, RANKS_SCORE_RTOL, bytes_equal,
              card_line()), flush=True)
    if not (order and arrays and rows and rel <= RANKS_SCORE_RTOL):
        raise AssertionError("chunkify --devices {} departs from its "
                             "single-rank runs".format(RANKS))


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a GPU")
    dev = torch.device("cuda")
    print("environment: {} | torch {} cuda {} | {} device(s)".format(
        card_line(), torch.__version__, torch.version.cuda,
        torch.cuda.device_count()), flush=True)

    from sloika_tpu_torch import config, cuda_build, models
    config.disable_tf32()
    t0 = time.time()
    cuda_build.build_all(KERNELS + ROUTES + CLOCKED + PARENTS)
    ptxas = " | ".join(
        "{} ({:.1f} s): {}".format(n, sec, " ".join(
            l.split(":", 1)[-1].strip() for l in log.splitlines()
            if "registers" in l or "spill" in l))
        for n, (sec, log) in sorted(cuda_build.BUILD_LOG.items())
        if n in KERNELS + ROUTES)
    print("build: {} kernels and {} clocked builds in {:.1f} s ({})".format(
        len(KERNELS), len(CLOCKED), time.time() - t0, ptxas), flush=True)

    standin = models.pretrained_standin(seed=0).to(dev).eval()
    gru_fwd = phase_gru(dev, standin)
    viterbi = phase_viterbi(dev, standin)
    head = phase_output_head(dev, standin)
    gru_fwd_train, bwd = phase_gru_bwd(dev)
    # the forward kernel is held to its twin at both paths' shapes
    gru_fwd["max_abs_err"] = max(gru_fwd["max_abs_err"],
                                 gru_fwd_train["max_abs_err"])
    gru_fwd["at_training_shapes"] = gru_fwd_train
    remap = phase_remap_kernels(dev)
    reads = event_reads()
    lstm = [phase_lstm(dev, max(len(r) for r in reads))] \
        + phase_lstm_bwd(dev)
    kernels = [gru_fwd] + viterbi + bwd + remap + lstm + [head]
    by_name = {k["name"]: k for k in kernels}
    # every count is set to 0 before each path and all are read after it
    counters = kernel_counters()
    launches = {"basecall": phase_main(dev, standin, counters)}
    launches["basecall_raw"], raw_calls = phase_basecall_raw(dev, standin,
                                                             counters)
    launches["train"], _ = phase_train(dev, counters)
    launches["remap"] = phase_remap(dev, counters)
    wide = phase_remap_wide(
        dev, counters,
        by_name["viterbi_fwd"]["general_route"]["floor_cycles"])
    by_name["remap_banded"]["wide_route"] = wide[0]
    by_name["remap_back"]["wide_route"] = wide[1]
    launches["basecall_events"] = phase_basecall_events(dev, counters, reads)
    crf_lstm, by_name["crf_decode"], launches["basecall_crf"] = phase_crf(
        dev, counters)
    by_name["lstm_fwd"]["at_bonito_width"] = crf_lstm
    by_name["lstm_fwd"]["max_abs_err"] = max(by_name["lstm_fwd"]["max_abs_err"],
                                             crf_lstm["max_abs_err"])
    launches["train_events"], _ = phase_train_events(dev, counters)
    diag, launches["diagnostics"] = phase_diagnostics(dev, counters)
    by_name.update((k["name"], k) for k in diag)
    by_name["viterbi_fwd"]["bf16"] = phase_bf16(dev, standin, counters,
                                                reads)
    launches.update(phase_zoo(dev, standin, counters, raw_calls, reads))
    call_launches, nbase5 = phase_call_and_score(dev, standin, counters)
    by_name["viterbi_fwd"]["nbase5"] = nbase5
    for name, err in (("viterbi_fwd", nbase5["fwd_max_abs_err"]),
                      ("viterbi_back", nbase5["back_max_abs_err"])):
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    launches.update(call_launches)
    launches["chunkify_events"] = phase_chunkify_events(dev, counters)
    launches.update(phase_train_fused(dev, counters))
    launches.update(phase_ranks(dev, counters))
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
