"""GPU smoke run of the PyTorch/CUDA port (``sloika_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one.
Phases, each printing one line and raising on failure:

1. environment: the card's name and power limit, the CUDA version;
2. build: the five kernels, from ``sloika_tpu_torch/csrc``, one nvcc each,
   all started together;
3. GRU: the forward kernel against its plain twin at S = 112 and 144,
   T = 3277, B = 64, ragged lengths, forward and reverse (max abs difference
   on valid steps <= 1e-4: float32 summation order over 3277 recurrent
   steps);
4. Viterbi: forward and backtrace kernels against their plain twins at
   K = 1024, T = 3277, B = 64 on a peaked and on a tie-heavy posterior
   (score, codes and path bit-identical);
5. basecall main path: the headline model's graph at full width (seeded
   random weights) basecalls 16 synthetic DAC reads through
   ``Basecaller.basecall_dac_reads``; every kernel of the path must have
   launched, every read must get a call, and the posterior must agree with
   the plain CPU forward on a small batch (<= 1e-4);
6. GRU backward, at the training shapes T = 400, B = 100, S = 96, ragged
   lengths, forward and reverse: the forward kernel against its twin (as
   in 3), then the backward kernels (``gru_bwd`` then ``gru_wgrad``)
   against the plain backward twin on the kernel's ``h_out``
   (max|kernel - twin| / max|twin| <= 1e-4 for dxp on valid steps and for
   the weight cotangents: float32 sums over 400 steps and 40,000 rows in
   another order);
7. training main path: ``training.train`` of raw_0.98_rgrgr at full width
   (seeded random weights) for 30 ADAMski steps of B = 100 chunks of 2,000
   samples from 1,000 synthetic chunks; every loss must be finite, the three
   GRU kernels must have launched, and one batch's gradients (B = 4) must
   agree with the plain CPU twins' (max|gpu - cpu| / max|cpu| <= 1e-3 per
   parameter: five recurrent layers, and cuDNN's convolution weight
   gradient may sum with atomics).

Then one JSON line of per-kernel numbers, the card line again, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX and no h5py.
"""
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

T_FRAMES = 3277          # frames of a 16384-sample window at stride 5
BATCH = 64
CHUNK, OVERLAP = 16384, 400
GRU_TOL = 1e-4
POST_TOL = 1e-4
# training shapes (bench.py:369): B chunks of 2,000 samples, T = 400 frames
TRAIN_B, TRAIN_SAMPLES, TRAIN_T = 100, 2000, 400
TRAIN_STEPS, TRAIN_WARM = 30, 5
BWD_RTOL = 1e-4
GRAD_RTOL = 1e-3
KERNELS = ("gru_fwd", "gru_bwd", "gru_wgrad", "viterbi_fwd", "viterbi_back")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
    return {"name": "gru_fwd", "route": "cuda",
            "source": "sloika_tpu_torch/csrc/gru_fwd.cu",
            "replaces": "sloika_tpu/nn/pallas_gru.py:41",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_viterbi(dev):
    from sloika_tpu_torch.ops import decode, viterbi_kernel
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
                  int(moved.sum())))
        if not same:
            raise AssertionError("Viterbi kernels differ from their twins "
                                 "on the {} posterior".format(kind))
    return [
        {"name": "viterbi_fwd", "route": "cuda",
         "source": "sloika_tpu_torch/csrc/viterbi_fwd.cu",
         "replaces": "sloika_tpu/ops/pallas/viterbi.py:187",
         "max_abs_err": err_fwd, "ms": fwd_t["peaked"][0],
         "plain_ms": fwd_t["peaked"][1]},
        {"name": "viterbi_back", "route": "cuda",
         "source": "sloika_tpu_torch/csrc/viterbi_back.cu",
         "replaces": "sloika_tpu/ops/pallas/viterbi.py:575",
         "max_abs_err": err_back, "ms": back_t["peaked"][0],
         "plain_ms": back_t["peaked"][1]}]


def rel_err(got, ref, mask=None):
    """(max abs difference, that over max|ref|), under an optional mask."""
    d = (got - ref).abs()
    if mask is not None:
        d = d * mask[:, :, None]
    d = float(d.max())
    return d, d / max(float(ref.abs().max()), 1e-30)


def phase_gru_bwd(dev):
    from sloika_tpu_torch.nn.fused_gru import (
        gru_backward, gru_forward, gru_scan_bwd_plain, gru_scan_plain,
        gru_wgrad, gru_wgrad_plain)
    S, T, B = 96, TRAIN_T, TRAIN_B
    rs = np.random.RandomState(3)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    xp = f32(rs.normal(size=(T, B, 3 * S)))
    sWT = f32(rs.normal(size=(S, 2 * S)) / np.sqrt(2 * S))
    sW2T = f32(rs.normal(size=(S, S)) / np.sqrt(2 * S))
    g = f32(rs.normal(size=(T, B, S)))
    lengths = rs.randint(T // 2, T + 1, size=B)
    lengths[0] = T
    mask = torch.from_numpy(np.arange(T)[:, None]
                            < lengths[None, :]).to(dev)
    worst_f = worst_b = worst_w = 0.0
    times, fwd_times = {}, {}
    for reverse in (False, True):
        # the forward at these shapes, whose h_out the backward reads
        h_out = gru_forward(xp, sWT, sW2T, mask=mask, reverse=reverse)
        e_fwd = float(((h_out - gru_scan_plain(xp, sWT, sW2T, mask,
                                               reverse=reverse)).abs()
                       * mask[:, :, None]).max())
        fwd_times[reverse] = (
            cuda_ms(lambda: gru_forward(xp, sWT, sW2T, mask=mask,
                                        reverse=reverse), 5),
            cuda_ms(lambda: gru_scan_plain(xp, sWT, sW2T, mask,
                                           reverse=reverse), 1))
        print("gru S={} reverse={} T={} B={}: max_abs_err {:.3e} kernel "
              "{:.3f} ms plain {:.3f} ms".format(S, reverse, T, B, e_fwd,
                                                 *fwd_times[reverse]),
              flush=True)
        if not e_fwd <= GRU_TOL:
            raise AssertionError("GRU kernel differs from its twin at the "
                                 "training shapes by {} > {}".format(
                                     e_fwd, GRU_TOL))
        worst_f = max(worst_f, e_fwd)
        got = gru_backward(xp, sWT, sW2T, mask, reverse, g, h_out)
        ref = gru_scan_bwd_plain(xp, sWT, sW2T, mask, reverse, g, h_out)
        e_dxp = rel_err(got[0], ref[0], mask)
        e_w = [rel_err(a, b) for a, b in zip(got[1:], ref[1:])]
        dxp, rh = gru_backward.recurrence(xp, sWT, sW2T, mask, reverse, g,
                                          h_out)
        e_wt = [rel_err(a, b)[1] for a, b in zip(
            gru_wgrad(h_out, rh, dxp, reverse),
            gru_wgrad_plain(h_out, rh, dxp, reverse))]
        times[reverse] = (
            cuda_ms(lambda: gru_backward.recurrence(
                xp, sWT, sW2T, mask, reverse, g, h_out), 5),
            cuda_ms(lambda: gru_scan_bwd_plain(
                xp, sWT, sW2T, mask, reverse, g, h_out), 1),
            cuda_ms(lambda: gru_wgrad(h_out, rh, dxp, reverse), 20),
            cuda_ms(lambda: gru_wgrad_plain(h_out, rh, dxp, reverse), 20))
        worst_b = max(worst_b, e_dxp[0])
        worst_w = max([worst_w] + [e[0] for e in e_w])
        print("gru backward S={} reverse={} T={} B={}: dxp max_abs_err "
              "{:.3e} (rel {:.3e}), dsWT {:.3e} (rel {:.3e}), dsW2T {:.3e} "
              "(rel {:.3e}); gru_wgrad vs its einsum twin rel {:.3e} {:.3e}; "
              "gru_bwd kernel {:.3f} ms, plain backward twin {:.3f} ms; "
              "gru_wgrad kernel {:.3f} ms, einsum {:.3f} ms".format(
                  S, reverse, T, B, *e_dxp, *e_w[0], *e_w[1], *e_wt,
                  *times[reverse]), flush=True)
        bad = [e for e in [e_dxp[1]] + [e[1] for e in e_w] + e_wt
               if not e <= BWD_RTOL]
        if bad:
            raise AssertionError("GRU backward kernels differ from their "
                                 "twins: relative errors {} > {}".format(
                                     bad, BWD_RTOL))
    ms, plain_ms, wms, wplain_ms = times[False]
    fwd = {"shape": "T={} B={} S={}".format(T, B, S),
           "max_abs_err": worst_f, "ms": fwd_times[False][0],
           "plain_ms": fwd_times[False][1]}
    return fwd, [
        {"name": "gru_bwd", "route": "cuda",
         "source": "sloika_tpu_torch/csrc/gru_bwd.cu",
         "replaces": "sloika_tpu/nn/pallas_gru.py:157",
         "max_abs_err": worst_b, "ms": ms, "plain_ms": plain_ms},
        {"name": "gru_wgrad", "route": "cuda",
         "source": "sloika_tpu_torch/csrc/gru_wgrad.cu",
         "replaces": "sloika_tpu/nn/pallas_gru.py:157",
         "max_abs_err": worst_w, "ms": wms, "plain_ms": wplain_ms}]


def phase_train(dev, counters):
    from sloika_tpu_torch import models, training
    from sloika_tpu_torch.profile_train import StepMarks, synthetic_chunks
    layer = models.network_factory("raw_0.98_rgrgr")(klen=5, sd=0.5,
                                                     seed=0)
    data = synthetic_chunks()
    clock = StepMarks(sync=True)
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, history = training.train(
        layer, data, batch_size=TRAIN_B, chunk_len_range=(1.0, 1.0),
        drop=20, niteration=TRAIN_STEPS, seed=1, log=clock, device=dev)
    wall = time.perf_counter() - t0
    launches = [k.launches for k in counters]
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
    return launches, peak


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
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = caller.basecall_dac_reads(reads)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [k.launches for k in counters]
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
                               overlap=OVERLAP, device="cpu") \
            ._floored_masked_post(x, lengths)
    d = float((got.cpu() - ref).abs().max())
    print("posterior check (4 windows, GPU kernels vs CPU plain forward): "
          "max_abs_err {:.3e}".format(d))
    if not d <= POST_TOL:
        raise AssertionError("posterior differs from the CPU forward by "
                             "{} > {}".format(d, POST_TOL))
    return launches


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
    from sloika_tpu_torch.ops import viterbi_kernel
    config.disable_tf32()
    t0 = time.time()
    cuda_build.build_all(KERNELS)
    ptxas = " | ".join(
        "{} ({:.1f} s): {}".format(n, sec, " ".join(
            l.split(":", 1)[-1].strip() for l in log.splitlines()
            if "registers" in l or "spill" in l))
        for n, (sec, log) in sorted(cuda_build.BUILD_LOG.items()))
    print("build: {} kernels in {:.1f} s ({})".format(
        len(KERNELS), time.time() - t0, ptxas), flush=True)

    standin = models.pretrained_standin(seed=0).to(dev).eval()
    gru_fwd = phase_gru(dev, standin)
    viterbi = phase_viterbi(dev)
    gru_fwd_train, bwd = phase_gru_bwd(dev)
    # the forward kernel is held to its twin at both paths' shapes
    gru_fwd["max_abs_err"] = max(gru_fwd["max_abs_err"],
                                 gru_fwd_train["max_abs_err"])
    gru_fwd["at_training_shapes"] = gru_fwd_train
    kernels = [gru_fwd] + viterbi + bwd
    by_name = {k["name"]: k for k in kernels}
    paths = {
        "basecall": (gru_forward, viterbi_kernel.viterbi_forward,
                     viterbi_kernel.viterbi_backtrace),
        "train": (gru_forward, gru_backward, gru_wgrad)}
    names = {"basecall": ("gru_fwd", "viterbi_fwd", "viterbi_back"),
             "train": ("gru_fwd", "gru_bwd", "gru_wgrad")}
    launches = {"basecall": phase_main(dev, standin, paths["basecall"])}
    launches["train"], _ = phase_train(dev, paths["train"])
    for path, counts in launches.items():
        for name, n in zip(names[path], counts):
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
