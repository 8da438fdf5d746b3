"""GPU smoke run of the PyTorch/CUDA port (``sloika_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero, printing no result, without one.
Phases, each printing one line and raising on failure:

1. environment: the card's name and power limit, the CUDA version;
2. build: the three kernels, from ``sloika_tpu_torch/csrc``, with nvcc;
3. GRU: the kernel against its plain twin at S = 112 and 144, T = 3277,
   B = 64, ragged lengths, forward and reverse (max abs difference on valid
   steps <= 1e-4: float32 summation order over 3277 recurrent steps);
4. Viterbi: forward and backtrace kernels against their plain twins at
   K = 1024, T = 3277, B = 64 on a peaked and on a tie-heavy posterior
   (score, codes and path bit-identical);
5. main path: the headline model's graph at full width (seeded random
   weights) basecalls 16 synthetic DAC reads through
   ``Basecaller.basecall_dac_reads``; every kernel must have launched, every
   read must get a call, and the posterior must agree with the plain CPU
   forward on a small batch (<= 1e-4).

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


def phase_main(dev, standin, kernels):
    from sloika_tpu_torch import basecall as bc
    from sloika_tpu_torch.nn.fused_gru import gru_forward
    from sloika_tpu_torch.ops import viterbi_kernel

    reads = synthetic_reads()
    cpu_layer = copy.deepcopy(standin).cpu()
    caller = bc.Basecaller(standin, 5, chunk_size=CHUNK, overlap=OVERLAP,
                           batch_size=BATCH, output="bases", device=dev)
    caller.basecall_dac_reads(reads)                 # warm-up
    counters = (gru_forward, viterbi_kernel.viterbi_forward,
                viterbi_kernel.viterbi_backtrace)
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = caller.basecall_dac_reads(reads)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [k.launches for k in counters]
    for entry, n in zip(kernels, launches):
        entry["launches"] = n
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
    for name in ("gru_fwd", "viterbi_fwd", "viterbi_back"):
        cuda_build.build(name)
    ptxas = " | ".join(
        "{}: {}".format(n, " ".join(
            l.split(":", 1)[-1].strip() for l in log.splitlines()
            if "registers" in l or "spill" in l))
        for n, (_, log) in sorted(cuda_build.BUILD_LOG.items()))
    print("build: 3 kernels in {:.1f} s ({})".format(time.time() - t0,
                                                      ptxas), flush=True)

    standin = models.pretrained_standin(seed=0).to(dev).eval()
    kernels = [phase_gru(dev, standin)] + phase_viterbi(dev)
    phase_main(dev, standin, kernels)

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
