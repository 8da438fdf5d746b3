"""Time the GRU kernels on the card at the main paths' shapes::

    python -m sloika_tpu_torch.scripts.bench_gru [shape ...]

The shapes (T, B, S): ``train`` (400, 100, 96), raw_0.98_rgrgr's training
batch; ``basecall112`` and ``basecall144`` (3277, 64, 112/144), a batch of
16,384-sample windows through the stand-in's GRU layers; ``production``
(3277, 1024, 144), ``bench.py``'s batch of 1,024 windows; ``remap``
(35429, 64, 144), the remap path's longest bucket.  Lengths are ragged
(T/2 to T, the first row T long), the inputs drawn on the card from a
seed.  At ``train`` it also times the forward's training variant (which
writes the gate trace), ``gru_bwd`` (the backward recurrence, from that
trace) and ``gru_wgrad`` beside the einsum pair of its twin.  Times are
the best of 3 rounds of back-to-back calls by CUDA events.

Another tree's kernels, e.g. a parent commit unpacked with ``git
archive``, are timed by that tree's own copy of this script::

    PYTHONPATH=<tree> python <tree>/sloika_tpu_torch/scripts/bench_gru.py

Prints one JSON line: the card and its power limit, the tree timed, and
the times.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

SHAPES = {"train": (400, 100, 96), "basecall112": (3277, 64, 112),
          "basecall144": (3277, 64, 144), "production": (3277, 1024, 144),
          "remap": (35429, 64, 144)}


def inputs(T, B, S, dev, seed=0):
    """xp (T, B, 3S), sWT, sW2T at 1/sqrt(2S), and a ragged (T, B) mask."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xp = torch.randn((T, B, 3 * S), generator=gen, device=dev)
    sWT = torch.randn((S, 2 * S), generator=gen, device=dev) / np.sqrt(2 * S)
    sW2T = torch.randn((S, S), generator=gen, device=dev) / np.sqrt(2 * S)
    lengths = np.random.RandomState(seed).randint(T // 2, T + 1, size=B)
    lengths[0] = T
    mask = torch.from_numpy(np.arange(T)[:, None] < lengths[None, :]).to(dev)
    return xp, sWT, sW2T, mask


def main(argv=None):
    names = (argv if argv is not None else sys.argv[1:]) or list(SHAPES)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_gru needs a CUDA device")
    import sloika_tpu_torch
    from sloika_tpu_torch import config
    from sloika_tpu_torch.nn.fused_gru import (gru_backward, gru_forward,
                                               gru_wgrad, gru_wgrad_plain)
    from sloika_tpu_torch.scripts import cuda_ms
    config.disable_tf32()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    result = {"card": card, "tree": os.path.dirname(os.path.dirname(
        os.path.abspath(sloika_tpu_torch.__file__))), "gru_fwd": {}}
    for name in names:
        T, B, S = SHAPES[name]
        xp, sWT, sW2T, mask = inputs(T, B, S, dev)
        ms = cuda_ms(lambda: gru_forward(xp, sWT, sW2T, mask=mask), 3, 3)
        result["gru_fwd"][name] = {"T": T, "B": B, "S": S, "ms": ms,
                                   "us_per_step": 1e3 * ms / T}
        del xp
        torch.cuda.empty_cache()
    T, B, S = SHAPES["train"]
    xp, sWT, sW2T, mask = inputs(T, B, S, dev, seed=1)
    g = torch.randn((T, B, S), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    train = lambda: gru_forward(xp, sWT, sW2T, mask=mask, emit_gates=True)
    h_out, gates = train()
    result["gru_fwd_train"] = {"T": T, "B": B, "S": S,
                               "ms": cuda_ms(train, 3, 3)}
    ms = cuda_ms(lambda: gru_backward.recurrence(gates, sWT, sW2T, mask,
                                                 False, g, h_out), 3, 3)
    result["gru_bwd"] = {"T": T, "B": B, "S": S, "ms": ms,
                         "us_per_step": 1e3 * ms / T}
    gen = torch.Generator(device=dev).manual_seed(2)
    rh = torch.randn((T, B, S), generator=gen, device=dev)
    dxp = torch.randn((T, B, 3 * S), generator=gen, device=dev) \
        * mask[:, :, None]
    result["gru_wgrad"] = {
        "T": T, "B": B, "S": S,
        "ms": cuda_ms(lambda: gru_wgrad(h_out, rh, dxp, False), 20, 3),
        "einsum_ms": cuda_ms(lambda: gru_wgrad_plain(h_out, rh, dxp, False),
                             20, 3)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
