"""Diagnostic probes of the card, the port's counterparts of the JAX
package's ``scripts/bench_gru_unroll.py``, ``scripts/bench_viterbi_parts.py``
and ``scripts/bench_dma.py``.  Each runs its own CUDA kernel, beside a plain
PyTorch twin::

    python -m sloika_tpu_torch.scripts.bench_gru_unroll [U ...] [--device cuda|cpu]
    python -m sloika_tpu_torch.scripts.bench_viterbi_parts [variant ...] \\
        [--batch B] [--T T] [--device cuda|cpu]
    python -m sloika_tpu_torch.scripts.bench_dma [rows,nslots ...] \\
        [--batch B] [--T T] [--device cuda|cpu]

They run on the card unless given ``--device cpu``, where the twins run
and nothing is timed.
"""
import torch


def cuda_ms(fn, reps, rounds=1):
    """The least over ``rounds`` of the mean milliseconds of ``fn()`` over
    ``reps`` back-to-back runs, by CUDA events, after one warm-up run (the
    probes take the best of 3 rounds, as the JAX scripts do)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / reps)
    return best
