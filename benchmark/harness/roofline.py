"""The benchmark's yardstick for rooflines and model FLOPs: the card's
peaks, the least time of a kernel's work, and the operations and bytes
each kernel of the measured paths must do, counted from the model's widths
and the traffic.

Frozen copies (the program may change; these may not):
``chip_smoke.py:482-489`` (:func:`bound`), ``chip_smoke.py:565-567``
(:func:`gru_fwd_bound`), ``chip_smoke.py:901-912`` (the two Viterbi
bounds), ``chip_smoke.py:1397-1402`` (:func:`remap_bytes`), and the
counting rule of ``sloika_tpu_torch/nn/flops.py:20-78``
(:func:`flops_per_sample`, each layer kind's ``flops``).
"""

from benchmark.reference.layers import kind

#: NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores,
#: and HBM3 bandwidth.  Every cell runs float32 with TF32 off.
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound(nbytes, nflop):
    """The least seconds the card could take to move ``nbytes`` and do
    ``nflop`` float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, nflop / F32_FLOP_PER_S)


def gru_fwd_bound(steps, S):
    """gru_fwd's (bytes, flop) over ``steps`` valid steps of a row: xp (3S)
    read and h (S) written a step, the weights (3 S^2) read once; the
    products with sW (S x 2S) and sW2 (S x S), 6 S^2 a step."""
    return 4 * (4 * S * steps + 3 * S * S), 6 * S * S * steps


def gru_train_bounds(steps, S):
    """The (bytes, flop) of each of the training step's three GRU kernels
    over ``steps`` valid steps of a row: the training forward also writes
    the gate trace (3S a step); the backward reads the gates, h and the
    output cotangent and writes dxp and r*h (9S a step,
    ``PERF.md`` row 4), 6 S^2 a step; the weight cotangents read h, r*h
    and dxp (5S a step), write the three weight blocks, 6 S^2 a step."""
    fwd = (4 * (7 * S * steps + 3 * S * S), 6 * S * S * steps)
    bwd = (4 * (9 * S * steps + 3 * S * S), 6 * S * S * steps)
    wgrad = (4 * (5 * S * steps + 3 * S * S), 6 * S * S * steps)
    return fwd, bwd, wgrad


def viterbi_fwd_bound(T, B, K=1024, esize=4):
    """viterbi_fwd's (bytes, ops) at (T, B): the posterior read once, the
    codes written once, the final scores written."""
    return (T * B * (K + 1) * esize + T * B * K + B * K * 4,
            42 * T * B * K)


def viterbi_back_bound(T, B):
    """viterbi_back's (bytes, ops) at (T, B): a code read, a state and a
    move written, a step."""
    return T * B * (1 + 4 + 1) + B * 4, 3 * T * B


def output_head_bound(frames, I, K):
    """output_head's (bytes, flop) over ``frames`` valid frames: the float32
    posterior (K states a frame) written once; the projection from I
    features, 2·I·K a frame."""
    return 4 * frames * K, 2 * I * K * frames


def remap_bytes(T, Tp, B, W, P):
    """Bytes the banded remap DP must move: the posterior read once, its
    sequences, masks, priors and schedule, the int16 traceback and final
    scores written once."""
    return T * B * 1025 * 4 + B * P * 9 + Tp * B * 4 + Tp * B * W * 2 \
        + B * W * 4


def flops_per_sample(layers):
    """Forward FLOPs a signal sample of a configuration's network: each
    layer's FLOPs a frame at its input rate (its kind's ``flops``, by the
    dense-weight rule of ``benchmark/reference/layers``), a strided layer's
    successors running at its output rate."""
    total, rate = 0.0, 1.0
    for spec in layers:
        k = kind(spec["type"])
        total += rate * k.flops(spec)
        rate /= k.stride(spec)
    return total
