"""The CTC-CRF decode of bonito's CRF basecallers on the GPU
(``csrc/crf_decode.cu``), its plain PyTorch twin, and the collapse of its
labels to the basecaller's packed base codes.

It replaces no Pallas kernel: the JAX package has no CRF model.  bonito
decodes a CRF model's scores with seqdist's ``CTC_CRF``: the transition
posteriors by forward-backward, then a Viterbi over their logs plus 1e-8;
``path_to_str`` emits base k - 1 of ACGT for each frame whose best
transition k is not the stay.  ``csrc/crf_decode.cu`` says what each
quantity is and how the kernels compute it; :func:`crf_decode_plain` is
the same arithmetic as a loop over frames, which the CPU runs.

:data:`crf_decode` dispatches on the device of its input: the kernels for a
CUDA tensor, :func:`crf_decode_plain` for a CPU tensor.  ``launches``
counts calls, each of which launches ``crf_beta_kernel`` and
``crf_forward_kernel`` once.
"""
import ctypes

import torch

from sloika_tpu_torch import cuda_build

#: added to a transition's posterior before its log (seqdist's viterbi
#: of bonito's ``decode_batch``)
EPS = 1e-8
#: the kernels' state counts, 4^state_len for state_len 1..4
KERNEL_STATES = (4, 16, 64, 256)


def crf_idx(nstate, device=None):
    """(nstate, 5) int64: ``idx[s, 0] = s`` (the stay), and for k = 1..4
    ``idx[s, k] = (k - 1) nstate/4 + s // 4``, the state whose low digits
    are s's high ones (seqdist's ``CTC_CRF.idx``)."""
    s = torch.arange(nstate, device=device)
    k = torch.arange(4, device=device)
    moves = k[None, :] * (nstate // 4) + (s // 4)[:, None]
    return torch.cat([s[:, None], moves], dim=1)


def _check_scores(scores):
    T, B, C = scores.shape
    N = C // 5
    if C % 5 or N < 4 or N & (N - 1) or N.bit_length() % 2 == 0:
        raise ValueError("CRF scores need 5 x 4^state_len columns a frame, "
                         "got {}".format(C))
    return T, B, N


def crf_decode_plain(scores, lengths):
    """The plain twin of ``csrc/crf_decode.cu``: loops over frames of
    eager torch ops, the batch's rows side by side.

    :param scores: (T, B, 5N) float32 transition scores
    :param lengths: (B,) valid frames a row
    :returns: (score (B,) float32, labels (B, T) uint8)
    """
    T, B, N = _check_scores(scores)
    dev = scores.device
    M = scores.reshape(T, B, N, 5)
    idx = crf_idx(N, dev)
    n = lengths.to(dev).clamp(max=T)
    rows = torch.arange(B, device=dev)

    # b_t+1 relative to its state 0, frame by frame from each row's end
    beta = scores.new_zeros((T, B, N))
    braw = scores.new_zeros((B, N))
    for t in range(T - 1, -1, -1):
        valid = (t < n)[:, None]
        bhat = braw - braw[:, :1]
        beta[t] = bhat
        x = M[t] + bhat[:, :, None]                       # (B, s, k)
        # into j: its stay, and the steps from states 4 (j % Q) + r by
        # transition j // Q + 1
        moves = x[:, :, 1:].reshape(B, N // 4, 4, 4).permute(0, 3, 1, 2)
        into = torch.cat([x[:, :, :1], moves.reshape(B, N, 4)], dim=2)
        braw = torch.where(valid, torch.logsumexp(into, dim=2), braw)

    araw = scores.new_zeros((B, N))
    vraw = scores.new_zeros((B, N))
    off = torch.zeros(B, dtype=torch.float64, device=dev)
    bp = torch.zeros((T, B, N), dtype=torch.uint8, device=dev)
    for t in range(T):
        valid = t < n
        off += torch.where(valid, vraw[:, 0].double(), 0.0)
        ahat = araw - araw[:, :1]
        vhat = vraw - vraw[:, :1]
        e = ahat[:, idx] + M[t]                           # (B, s, k)
        z = e + beta[t][:, :, None]
        logz = torch.logsumexp(z.reshape(B, -1), dim=1)
        lp = torch.log(torch.exp(z - logz[:, None, None]) + EPS)
        cand = vhat[:, idx] + lp
        k = torch.argmax(cand, dim=2)                     # the first max
        best = torch.gather(cand, 2, k[:, :, None])[:, :, 0]
        araw = torch.where(valid[:, None], torch.logsumexp(e, dim=2), araw)
        vraw = torch.where(valid[:, None], best, vraw)
        bp[t] = k.to(torch.uint8)

    s = torch.argmax(vraw, dim=1)
    vbest = vraw[rows, s]
    score = torch.where(n > 0, (off + vbest.double()).float(), 0.0)
    labels = torch.zeros((B, T), dtype=torch.uint8, device=dev)
    for t in range(T - 1, -1, -1):
        valid = t < n
        k = bp[t, rows, s].long()
        labels[:, t] = torch.where(valid, k, 0).to(torch.uint8)
        prev = torch.where(k == 0, s, (k - 1) * (N // 4) + s // 4)
        s = torch.where(valid, prev, s)
    return score, labels


class CrfDecode:
    """The CRF decode: ``csrc/crf_decode.cu`` for CUDA tensors,
    :func:`crf_decode_plain` for CPU tensors.  ``launches`` counts kernel
    calls (each launches both kernels once)."""

    _ARGTYPES = {"crf_decode": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def __call__(self, scores, lengths):
        """:param scores: (T, B, 5N) float32, N = 4^state_len
        :param lengths: (B,) valid frames a row
        :returns: (score (B,) float32, labels (B, T) uint8)
        """
        if scores.device.type == "cpu":
            return crf_decode_plain(scores, lengths)
        T, B, N = _check_scores(scores)
        dev = scores.device
        if N not in KERNEL_STATES:
            raise ValueError("the CRF kernels take 4 to 256 states, got "
                             "{}".format(N))
        cuda_build.check_tensor(scores, (T, B, 5 * N), torch.float32, dev,
                                "scores")
        if tuple(lengths.shape) != (B,):
            raise ValueError("lengths must be ({},)".format(B))
        score = torch.empty(B, dtype=torch.float32, device=dev)
        labels = torch.empty((B, T), dtype=torch.uint8, device=dev)
        if T == 0 or B == 0:
            return score.zero_(), labels
        lengths32 = lengths.to(device=dev, dtype=torch.int32).contiguous()
        beta = torch.empty((T, B, N), dtype=torch.float32, device=dev)
        bp = torch.empty((T, B, N), dtype=torch.uint8, device=dev)
        lib = cuda_build.load("crf_decode", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.crf_decode(scores.data_ptr(), lengths32.data_ptr(),
                                 beta.data_ptr(), bp.data_ptr(),
                                 score.data_ptr(), labels.data_ptr(), T, B,
                                 N, torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "crf_decode")
        self.launches += 1
        return score, labels


#: the CRF decode entry point (kernels on CUDA, plain twin on the CPU)
crf_decode = CrfDecode()


def label_records(labels, f_splits):
    """The basecaller's records of a batch's CRF labels, as
    ``basecall._move_records`` gives them for a transducer's path: a frame
    whose label k is not 0 emits base code k - 1; the codes compacted to
    the front in frame order and packed four a byte, the first in the high
    bits.

    :param labels: (B, T') uint8, 0 past each row's frames
    :param f_splits: two frame indices (the seams); counts give the bases
        emitted before each, plus the total
    :returns: (first (B,) int16 zeros: a CRF call has no opening kmer,
        counts (B, 3) int32, packed (B, ceil(T'/4)) uint8)
    """
    B, Tp = labels.shape
    emit = labels > 0
    cum = torch.cumsum(emit.to(torch.int32), dim=1, dtype=torch.int32)
    counts = torch.stack([cum[:, min(f_splits[0], Tp) - 1],
                          cum[:, min(f_splits[1], Tp) - 1],
                          cum[:, -1]], dim=1)
    # each emitted code to its place; the rest to a slot past the end
    pos = torch.where(emit, cum.long() - 1, Tp)
    codes = labels.new_zeros((B, Tp + 1)).scatter_(
        1, pos, torch.where(emit, labels - 1, 0))[:, :Tp]
    pad = (-Tp) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros((B, pad))], dim=1)
    c = codes.reshape(B, -1, 4)
    packed = ((c[:, :, 0] << 6) | (c[:, :, 1] << 4)
              | (c[:, :, 2] << 2) | c[:, :, 3])
    first = torch.zeros(B, dtype=torch.int16, device=labels.device)
    return first, counts, packed
