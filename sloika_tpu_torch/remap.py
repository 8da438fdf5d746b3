"""Batched signal remapping against known references on the GPU (cf.
``sloika_tpu/remap.py``).

Reads are sorted by length and cut into batches.  For each batch the model
forward, the ``min_prob`` floor, the log and the one-hot stay padding of
frames past each read's length run on the device, then the banded Viterbi
DP and its traceback (:func:`sloika_tpu_torch.ops.remap_kernel.
map_to_sequence_banded`, two CUDA kernels on the GPU, their plain twins on
the CPU).  The host builds a mapping table of the reference schema
(start/length/seq_pos/move/kmer/good_emission) from each path.

There is one DP contract on every device: the banded kernel, whose window
covers every position (the exact DP) when no band is set or the bucketed
reference fits in it.  Frame and position counts are padded to the JAX
package's geometric buckets, because the bucketed P decides banded or
exact and the bucketed T adds stay frames to the DP: given the same band,
the device never changes a result.
"""
import collections
import sys

import numpy as np
import torch

from sloika_tpu_torch import bio, config, util
from sloika_tpu_torch.basecall import gather_normalise_dac, normalise_dac_f32
from sloika_tpu_torch.data.raw_chunkify import trim_signal_and_mapping
from sloika_tpu_torch.ops import remap_kernel
from sloika_tpu_torch.variables import DEFAULT_ALPHABET

_LOG_ETA = float(np.log(1e-10))

#: a DAC batch's flat int16 sample buffer stays below this many samples
#: (128 MB; sloika_tpu/basecall.py:34): a larger batch is split in halves
_MAX_GROUP_SAMPLES = 1 << 26


def _round_up(n, k):
    """(copied from sloika_tpu/basecall.py:72)"""
    return ((n + k - 1) // k) * k


def bucket_length(n, min_len=2048, factor=1.5):
    """Smallest geometric bucket >= n (copied from
    sloika_tpu/basecall.py:76)."""
    b = min_len
    while b < n:
        b = int(np.ceil(b * factor))
    return b


class Remapper(object):
    """Batched remapper for a transducer model.

    :param layer: the network (a :class:`sloika_tpu_torch.nn.Layer`); it is
        moved to ``device`` in place
    :param kmer_len: kmer length of the model state space
    :param min_prob: posterior floor before the DP
    :param slip: slip penalty (log space, >= 0)
    :param prior: (initial, final) geometric prior means (None = flat)
    :param band: window width in sequence positions; None = exact DP.
        "auto" is 768 on CUDA (after block quantisation the guaranteed band
        is 768 - 256 = 512) and exact on the CPU, as the JAX package
        chooses for the TPU and elsewhere.  A bucketed reference no longer
        than the band always runs exact.
    :param device: torch device; "cuda" raises when no GPU is present
    """

    def __init__(self, layer, kmer_len, min_prob=1e-5, slip=5.0,
                 prior=(25.0, 25.0), alphabet=DEFAULT_ALPHABET, batch_size=4,
                 band="auto", device="cuda"):
        self.device = config.resolve_device(device)
        config.disable_tf32()
        self.layer = layer.to(self.device).eval()
        self.kmer_len = kmer_len
        self.min_prob = min_prob
        self.slip = slip
        self.prior = prior
        self.alphabet = alphabet
        self.batch_size = batch_size
        if band == "auto":
            band = 768 if self.device.type == "cuda" else None
        self.band = band
        #: counted across calls: reads re-run after an anchor miss, by the
        #: band of the re-run (None: exact), and DP batches by window width
        self.reruns = collections.Counter()
        self.windows = collections.Counter()
        #: re-run reads whose banded path misses a sequence end with wider
        #: bands, then exact (sloika_tpu/remap.py:56-58)
        self.fallback = True
        #: batch shapes (:meth:`_oom_key`) known to exhaust device memory:
        #: later batches of such a shape go straight to halves
        self._oom_sizes = set()

    def remap_signals(self, signals, references):
        """Remap normalised signals against reference sequences.

        :param signals: list of (T,) normalised float arrays
        :param references: list of bytes sequences
        :returns: list of (score, mapping_table, path, seq) per read
        """
        return self._remap(signals, references, dac=False)

    def remap_dac_signals(self, reads, references):
        """Remap raw int16 DAC reads (:func:`sloika_tpu_torch.basecall.
        load_raw_dac` tuples): the window gather and the normalisation run
        on the device with the host's float32 order, so the results equal
        :meth:`remap_signals` fed the same normalised signals.

        :param reads: list of (dac (L,) int16, (offset, scale, med, mad))
        """
        return self._remap(list(reads), references, dac=True)

    @staticmethod
    def _sig_len(s, dac):
        return len(s[0]) if dac else len(s)

    def _remap(self, signals, references, dac):
        if len(signals) != len(references):
            raise ValueError("{} signals but {} references".format(
                len(signals), len(references)))
        out = [None] * len(signals)
        order = np.argsort([self._sig_len(s, dac) for s in signals])
        # one batch in flight: batch g+1 is queued on the device before
        # batch g's results are pulled, so the host builds batch g's
        # mapping tables while the device runs batch g+1
        pending = []
        for lo in range(0, len(order), self.batch_size):
            idx = order[lo:lo + self.batch_size]
            self._dispatch_batch_safe([signals[i] for i in idx],
                                      [references[i] for i in idx], idx,
                                      self.band, dac, pending)
            while len(pending) > 1:
                self._collect_batch(pending.pop(0), out)
        while pending:
            self._collect_batch(pending.pop(0), out)
        # Anchor check (sloika_tpu/remap.py:275-300): a banded path is
        # exact only where the band covers the true path, so a path that
        # misses a sequence end by more than band/2 is re-run with a 4x
        # band, then exact
        band = self.band
        while band is not None and self.fallback:
            tol = band // 2
            retry = [i for i, o in enumerate(out)
                     if o is not None and len(o[3]) > band
                     and (o[2].min() > tol or
                          o[2].max() < len(o[3]) - 1 - tol)]
            if not retry:
                break
            band = band * 4 if band * 4 < max(
                len(out[i][3]) for i in retry) else None
            self.reruns[band] += len(retry)
            for lo in range(0, len(retry), self.batch_size):
                idx = retry[lo:lo + self.batch_size]
                self._run_batch_safe([signals[i] for i in idx],
                                     [references[i] for i in idx], idx, out,
                                     band, dac)
        return out

    def _oom_key(self, sigs, refs, band, dac):
        """The shape a batch runs at, for the memory-exhaustion memo
        (copied from sloika_tpu/remap.py:240): (batch, bucketed frames,
        bucketed positions, band, wire), so an OOM on long reads does not
        demote short-read batches of the same size."""
        return (len(sigs),
                bucket_length(max(self._sig_len(s, dac) for s in sigs)),
                bucket_length(max(len(r) for r in refs) - self.kmer_len + 1,
                              min_len=256),
                band, dac)

    def _run_batch_safe(self, sigs, refs, idx, out, band, dac):
        """Dispatch and collect one batch under the guards (the anchor-miss
        re-runs; sloika_tpu/remap.py:303)."""
        self._submit_safe(
            sigs, refs, idx, band, dac,
            lambda s, r, i: self._collect_batch(
                self._dispatch_batch(s, r, i, band, dac), out))

    def _dispatch_batch_safe(self, sigs, refs, idx, band, dac, pending):
        """Dispatch one batch under the guards, its record appended to
        ``pending`` (sloika_tpu/remap.py:312)."""
        self._submit_safe(
            sigs, refs, idx, band, dac,
            lambda s, r, i: pending.append(
                self._dispatch_batch(s, r, i, band, dac)))

    def _submit_safe(self, sigs, refs, idx, band, dac, submit):
        """``submit(sigs, refs, idx)`` under the batch guards
        (sloika_tpu/remap.py:321-368): a DAC batch whose flat sample buffer
        would pass ``_MAX_GROUP_SAMPLES`` is split in halves; a single DAC
        read needing more than 2^30 samples of buffer is refused; and a
        batch that exhausts device memory (``torch.OutOfMemoryError``) is
        retried as two halves, after the allocator's cache is emptied, its
        shape remembered so that later batches of that shape go straight
        to halves.  Any other exception is raised."""
        if dac and len(sigs) > 1:
            T = bucket_length(max(self._sig_len(s, True) for s in sigs))
            total = sum(self._sig_len(s, True) for s in sigs)
            if bucket_length(total + T, min_len=1 << 18) > \
                    _MAX_GROUP_SAMPLES:
                h = len(sigs) // 2
                self._submit_safe(sigs[:h], refs[:h], idx[:h], band, dac,
                                  submit)
                self._submit_safe(sigs[h:], refs[h:], idx[h:], band, dac,
                                  submit)
                return
        if dac and len(sigs) == 1:
            L = self._sig_len(sigs[0], True)
            if bucket_length(L + bucket_length(L),
                             min_len=1 << 18) > 2 ** 30:
                raise ValueError(
                    "single remap read of {} samples needs a >2 GB device "
                    "buffer; split the read or use remap_signals".format(L))
        key = self._oom_key(sigs, refs, band, dac)
        if key not in self._oom_sizes:
            try:
                return submit(sigs, refs, idx)
            except torch.OutOfMemoryError:
                if len(sigs) <= 1:
                    raise
                self._oom_sizes.add(key)
            # out of the handler, so its traceback's tensors are freed
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            sys.stderr.write("Remap batch of {} exceeds device memory; "
                             "retrying as two halves\n".format(len(sigs)))
        h = len(sigs) // 2
        self._submit_safe(sigs[:h], refs[:h], idx[:h], band, dac, submit)
        self._submit_safe(sigs[h:], refs[h:], idx[h:], band, dac, submit)

    def _dispatch_batch(self, sigs, refs, idx, band, dac):
        """Queue one batch on the device; returns its record with device
        tensors that :meth:`_collect_batch` pulls."""
        B = len(sigs)
        lengths = np.array([self._sig_len(s, dac) for s in sigs], np.int64)
        T = bucket_length(int(lengths.max()))
        seqs = [bio.kmer_state_array(r, self.kmer_len, self.alphabet) + 1
                for r in refs]
        npos_max = max(len(s) for s in seqs)
        P = bucket_length(npos_max, min_len=256)
        W = band
        if band is None or P <= band:
            # the window holds every position: the exact DP
            W = max(256, _round_up(P, 128))
            if W > remap_kernel.WIDE_MAX_W:
                raise ValueError(
                    "the exact remap of a reference of {} k-mers needs a "
                    "window of {} positions (P bucketed to {}), past {}, "
                    "the widest whose slips the int16 traceback "
                    "holds".format(npos_max, W, P, remap_kernel.WIDE_MAX_W))
        seq_states = np.zeros((B, P), dtype=np.int32)
        pos_mask = np.zeros((B, P), dtype=bool)
        p0 = np.zeros((B, P), dtype=np.float32)
        p1 = np.zeros((B, P), dtype=np.float32)
        for b, s in enumerate(seqs):
            n = len(s)
            seq_states[b, :n] = s
            pos_mask[b, :n] = True
            if self.prior[0] is not None:
                p0[b, :n] = util.geometric_prior(n, self.prior[0])
            if self.prior[1] is not None:
                p1[b, :n] = util.geometric_prior(n, self.prior[1], rev=True)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        with torch.inference_mode():
            if dac:
                # only real samples cross to the device, plus T zeros of
                # margin for the last read's window
                offsets = np.zeros(B, np.int64)
                offsets[1:] = np.cumsum(lengths)[:-1]
                flat = np.zeros(int(lengths.sum()) + T, np.int16)
                for b, (d, _) in enumerate(sigs):
                    flat[offsets[b]:offsets[b] + len(d)] = d
                norms = np.array([n4 for _, n4 in sigs],
                                 np.float32).reshape(B, 4)
                x = gather_normalise_dac(dev(flat), dev(offsets),
                                         dev(lengths), dev(norms), T)
            else:
                nfeat = 1 if sigs[0].ndim == 1 else sigs[0].shape[1]
                xh = np.zeros((T, B, nfeat), dtype=config.sloika_dtype)
                for b, s in enumerate(sigs):
                    xh[:len(s), b] = s.reshape(len(s), nfeat)
                x = dev(xh)
            out_lengths, score, path = self._device_dp(
                x, dev(lengths), dev(seq_states), dev(pos_mask), dev(p0),
                dev(p1), W)
        return {"sigs": sigs, "refs": refs, "idx": idx, "seqs": seqs,
                "dac": dac, "out_lengths": out_lengths, "score": score,
                "path": path}

    def _device_dp(self, x, lengths, seq_states, pos_mask, p0, p1, W):
        """Forward, floor, log, stay padding and the DP at a window of W
        positions (sloika_tpu/remap.py:115-178, its on-TPU branch).

        :returns: (out_lengths (B,), score (B,), path (B, T') int32)
        """
        post, out_lengths = self.layer.apply_with_lengths(x, lengths)
        # floor and log in place: the (T', B, nstate) posterior is the
        # path's largest tensor (9.3 GB at 64 reads of 177,147 samples),
        # and a copy would double it
        post.mul_(1.0 - self.min_prob).add_(self.min_prob).log_()
        T = post.shape[0]
        pad = (torch.arange(T, device=post.device)[:, None]
               >= out_lengths[None, :])
        stay = torch.full((post.shape[2],), _LOG_ETA, dtype=post.dtype,
                          device=post.device)
        stay[0] = 0.0
        post[pad] = stay                  # one-hot stays in log space
        self.windows[W] += 1
        npos = pos_mask.sum(dim=1).to(torch.int32)
        score, path = remap_kernel.map_to_sequence_banded(
            post, seq_states, self.slip, p0, p1, pos_mask, out_lengths, npos,
            W)
        return out_lengths, score, path

    def _collect_batch(self, rec, out):
        """Pull a dispatched batch's results and build its mapping tables."""
        out_lengths = rec["out_lengths"].cpu().numpy()
        score = rec["score"].cpu().numpy()
        path = rec["path"].cpu().numpy().astype(np.int64)
        for b, i in enumerate(rec["idx"]):
            nev = int(out_lengths[b])
            if rec["dac"]:
                # the mapping table needs only the signal's length
                d, norm4 = rec["sigs"][b]
                sig_b = normalise_dac_f32(d, norm4)
            else:
                sig_b = rec["sigs"][b]
            out[i] = build_mapping_table(
                float(score[b]), path[b, :nev], rec["seqs"][b], sig_b,
                self.kmer_len, rec["refs"][b], alphabet=self.alphabet)


def build_mapping_table(score, path, seq, signal, kmer_len, read_ref,
                        alphabet=DEFAULT_ALPHABET):
    """A reference-schema mapping table from a remap path (copied from
    sloika_tpu/remap.py:491)."""
    kmers = np.array(bio.seq_to_kmers(read_ref, kmer_len))
    mapping_dtype = [
        ('start', '<i8'), ('length', '<i8'), ('seq_pos', '<i8'),
        ('move', '<i8'), ('kmer', 'S{}'.format(kmer_len)),
        ('good_emission', '?'),
    ]
    nev = len(path)
    mapping_table = np.zeros(nev, dtype=mapping_dtype)
    stride = int(np.ceil(signal.shape[0] / float(nev)))
    mapping_table['start'] = (np.arange(0, nev, dtype=np.int64) * stride
                              - stride // 2)
    mapping_table['length'] = stride
    mapping_table['seq_pos'] = path
    mapping_table['move'] = np.ediff1d(path, to_begin=1)
    mapping_table['kmer'] = kmers[path]
    mapping_table['good_emission'] = True

    _, mapping_table = trim_signal_and_mapping(signal, mapping_table, 0,
                                               len(signal))
    return score, mapping_table, np.asarray(path), seq
