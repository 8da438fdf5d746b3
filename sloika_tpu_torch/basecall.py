"""Basecalling on the GPU (cf. ``sloika_tpu/basecall.py``).

Two modes are ported.  ``output="bases"`` is the transfer-lean chunked
transducer path: reads are cut into overlapping windows (C samples,
``overlap`` on each side), windows run through the forward pass in device
batches, the posterior gets the ``min_prob`` floor with padded frames turned
into one-hot stays, a transducer Viterbi decodes it, and the path collapses
on the device to packed 2-bit base codes; the host stitches the windows at
their seams.  From raw int16 DAC samples (:meth:`Basecaller.
basecall_dac_reads`) the windowing and the exact float32 normalisation
``((dac + offset) * scale - med) / mad`` run on the device too.

``output="states"``, the default, is the JAX package's default,
non-chunked mode (``chunked=False``): whole reads, sorted by length, run in
batches; each read's Viterbi path is cut at its own frame count and
collapsed on the host to the kmer states entered by a move
(:meth:`Basecaller.basecall_signals`, :meth:`SeqPrinter.write`), from raw
reads normalised on the host (:func:`load_raw_signal`) or event features
(:func:`load_event_features`).

PyTorch runs eagerly, so there is no compile cache and no batch or length
bucketing: each batch runs at its own size.  Host <-> device copies are
plain ``.to(device)``.

The host helpers are copied from ``sloika_tpu/basecall.py`` (their source
lines are given), because that module imports jax.
"""
import os
import sys

import numpy as np
import torch

from sloika_tpu_torch import bio, config, maths, nn, util
from sloika_tpu_torch.data import features, fast5
from sloika_tpu_torch.data.batching import (normalise_raw_signal,
                                            trim_open_pore)
from sloika_tpu_torch.variables import DEFAULT_ALPHABET, nstate
from sloika_tpu_torch.ops import viterbi_kernel
from sloika_tpu_torch.ops.decode import collapse_path

#: reads are packed into groups of about this many samples; one group is
#: one flat int16 buffer on the device (32 MB)
_GROUP_SAMPLES = 1 << 24


def _infer_stride(layer):
    """Total temporal downsampling factor of a layer graph."""
    if isinstance(layer, nn.Serial):
        s = 1
        for l in layer.layers:
            s *= _infer_stride(l)
        return s
    if isinstance(layer, nn.Convolution):
        return layer.stride
    if isinstance(layer, nn.Reverse):
        return _infer_stride(layer.layer)
    return 1


def _window_jobs(read_lens, chunk_size, overlap):
    """The chunked-mode window split (copied from sloika_tpu/basecall.py:85):
    window ``w`` of read ``r`` covers samples ``[w*core, w*core + C)`` with
    ``core = C - 2*overlap``.

    :returns: list of (read, window, start, length, nwin_of_read)
    """
    C, V = chunk_size, overlap
    core = C - 2 * V
    if core <= 0:
        raise ValueError("chunk_size must exceed 2*overlap")
    jobs = []
    for r, L in enumerate(read_lens):
        nwin = max(1, -(-max(L - 2 * V, 1) // core))
        for w in range(nwin):
            start = w * core
            jobs.append((r, w, start, min(C, L - start), nwin))
    return jobs


class Basecaller(object):
    """Batched chunked basecaller for a transducer model.

    :param layer: the network (a :class:`sloika_tpu_torch.nn.Layer`) over
        the 4-letter alphabet; it is moved to ``device`` in place
    :param kmer_len: kmer length of the output state space
    :param min_prob: posterior probability floor
    :param skip: transducer skip penalty
    :param batch_size: windows decoded per device batch
    :param chunk_size, overlap: window length and seam overlap (samples)
    :param output: "states" (whole reads, kmer-state calls; the JAX
        package's default) or "bases" (chunked, packed 2-bit base codes)
    :param device: torch device; "cuda" raises when no GPU is present
    """

    def __init__(self, layer, kmer_len, min_prob=1e-5, skip=5.0,
                 batch_size=8, chunk_size=8192, overlap=400, output="states",
                 device="cuda"):
        if output not in ("bases", "states"):
            raise NotImplementedError(
                "output must be 'bases' (chunked) or 'states' (whole reads)")
        expected = nstate(kmer_len, transducer=True, bad_state=False)
        if layer.size != expected:
            raise ValueError("model emits {} states, decode expects {}".format(
                layer.size, expected))
        self.device = config.resolve_device(device)
        config.disable_tf32()
        self.layer = layer.to(self.device).eval()
        self.kmer_len = kmer_len
        self.min_prob = min_prob
        self.skip = skip
        self.batch_size = batch_size
        self.chunk_size = chunk_size
        self.overlap = overlap
        if chunk_size <= 2 * overlap:
            raise ValueError("chunk_size must exceed 2*overlap")
        self.model_stride = _infer_stride(layer)
        self.output = output
        #: the two seam frames of a window (move-record count boundaries)
        self._f_splits = (overlap // self.model_stride,
                          (chunk_size - overlap) // self.model_stride)

    # -- device programs -------------------------------------------------

    def _floored_masked_post(self, x, lengths):
        """Forward pass + min_prob floor + pad-frame masking
        (sloika_tpu/basecall.py:274-289)."""
        post, out_lengths = self.layer.apply_with_lengths(x, lengths)
        post = self.min_prob + (1.0 - self.min_prob) * post
        T = post.shape[0]
        frame_mask = (torch.arange(T, device=post.device)[:, None]
                      < out_lengths[None, :])
        stay = torch.zeros(post.shape[2], dtype=post.dtype,
                           device=post.device)
        stay[0] = 1.0
        post = torch.where(frame_mask[:, :, None], post, stay)
        return post.contiguous(), out_lengths

    def _forward_decode(self, x, lengths):
        """Posterior + Viterbi + collapse of one window batch.

        :param x: (C, B, nfeature) float32 windows;  :param lengths: (B,)
        :returns: (score (B,), first (B,) int16, counts (B, 3) int32,
            packed codes (B, ceil(2T'/4)) uint8) device tensors
        """
        post, _ = self._floored_masked_post(x, lengths)
        score, path, moved = viterbi_kernel.viterbi(
            post, self.kmer_len, skip_pen=self.skip)
        return (score,) + _move_records(path, moved, self.kmer_len,
                                        self._f_splits)

    def _forward_decode_dac(self, flat, starts, lengths, norms):
        """The DAC program (sloika_tpu/basecall.py:360-383): window gather
        from the flat int16 buffer, exact float32 normalisation, then
        :meth:`_forward_decode`.

        :param flat: (S,) int16, zero-padded by >= C past the last read
        :param starts, lengths: (B,) int64;  :param norms: (B, 4) float32
            (offset, scale, med, mad)
        """
        x = gather_normalise_dac(flat, starts, lengths, norms,
                                 self.chunk_size)
        return self._forward_decode(x, lengths)

    def _forward_decode_states(self, x, lengths):
        """Posterior + Viterbi of one batch of whole reads (the transducer
        branch of ``_forward_decode``, sloika_tpu/basecall.py:315-325).

        :returns: (score (B,), frames (B,), path (B, T'), moved (B, T'))
            device tensors
        """
        post, out_lengths = self._floored_masked_post(x, lengths)
        score, path, moved = viterbi_kernel.viterbi(
            post, self.kmer_len, skip_pen=self.skip)
        return score, out_lengths, path, moved

    # -- public API ------------------------------------------------------

    def basecall_signals(self, signals):
        """Basecall a list of normalised 1-D signals (or (T, F) feature
        matrices).

        With ``output="bases"``, chunked (cf. ``_basecall_chunked_bases``,
        sloika_tpu/basecall.py:473); returns (score, base codes) per read.
        With ``output="states"``, whole reads in batches of
        ``batch_size`` in order of length (sloika_tpu/basecall.py:424-443);
        returns (score, kmer-state call) per read.
        """
        if self.output == "states":
            out = [None] * len(signals)
            order = np.argsort([len(s) for s in signals])
            for lo in range(0, len(order), self.batch_size):
                idx = order[lo:lo + self.batch_size]
                self._run_batch([signals[i] for i in idx], idx, out)
            return out
        C = self.chunk_size
        lens = [len(s) for s in signals]
        jobs = _window_jobs(lens, C, self.overlap)
        nfeat = 1 if not signals or signals[0].ndim == 1 \
            else signals[0].shape[1]
        results = {}
        with torch.inference_mode():
            for lo in range(0, len(jobs), self.batch_size):
                batch = jobs[lo:lo + self.batch_size]
                x = np.zeros((C, len(batch), nfeat), dtype=config.sloika_dtype)
                lengths = np.zeros(len(batch), dtype=np.int64)
                for b, (r, _, start, ln, _) in enumerate(batch):
                    x[:ln, b] = signals[r][start:start + ln].reshape(ln, nfeat)
                    lengths[b] = ln
                out = self._forward_decode(
                    torch.from_numpy(x).to(self.device),
                    torch.from_numpy(lengths).to(self.device))
                _collect([(r, w) for r, w, _, _, _ in batch], out, results)
        return self._stitch_bases(results, lens)

    def basecall_dac_reads(self, reads):
        """Basecalling from raw int16 DAC samples (:func:`load_raw_dac`):
        windowing and normalisation run on the device.

        Reads are packed into groups of about ``_GROUP_SAMPLES`` samples;
        each group is shipped once as a flat int16 buffer and its windows
        are gathered from it batch by batch.

        :param reads: list of (dac (T,) int16, (offset, scale, med, mad))
        :returns: list of (score, base codes) per read
        """
        if self.output != "bases":
            # as sloika_tpu/basecall.py:585 asserts
            raise ValueError("DAC mode requires output='bases'")
        C = self.chunk_size
        read_lens = [len(d) for d, _ in reads]
        groups, cur, acc = [], [], 0
        for r, L in enumerate(read_lens):
            if cur and acc + L > _GROUP_SAMPLES:
                groups.append(cur)
                cur, acc = [], 0
            cur.append(r)
            acc += L
        if cur:
            groups.append(cur)

        results = {}
        with torch.inference_mode():
            for group in groups:
                glens = [read_lens[r] for r in group]
                offsets = np.concatenate([[0], np.cumsum(glens)]).astype(
                    np.int64)
                flat = np.zeros(int(offsets[-1]) + C, np.int16)
                for r, o in zip(group, offsets):
                    flat[o:o + read_lens[r]] = reads[r][0]
                flat_d = torch.from_numpy(flat).to(self.device)
                jobs = [(group[gr], w, int(offsets[gr]) + start, ln)
                        for gr, w, start, ln, _ in _window_jobs(
                            glens, C, self.overlap)]
                for lo in range(0, len(jobs), self.batch_size):
                    batch = jobs[lo:lo + self.batch_size]
                    starts = np.array([j[2] for j in batch], np.int64)
                    lengths = np.array([j[3] for j in batch], np.int64)
                    norms = np.array([reads[j[0]][1] for j in batch],
                                     np.float32).reshape(len(batch), 4)
                    out = self._forward_decode_dac(
                        flat_d, torch.from_numpy(starts).to(self.device),
                        torch.from_numpy(lengths).to(self.device),
                        torch.from_numpy(norms).to(self.device))
                    _collect([(r, w) for r, w, _, _ in batch], out, results)
        return self._stitch_bases(results, read_lens)

    def _run_batch(self, sigs, idx, out):
        """One batch of whole reads (sloika_tpu/basecall.py:853-886).  The
        batch runs at its own size and longest length: the JAX package's
        bucketed padding adds frames that are exact one-hot stays, which
        add nothing to the score and leave the path alone."""
        nfeat = 1 if sigs[0].ndim == 1 else sigs[0].shape[1]
        lengths = np.array([len(s) for s in sigs], dtype=np.int64)
        x = np.zeros((int(lengths.max()), len(sigs), nfeat),
                     dtype=config.sloika_dtype)
        for b, s in enumerate(sigs):
            x[:len(s), b] = s.reshape(len(s), nfeat)
        with torch.inference_mode():
            score, frames, path, moved = (o.cpu().numpy() for o in
                                          self._forward_decode_states(
                torch.from_numpy(x).to(self.device),
                torch.from_numpy(lengths).to(self.device)))
        for b, i in enumerate(idx):
            out[i] = (float(score[b]),
                      collapse_path(path[b], moved[b], int(frames[b])))

    def _stitch_bases(self, results, read_lens):
        """Concatenate per-window base emissions at the seam boundaries
        (copied from sloika_tpu/basecall.py:531).

        :param results: {(read, window): (score, first_state, counts, codes)}
        """
        k = self.kmer_len
        out = [None] * len(read_lens)
        parts, total_score = [], 0.0
        for r, w, start, ln, nwin in _window_jobs(read_lens,
                                                  self.chunk_size,
                                                  self.overlap):
            sc, first, counts, recs = results[(r, w)]
            total_score += sc
            lo = 0 if w == 0 else int(counts[0])
            hi = int(counts[2]) if w == nwin - 1 else int(counts[1])
            if w == 0:
                # opening call contributes its full kmer
                parts.append(((first >> (2 * np.arange(k - 1, -1, -1)))
                              & 3).astype(np.uint8))
            parts.append(recs[lo:max(lo, hi)])
            if w == nwin - 1:
                out[r] = (total_score, np.concatenate(parts))
                parts, total_score = [], 0.0
        return out


def gather_normalise_dac(flat, starts, lengths, norms, C):
    """(C, B, 1) float32 windows gathered from a flat int16 sample buffer
    and normalised on its device with the exact float32 order
    ``((dac + offset) * scale - med) / mad``; samples past each window's
    length are 0 (sloika_tpu/basecall.py:360-383, sloika_tpu/remap.py:
    194-207).

    :param flat: (S,) int16, zero-padded by >= C past the last window
    :param starts, lengths: (B,) int64;  :param norms: (B, 4) float32
        (offset, scale, med, mad)
    """
    t = torch.arange(C, device=flat.device)
    v = flat[starts[:, None] + t[None, :]].t().to(torch.float32)  # (C, B)
    off, sc = norms[:, 0][None, :], norms[:, 1][None, :]
    med, mad = norms[:, 2][None, :], norms[:, 3][None, :]
    x = ((v + off) * sc - med) / mad
    x = torch.where(t[:, None] < lengths[None, :], x, 0.0)
    return x[:, :, None]


def _collect(keys, out, results):
    """Pull one batch's outputs to the host into ``results[key]``."""
    score, first, counts, packed = (o.cpu().numpy() for o in out)
    recs = _unpack_codes(packed)
    for b, key in enumerate(keys):
        results[key] = (float(score[b]), int(first[b]), counts[b], recs[b])


def _move_records(path, moved, klen, f_splits):
    """Device-side collapse of a Viterbi path to packed 2-bit base codes
    (sloika_tpu/basecall.py:889-945).

    A move emits one base when the previous kmer matches at shift 1, else
    two (``bio.kmers_to_sequence``'s maximal-overlap rule).  Emitted codes
    are compacted to the front in frame order by one sort on keys packing
    (invalid, slot index, code) — the keys are unique, so any sort gives
    the JAX package's order — and packed four per byte, first code in the
    high bits.

    :param path: (B, T') kmer states;  :param moved: (B, T') move mask
    :param f_splits: two frame indices (the seams); counts give the bases
        emitted before each, plus the total
    :returns: (first_state (B,) int16, counts (B, 3) int32,
        packed (B, ceil(2T'/4)) uint8)
    """
    B, Tp = path.shape
    path = path.to(torch.int32)
    npow = 4 ** (klen - 1)
    prev = torch.cat([path[:, :1], path[:, :-1]], dim=1)
    match1 = (prev % npow) == (path // 4)
    nnew2 = moved & ~match1
    base2 = path % 4
    base1 = (path // 4) % 4

    nb = moved.to(torch.int32) + nnew2.to(torch.int32)
    cum = torch.cumsum(nb, dim=1, dtype=torch.int32)
    counts = torch.stack([cum[:, min(f_splits[0], Tp) - 1],
                          cum[:, min(f_splits[1], Tp) - 1],
                          cum[:, -1]], dim=1)

    slot1 = torch.where(nnew2, base1, 4)
    slot2 = torch.where(moved, base2, 4)
    idx = torch.arange(2 * Tp, dtype=torch.int32, device=path.device)
    pairs = torch.stack([slot1, slot2], dim=2).reshape(B, 2 * Tp)
    keys = (torch.where(pairs == 4, 1 << 29, 0).to(torch.int32)
            | (idx << 3) | pairs)
    skeys = torch.sort(keys, dim=1).values
    codes = torch.where((skeys >> 29) != 0, 0, skeys & 3).to(torch.uint8)

    pad = (-2 * Tp) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros((B, pad))], dim=1)
    c = codes.reshape(B, -1, 4)
    packed = ((c[:, :, 0] << 6) | (c[:, :, 1] << 4)
              | (c[:, :, 2] << 2) | c[:, :, 3])
    return path[:, 0].to(torch.int16), counts, packed


def _unpack_codes(packed):
    """Host-side expansion of packed bytes to 2-bit base codes (copied from
    sloika_tpu/basecall.py:948)."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty(packed.shape + (4,), np.uint8)
    out[..., 0] = packed >> 6
    out[..., 1] = (packed >> 4) & 3
    out[..., 2] = (packed >> 2) & 3
    out[..., 3] = packed & 3
    return out.reshape(packed.shape[:-1] + (-1,))


# ---------------------------------------------------------------------------
# Read loading (host side)
# ---------------------------------------------------------------------------

def scale_dac_f32(dac, offset, scale):
    """pA-scale int16 DAC samples with the device's f32 op order
    ``(dac_f32 + offset) * scale`` (copied from sloika_tpu/basecall.py:1004).
    """
    return (dac.astype(np.float32) + np.float32(offset)) * np.float32(scale)


def normalise_dac_f32(dac, norm4):
    """Host reference of the device-side DAC normalisation
    ``((dac + offset) * scale - med) / mad`` (copied from
    sloika_tpu/basecall.py:1011)."""
    offset, scale, med, mad = (np.float32(v) for v in norm4)
    return (scale_dac_f32(dac, offset, scale) - med) / mad


def load_raw_signal(fast5_file, trim=(200, 50), open_pore_fraction=0.3):
    """Raw read -> normalised signal (copied from sloika_tpu/basecall.py:
    985-1001): pA scale, open-pore trim, edge trim, then per-read
    (median, MAD) normalisation.  h5py is imported by the reader.

    :returns: (short_name, signal (T,) float32) or None
    """
    try:
        signal = fast5.read_raw_signal(fast5_file)
        sn = fast5.filename_short(fast5_file)
    except Exception as e:
        sys.stderr.write("Error getting raw data for file {}\n{!r}\n".format(
            fast5_file, e))
        return None
    start, end = trim_open_pore(signal, open_pore_fraction)
    signal = util.trim_array(signal[start:end], *trim)
    if signal.size == 0:
        sys.stderr.write("Read too short in file {}\n".format(fast5_file))
        return None
    return sn, normalise_raw_signal(signal)


def load_raw_dac(fast5_file, trim=(200, 50), open_pore_fraction=0.3):
    """Raw read -> unscaled int16 DAC samples + normalisation constants
    (copied from sloika_tpu/basecall.py:1021).  h5py is imported here, so
    the rest of the port runs without it.

    :returns: (short_name, dac (T,) int16, (offset, scale, med, mad) f32)
        or None
    """
    import h5py
    try:
        with h5py.File(fast5_file, "r") as h5:
            reads = h5["Raw/Reads"]
            dac = reads[sorted(reads.keys())[0]]["Signal"][:].astype(np.int16)
            meta = dict(h5["UniqueGlobalKey/channel_id"].attrs)
    except (OSError, KeyError, IndexError) as e:
        sys.stderr.write("Error getting raw data for file {}\n{!r}\n".format(
            fast5_file, e))
        return None
    sn = os.path.splitext(os.path.basename(fast5_file))[0]
    offset = np.float32(meta["offset"])
    scale = np.float32(float(meta["range"]) / float(meta["digitisation"]))
    scaled = scale_dac_f32(dac, offset, scale)
    if len(scaled) < 100:
        sys.stderr.write("Read too short in file {}\n".format(fast5_file))
        return None
    start, end = trim_open_pore(scaled, open_pore_fraction)
    start, stop = start + trim[0], end - trim[1]
    if stop <= start:
        sys.stderr.write("Read too short in file {}\n".format(fast5_file))
        return None
    s = scaled[start:stop]
    med = np.float32(np.median(s))
    mad = np.float32(maths.mad(s))
    return sn, dac[start:stop], (offset, scale, med, mad)


def load_event_features(fast5_file, section="template",
                        segmentation="Segmentation", trim=(50, 10)):
    """Event read -> feature matrix (copied from sloika_tpu/basecall.py:
    1062-1078).  As there, the event reader takes the latest basecall
    analysis and ``segmentation`` is not read.  h5py is imported by the
    reader.

    :returns: (short_name, features (T, 4) float32) or None
    """
    try:
        ev = fast5.read_section_events(fast5_file, section)
    except Exception as e:
        sys.stderr.write("Error getting events for section {!r} in file {}\n"
                         "{!r}\n".format(section, fast5_file, e))
        return None
    ev = util.trim_array(ev, *trim)
    if ev.size == 0:
        sys.stderr.write("Read too short in file {}\n".format(fast5_file))
        return None
    return fast5.filename_short(fast5_file), features.from_events(ev, tag='')


class SeqPrinter(object):
    """Write calls as FASTA (copied from sloika_tpu/basecall.py:1081-1124):
    kmer-state calls with :meth:`write`, 2-bit base codes with
    :meth:`write_codes`."""

    def __init__(self, datatype="samples", fname=None,
                 alphabet=DEFAULT_ALPHABET, fh=None, kmer_len=5,
                 transducer=True):
        self.kmers = bio.all_kmers(kmer_len, alphabet=alphabet)
        self.transducer = transducer
        self.datatype = datatype
        alpha = alphabet.encode() if isinstance(alphabet, str) else alphabet
        self._alpha_lut = np.frombuffer(alpha, dtype=np.uint8)
        if fh is not None:
            self.fh, self.close_fh = fh, False
        elif fname is None:
            self.fh, self.close_fh = sys.stdout, False
        else:
            self.fh, self.close_fh = open(fname, 'w'), True

    def close(self):
        if self.close_fh:
            self.fh.close()

    def write(self, read_name, score, call, nev):
        kmer_path = [self.kmers[i] for i in call]
        seq = bio.kmers_to_sequence(kmer_path, always_move=self.transducer)
        if isinstance(seq, bytes):
            seq = seq.decode('ascii')
        self.fh.write(">{} score {:.0f}, {} {} to {} bases\n".format(
            read_name, score, nev, self.datatype, len(seq)))
        self.fh.write(seq + '\n')
        return len(seq)

    def write_codes(self, read_name, score, codes, nev):
        seq = self._alpha_lut[np.asarray(codes, dtype=np.uint8)]
        seq = seq.tobytes().decode('ascii')
        self.fh.write(">{} score {:.0f}, {} {} to {} bases\n".format(
            read_name, score, nev, self.datatype, len(seq)))
        self.fh.write(seq + '\n')
        return len(seq)
