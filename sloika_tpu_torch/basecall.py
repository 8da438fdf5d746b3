"""Basecalling on the GPU (cf. ``sloika_tpu/basecall.py``).

Every route of the JAX package's :class:`Basecaller` is ported:

* ``output="states"``, ``chunked=False`` (the default): whole reads, sorted
  by length, run in batches; each read's Viterbi path is cut at its own
  frame count and collapsed on the host to the kmer states entered by a
  move (:meth:`Basecaller.basecall_signals`, :meth:`SeqPrinter.write`),
  from raw reads normalised on the host (:func:`load_raw_signal`) or event
  features (:func:`load_event_features`).
* ``output="states"``, ``chunked=True``: reads are cut into overlapping
  windows (C samples, ``overlap`` on each side) that run in device batches
  through the forward pass, the ``min_prob`` floor and the Viterbi kernels;
  the paths and move flags come back to the host, which stitches them at
  each window's core frames.
* ``output="bases"`` (chunked, a 4-letter transducer): each window's path
  collapses on the device to packed 2-bit base codes, and the host
  stitches the windows' codes at their seams.  From raw int16 DAC samples
  (:meth:`Basecaller.basecall_dac_reads`) the windowing and the exact
  float32 normalisation ``((dac + offset) * scale - med) / mad`` run on the
  device too.
* A non-transducer model (``transducer=False``, with or without a ``bad``
  state) runs its forward pass and the floor on the device; the float32
  posterior then comes to the host, where :func:`decode_post_host` decodes
  each read with the legacy decoder (``ops/olddecode.py``), as the JAX
  package does.
* A CRF model (bonito's, a network ending in ``nn.LinearCRF``; the port's
  alone) basecalls chunked to bases: each window batch's scores go
  through the CTC-CRF decode on the device (``ops/crf_decode``), whose
  labels collapse there to the same packed base codes and seam counts as
  a transducer's path, stitched on the host alike.

A transducer over any alphabet (nbase its length) decodes on the device:
the tuned Viterbi kernels take 4 bases and klen 2-6, any other shape their
general route (``ops/viterbi_kernel.kernel_route``).

PyTorch runs eagerly, so there is no compile cache and no batch or length
bucketing: each batch runs at its own size.  Host <-> device copies are
plain ``.to(device)`` and ``.cpu()``, through :mod:`tracing`, which counts
their bytes, and the host's work between them is in the tracer's
``basecall.*`` spans.

The host helpers are copied from ``sloika_tpu/basecall.py`` (their source
lines are given), because that module imports jax.
"""
import os
import sys

import numpy as np
import torch

from sloika_tpu_torch import bio, config, maths, nn, tracing, util
from sloika_tpu_torch.data import features, fast5
from sloika_tpu_torch.data.batching import (normalise_raw_signal,
                                            trim_open_pore)
from sloika_tpu_torch.variables import DEFAULT_ALPHABET, nstate
from sloika_tpu_torch.ops import (crf_decode, decode_np, olddecode,
                                  output_head, viterbi_kernel)
from sloika_tpu_torch.ops.decode import collapse_path

_ETA = 1e-10

#: reads are packed into groups of about this many samples; one group is
#: one flat int16 buffer on the device (32 MB)
_GROUP_SAMPLES = 1 << 24


def _infer_stride(layer):
    """Total temporal downsampling factor of a layer graph (copied from
    sloika_tpu/basecall.py:43-57)."""
    if isinstance(layer, nn.Serial):
        s = 1
        for l in layer.layers:
            s *= _infer_stride(l)
        return s
    if isinstance(layer, (nn.Convolution, nn.MaxPool)):
        return layer.stride
    if isinstance(layer, (nn.Reverse, nn.Residual)):
        return _infer_stride(layer.layer)
    if isinstance(layer, nn.Parallel):
        return _infer_stride(layer.layers[0])
    return 1


def crf_head(layer):
    """The ``LinearCRF`` that ends the network (through ``Serial``), or
    None: a CRF model decodes by ``ops/crf_decode``."""
    if isinstance(layer, nn.LinearCRF):
        return layer
    if isinstance(layer, nn.Serial):
        return crf_head(layer.layers[-1])
    return None


def _contains_studentise(layer):
    """True if the layer graph contains a Studentise layer anywhere (copied
    from sloika_tpu/basecall.py:60-69)."""
    if isinstance(layer, nn.Studentise):
        return True
    if isinstance(layer, (nn.Serial, nn.Parallel)):
        return any(_contains_studentise(l) for l in layer.layers)
    if isinstance(layer, (nn.Reverse, nn.Residual)):
        return _contains_studentise(layer.layer)
    return False


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
    """Batched basecaller (cf. ``sloika_tpu/basecall.py:120``).

    A model with a ``Studentise`` layer, whose statistics span the whole
    batch, runs one unpadded read at a time (batch 1) in any mode, and
    returns kmer-state calls: ``chunked`` falls back to False and
    ``output`` to "states", as in the JAX package
    (sloika_tpu/basecall.py:187-199).

    A CRF model (a network ending in ``nn.LinearCRF``) always basecalls
    chunked to bases: ``chunked``, ``output``, ``transducer`` and
    ``kmer_len`` do not apply to it (``kmer_len`` may be None), and its
    alphabet is ACGT.

    :param layer: the network (a :class:`sloika_tpu_torch.nn.Layer`); it is
        moved to ``device`` in place
    :param kmer_len: kmer length of the output state space
    :param transducer: decode with the kmer-transducer Viterbi on the
        device; else the legacy decoder on the host
    :param bad: the model has a bad state at column 0 (non-transducers)
    :param min_prob: posterior probability floor
    :param skip: transducer skip penalty
    :param trans: [stay, step, skip] prior of the legacy decoder
    :param alphabet: the model's alphabet (bytes); nbase is its length
    :param batch_size: windows (chunked) or reads decoded per device batch
    :param chunked: cut reads into overlapping windows (transducers only)
    :param chunk_size, overlap: window length and seam overlap (samples)
    :param output: "states" (kmer-state calls; the JAX package's default)
        or "bases" (packed 2-bit base codes collapsed on the device; a
        chunked 4-letter transducer, or a CRF model, which takes only this)
    :param device: torch device; "cuda" raises when no GPU is present
    :param post_dtype: dtype the posterior streams to the Viterbi in,
        "float32", "bfloat16" or "auto": bfloat16 where
        ``config.compute_dtype`` is bfloat16, as the JAX package's "auto"
        with its Pallas Viterbi (``sloika_tpu/basecall.py:202-219``), whose
        counterpart the port's Viterbi is on the card and on the CPU alike.
        A non-transducer's posterior stays float32
        (sloika_tpu/basecall.py:284)
    """

    def __init__(self, layer, kmer_len, min_prob=1e-5, skip=5.0,
                 batch_size=8, chunk_size=8192, overlap=400, output="states",
                 device="cuda", post_dtype="auto", transducer=True,
                 bad=False, trans=None, alphabet=DEFAULT_ALPHABET,
                 chunked=False):
        if output not in ("bases", "states"):
            raise ValueError("output must be 'bases' or 'states'")
        if isinstance(alphabet, str):
            alphabet = alphabet.encode("ascii")
        self.alphabet = alphabet
        self.nbase = len(alphabet)
        self.transducer = transducer
        self.bad = bad
        self.trans = trans
        #: the CRF head of a CRF model (which decodes by ops/crf_decode)
        self._crf = crf_head(layer)
        if self._crf is not None:
            if not self.nbase == self._crf.nbase == 4:
                raise ValueError("a CRF model basecalls ACGT, not {!r}"
                                 .format(alphabet))
            chunked, output, kmer_len = True, "bases", None
        else:
            expected = nstate(kmer_len, transducer=transducer, bad_state=bad,
                              nbase=self.nbase)
            if layer.size != expected:
                raise ValueError("model emits {} states, decode expects {}"
                                 .format(layer.size, expected))
            if output == "bases" and not (chunked and transducer
                                          and self.nbase == 4):
                # as sloika_tpu/basecall.py:183-185 asserts
                raise ValueError("bases output requires chunked transducer "
                                 "mode (ACGT)")
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
        self.studentise = _contains_studentise(layer)
        if self.studentise and chunked:
            sys.stderr.write(
                "Model contains a Studentise layer: batched padded/chunked "
                "decoding is undefined for it; falling back to exact "
                "per-read basecalling (slower).\n")
            chunked, output = False, "states"
        self.chunked = chunked
        self.output = output
        #: the Viterbi kernels upcast each row to float32 before the log,
        #: so a bfloat16 posterior halves their dominant read and leaves
        #: the DP in float32
        if not transducer:
            self.post_dtype = torch.float32
        elif post_dtype == "auto":
            self.post_dtype = config.compute_dtype
        else:
            self.post_dtype = {"float32": torch.float32,
                               "bfloat16": torch.bfloat16}[str(post_dtype)]
        #: the two seam frames of a window (move-record count boundaries)
        self._f_splits = (overlap // self.model_stride,
                          (chunk_size - overlap) // self.model_stride)
        #: (body, terminal Softmax) where the head runs as one kernel: a
        #: CUDA device and a network ending in a Softmax
        self._head = (output_head.terminal_softmax(self.layer)
                      if self.device.type == "cuda" else None)

    # -- device programs -------------------------------------------------

    def _floored_masked_post(self, x, lengths):
        """Forward pass + min_prob floor + pad-frame masking, in
        ``post_dtype`` (sloika_tpu/basecall.py:274-289): on the card, a
        network ending in a Softmax runs the layers before it, then the
        head as one kernel (``ops/output_head``); else the whole network,
        then :meth:`_floor_mask`."""
        if self._head is not None:
            body, softmax = self._head
            h, out_lengths = body(x, lengths)
            return output_head.output_head(
                h, softmax.W, softmax.b, out_lengths, self.min_prob,
                self.post_dtype), out_lengths
        post, out_lengths = self.layer.apply_with_lengths(x, lengths)
        return self._floor_mask(post, out_lengths), out_lengths

    def _floor_mask(self, post, out_lengths):
        """The min_prob floor and pad-frame stays of a (T, B, nstate)
        float32 posterior, in ``post_dtype`` (``output_head.floor_mask``)."""
        return output_head.floor_mask(post, out_lengths, self.min_prob,
                                      self.post_dtype)

    def _viterbi(self, post):
        """(score, path, moved) of a floored posterior through the Viterbi
        kernels, tuned or general route by its shape."""
        return viterbi_kernel.viterbi(post, self.kmer_len,
                                      skip_pen=self.skip, nbase=self.nbase)

    def _forward_decode(self, x, lengths):
        """Posterior + Viterbi + collapse of one window batch.

        :param x: (C, B, nfeature) float32 windows;  :param lengths: (B,)
        :returns: (score (B,), first (B,) int16, counts (B, 3) int32,
            packed codes (B, ceil(2T'/4)) uint8) device tensors; a CRF
            model's scores through the CRF decode instead (packed (B,
            ceil(T'/4)): a frame emits a base at most)
        """
        if self._crf is not None:
            scores, frames = self.layer.apply_with_lengths(x, lengths)
            score, labels = crf_decode.crf_decode(scores, frames)
            return (score,) + crf_decode.label_records(labels,
                                                       self._f_splits)
        post, _ = self._floored_masked_post(x, lengths)
        score, path, moved = self._viterbi(post)
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
        """Posterior + Viterbi of one batch (the transducer branch of
        ``_forward_decode``, sloika_tpu/basecall.py:315-325).

        :returns: (score (B,), frames (B,), path (B, T'), moved (B, T'))
            device tensors
        """
        post, out_lengths = self._floored_masked_post(x, lengths)
        score, path, moved = self._viterbi(post)
        return score, out_lengths, path, moved

    # -- public API ------------------------------------------------------

    def basecall_to_sequences(self, signals):
        """Basecall to base-code arrays: a list of (score, codes), where
        ``codes`` index the alphabet, or None for a read that failed
        (sloika_tpu/basecall.py:402-422).  In "bases" mode this is the
        native form."""
        out = self.basecall_signals(signals)
        if self.output == "bases":
            return out
        kmers = bio.all_kmers(self.kmer_len, alphabet=self.alphabet)
        lut = np.zeros(256, np.uint8)
        for i, c in enumerate(bytearray(self.alphabet)):
            lut[c] = i
        res = []
        for o in out:
            if o is None:
                res.append(None)
                continue
            score, call = o
            seq = bio.kmers_to_sequence([kmers[i] for i in call],
                                        always_move=self.transducer)
            res.append((score, lut[np.frombuffer(seq, dtype=np.uint8)]))
        return res

    def basecall_signals(self, signals):
        """Basecall a list of normalised 1-D signals (or (T, F) feature
        matrices), by the route the constructor chose
        (sloika_tpu/basecall.py:424-443): (score, base codes) per read with
        ``output="bases"``, else (score, call), the call a kmer-state
        sequence (the states entered by a move for a transducer, one state
        an event for the legacy decoder)."""
        with tracing.span("basecall.signals"):
            if self.studentise:
                return self._basecall_per_read(signals)
            if self.chunked and (self.transducer or self._crf is not None):
                if self.output == "bases":
                    return self._basecall_chunked_bases(signals)
                return self._basecall_chunked(signals)
            out = [None] * len(signals)
            order = np.argsort([len(s) for s in signals])
            for lo in range(0, len(order), self.batch_size):
                idx = order[lo:lo + self.batch_size]
                self._run_batch([signals[i] for i in idx], idx, out)
            return out

    def _window_batches(self, signals):
        """The window batches of the chunked routes: (jobs, x (C, B, nfeat)
        float32 on the device, lengths (B,) int64 on the device) for each
        ``batch_size`` windows of :func:`_window_jobs`."""
        C = self.chunk_size
        jobs = _window_jobs([len(s) for s in signals], C, self.overlap)
        nfeat = 1 if not signals or signals[0].ndim == 1 \
            else signals[0].shape[1]
        for lo in range(0, len(jobs), self.batch_size):
            batch = jobs[lo:lo + self.batch_size]
            with tracing.span("basecall.pack"):
                x = np.zeros((C, len(batch), nfeat),
                             dtype=config.sloika_dtype)
                lengths = np.zeros(len(batch), dtype=np.int64)
                for b, (r, _, start, ln, _) in enumerate(batch):
                    x[:ln, b] = signals[r][start:start + ln].reshape(ln,
                                                                     nfeat)
                    lengths[b] = ln
            with tracing.span("basecall.h2d"):
                x = tracing.to_device(torch.from_numpy(x), self.device)
                lengths = tracing.to_device(torch.from_numpy(lengths),
                                            self.device)
            yield batch, x, lengths

    def _basecall_chunked_bases(self, signals):
        """The chunked "bases" route (cf. ``_basecall_chunked_bases``,
        sloika_tpu/basecall.py:473): (score, base codes) per read."""
        results = {}
        with torch.inference_mode():
            for batch, x, lengths in self._window_batches(signals):
                with tracing.span("basecall.launch"):
                    out = self._forward_decode(x, lengths)
                _collect([(r, w) for r, w, _, _, _ in batch], out, results)
        return self._stitch_bases(results, [len(s) for s in signals])

    def _basecall_chunked(self, signals):
        """The chunked "states" route (sloika_tpu/basecall.py:786-851):
        window batches through the forward pass, the floor and the Viterbi
        kernels on the device; each window's path and move flags come to
        the host, which keeps the states entered by a move in the window's
        core frames (and the read's opening state) and joins them.  Calls
        can differ from whole-read decoding within ~overlap samples of the
        seams."""
        C, V = self.chunk_size, self.overlap
        d = self.model_stride
        results = {}
        with torch.inference_mode():
            for batch, x, lengths in self._window_batches(signals):
                with tracing.span("basecall.launch"):
                    out = self._forward_decode_states(x, lengths)
                with tracing.span("basecall.collect"):
                    score, frames, path, moved = (
                        tracing.to_host(o).numpy() for o in out)
                for b, (r, w, _, _, _) in enumerate(batch):
                    results[(r, w)] = (float(score[b]), path[b], moved[b],
                                       int(frames[b]))

        out = [None] * len(signals)
        call_parts, total_score = [], 0.0
        with tracing.span("basecall.stitch"):
            for r, w, _, _, nwin in _window_jobs([len(s) for s in signals],
                                                 C, V):
                sc, path, moved, nframes = results[(r, w)]
                total_score += sc
                # the core frames of this window
                f_lo = 0 if w == 0 else V // d
                f_hi = nframes if w == nwin - 1 else (C - V) // d
                keep = moved[f_lo:f_hi].copy()
                if w == 0:
                    keep[0] = True     # the opening state of the read
                call_parts.append(path[f_lo:f_hi][keep])
                if w == nwin - 1:
                    out[r] = (total_score, np.concatenate(call_parts))
                    call_parts, total_score = [], 0.0
        return out

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
        with tracing.span("basecall.dac"):
            return self._basecall_dac(reads)

    def _basecall_dac(self, reads):
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
                with tracing.span("basecall.pack"):
                    glens = [read_lens[r] for r in group]
                    offsets = np.concatenate([[0], np.cumsum(glens)]).astype(
                        np.int64)
                    flat = np.zeros(int(offsets[-1]) + C, np.int16)
                    for r, o in zip(group, offsets):
                        flat[o:o + read_lens[r]] = reads[r][0]
                    jobs = [(group[gr], w, int(offsets[gr]) + start, ln)
                            for gr, w, start, ln, _ in _window_jobs(
                                glens, C, self.overlap)]
                with tracing.span("basecall.h2d"):
                    flat_d = tracing.to_device(torch.from_numpy(flat),
                                               self.device)
                for lo in range(0, len(jobs), self.batch_size):
                    batch = jobs[lo:lo + self.batch_size]
                    with tracing.span("basecall.pack"):
                        starts = np.array([j[2] for j in batch], np.int64)
                        lengths = np.array([j[3] for j in batch], np.int64)
                        norms = np.array([reads[j[0]][1] for j in batch],
                                         np.float32).reshape(len(batch), 4)
                    with tracing.span("basecall.h2d"):
                        args = [tracing.to_device(torch.from_numpy(a),
                                                  self.device)
                                for a in (starts, lengths, norms)]
                    with tracing.span("basecall.launch"):
                        out = self._forward_decode_dac(flat_d, *args)
                    _collect([(r, w) for r, w, _, _ in batch], out, results)
        return self._stitch_bases(results, read_lens)

    def _decode_host(self, post, floored):
        """The legacy decoder of one read's (T', nstate) float32 posterior
        on the host (:func:`decode_post_host`)."""
        return decode_post_host(post[:, None, :], self.kmer_len, self.bad,
                                self.min_prob, self.trans, nbase=self.nbase,
                                floored=floored)

    def _basecall_per_read(self, signals):
        """The Studentise route (sloika_tpu/basecall.py:445-469): one
        unpadded forward per read at batch 1, so the statistics are the
        read's own.  A transducer decodes on the device by the Viterbi
        kernels (the JAX package decodes it on the host, ``decode_post_
        host``; the paths are the same, ties included), any other model on
        the host.  A read that fails is reported and gives None."""
        out = []
        for s in signals:
            try:
                out.append(self._call_one_read(s))
            except Exception as e:          # per-read fault masking
                sys.stderr.write("basecall failed: {!r}\n".format(e))
                out.append(None)
        return out

    def _call_one_read(self, s):
        nfeat = 1 if s.ndim == 1 else s.shape[1]
        x = torch.from_numpy(np.ascontiguousarray(
            s.reshape(len(s), 1, nfeat), dtype=config.sloika_dtype))
        with torch.inference_mode():
            post = self.layer(tracing.to_device(x, self.device))
            if not self.transducer:
                return self._decode_host(
                    tracing.to_host(post[:, 0].float()).numpy(),
                    floored=False)
            frames = torch.full((1,), post.shape[0], dtype=torch.int64,
                                device=self.device)
            score, path, moved = self._viterbi(self._floor_mask(post, frames))
        return (float(score[0]), collapse_path(
            tracing.to_host(path[0]).numpy(),
            tracing.to_host(moved[0]).numpy(), post.shape[0]))

    def _run_batch(self, sigs, idx, out):
        """One batch of whole reads (sloika_tpu/basecall.py:853-886).  The
        batch runs at its own size and longest length: the JAX package's
        bucketed padding adds frames that are exact one-hot stays, which
        add nothing to the score and leave the path alone.  A
        non-transducer's floored posterior comes to the host, each read cut
        at its own frame count and decoded there."""
        nfeat = 1 if sigs[0].ndim == 1 else sigs[0].shape[1]
        with tracing.span("basecall.pack"):
            lengths = np.array([len(s) for s in sigs], dtype=np.int64)
            x = np.zeros((int(lengths.max()), len(sigs), nfeat),
                         dtype=config.sloika_dtype)
            for b, s in enumerate(sigs):
                x[:len(s), b] = s.reshape(len(s), nfeat)
        with tracing.span("basecall.h2d"):
            x = tracing.to_device(torch.from_numpy(x), self.device)
            lengths = tracing.to_device(torch.from_numpy(lengths),
                                        self.device)
        with torch.inference_mode():
            if not self.transducer:
                with tracing.span("basecall.launch"):
                    post, frames = self._floored_masked_post(x, lengths)
                with tracing.span("basecall.collect"):
                    post, frames = (tracing.to_host(post).numpy(),
                                    tracing.to_host(frames).numpy())
                for b, i in enumerate(idx):
                    out[i] = self._decode_host(post[:int(frames[b]), b],
                                               floored=True)
                return
            with tracing.span("basecall.launch"):
                got = self._forward_decode_states(x, lengths)
            with tracing.span("basecall.collect"):
                score, frames, path, moved = (tracing.to_host(o).numpy()
                                              for o in got)
        with tracing.span("basecall.collapse"):
            for b, i in enumerate(idx):
                out[i] = (float(score[b]),
                          collapse_path(path[b], moved[b], int(frames[b])))

    def _stitch_bases(self, results, read_lens):
        """Concatenate per-window base emissions at the seam boundaries
        (copied from sloika_tpu/basecall.py:531).

        :param results: {(read, window): (score, first_state, counts, codes)}
        """
        # a read's first window opens with its first kmer's bases; a CRF
        # call has none
        k = 0 if self._crf is not None else self.kmer_len
        out = [None] * len(read_lens)
        parts, total_score = [], 0.0
        with tracing.span("basecall.stitch"):
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


def decode_post_host(post, kmer_len, bad, min_prob, trans=None, nbase=4,
                     floored=False):
    """Host decode of one non-transducer read's (T, 1, nstate) posterior by
    the legacy decoder over 4 bases (the non-transducer branch of
    sloika_tpu/basecall.py:960-978; a transducer decodes on the device).
    ``floored``: the posterior already has the ``min_prob`` floor, so only
    the bad state's frames and column are dropped (and the rest
    renormalised).

    :returns: (score, one state an event)
    """
    want = nstate(kmer_len, transducer=False, bad_state=bad, nbase=nbase)
    if post.shape[2] != want:
        raise ValueError("posterior has {} states, the model's decode "
                         "expects {}".format(post.shape[2], want))
    if floored:
        post = np.squeeze(post, axis=1)
        if bad:
            maxcall = np.argmax(post, axis=1)
            post = post[maxcall > 0, 1:]
            post = post / np.sum(post, axis=1, keepdims=True)
    else:
        post = decode_np.prepare_post(post, min_prob=min_prob, drop_bad=bad)
    if nbase != 4:
        raise ValueError("Modified bases not supported by old decoder")
    trans = olddecode.estimate_transitions(post, trans=trans)
    return olddecode.decode_profile(post, trans=np.log(_ETA + trans),
                                    log=False)


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
    with tracing.span("basecall.collect"):
        score, first, counts, packed = (tracing.to_host(o).numpy()
                                        for o in out)
    with tracing.span("basecall.unpack"):
        recs = _unpack_codes(packed)
        for b, key in enumerate(keys):
            results[key] = (float(score[b]), int(first[b]), counts[b],
                            recs[b])


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
    985-1001): pA scale, then :func:`prepare_raw_signal`.  h5py is imported
    by the reader.

    :returns: (short_name, signal (T,) float32) or None
    """
    try:
        signal = fast5.read_raw_signal(fast5_file)
        sn = fast5.filename_short(fast5_file)
    except Exception as e:
        sys.stderr.write("Error getting raw data for file {}\n{!r}\n".format(
            fast5_file, e))
        return None
    signal = prepare_raw_signal(signal, trim, open_pore_fraction)
    if signal is None:
        sys.stderr.write("Read too short in file {}\n".format(fast5_file))
        return None
    return sn, signal


def prepare_raw_signal(signal, trim=(200, 50), open_pore_fraction=0.3):
    """A read's pA signal trimmed (open pore, then ``trim`` samples from
    each end) and normalised by its median and MAD, as
    :func:`load_raw_signal` does; None where nothing is left."""
    start, end = trim_open_pore(signal, open_pore_fraction)
    signal = util.trim_array(signal[start:end], *trim)
    if signal.size == 0:
        return None
    return normalise_raw_signal(signal)


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
