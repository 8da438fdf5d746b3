"""Chunked DAC basecalling of a CRF model (bonito's):
``Basecaller(...).basecall_dac_reads``, chunked to bases, over the
whole read pool a call; windows of ``chunk_size`` samples with ``overlap``
on each side, the CRF decode and the labels' collapse to bases on the card,
stitched at the seams on the host.  The reference decodes with
``benchmark/reference/crf.py``."""
import numpy as np
import torch

from benchmark.harness import generators
from benchmark.harness.basecall import BasecallDriver, window_jobs
from benchmark.reference import crf, model


class Driver(BasecallDriver):

    def make_caller(self):
        from sloika_tpu_torch.basecall import Basecaller
        t = self.traffic
        # a CRF model basecalls chunked to bases, with no kmer length
        return Basecaller(self.layer, None, batch_size=t["batch_size"],
                          chunk_size=t["chunk_size"], overlap=t["overlap"],
                          device=self.device)

    def call(self):
        return self.caller.basecall_dac_reads(self.reads)

    def work_of(self, calls):
        t = self.traffic
        jobs = window_jobs(self.lengths, t["chunk_size"], t["overlap"])
        frames = int(model.out_lengths(
            self.layers, np.array([j[3] for j in jobs])).sum())
        return {"samples": float(self.lengths.sum()) * calls,
                "lstm_steps": [(l["size"], frames * calls)
                               for l in self.layers if l["type"] == "lstm_cell"],
                "frames": frames * calls,
                "crf_rows": len(jobs) * calls}

    def post_paths(self, x, lengths, precision, block):
        """Reference scores and labels (B, T') of a batch of float32 rows
        (T, B, 1) on the card, in blocks of ``block`` rows, and their frame
        counts."""
        out = []
        for lo in range(0, x.shape[1], block):
            xb = x[:, lo:lo + block].to(self.device)
            lb = lengths[lo:lo + block].to(self.device)
            with torch.no_grad():
                scores, frames = model.logits(self.layers, self.params, xb,
                                              lb, precision)
                score, labels = crf.decode(scores, frames)
            out.append((score, labels, frames.cpu().numpy()))
            del scores
        return [np.concatenate(parts) for parts in zip(*out)]

    def reference(self, precision):
        t = self.traffic
        C, V = t["chunk_size"], t["overlap"]
        reads = [r for _, r in self.checked()]
        stride = model.stride(self.layers)
        jobs = window_jobs(self.lengths[reads], C, V)
        x = torch.zeros((C, len(jobs), 1), dtype=torch.float32)
        lengths = torch.zeros(len(jobs), dtype=torch.int64)
        sigs = [generators.normalise(*self.reads[r]) for r in reads]
        for b, (i, _, start, ln, _) in enumerate(jobs):
            x[:ln, b, 0] = torch.from_numpy(sigs[i][start:start + ln])
            lengths[b] = ln
        score, labels, frames = self.post_paths(x, lengths, precision,
                                                t["reference_block"])
        out, parts, total = [], [], 0.0
        for b, (i, w, _, _, nwin) in enumerate(jobs):
            total += float(np.float32(score[b]))
            lo = 0 if w == 0 else V // stride
            hi = int(frames[b]) if w == nwin - 1 else (C - V) // stride
            lab = labels[b, lo:hi]
            parts.append((lab[lab > 0] - 1).astype(np.uint8))
            if w == nwin - 1:
                out.append((total, np.concatenate(parts)))
                parts, total = [], 0.0
        return out
