"""Chunked DAC basecalling: ``Basecaller(chunked=True, output="bases")
.basecall_dac_reads`` over the whole read pool a call; windows of
``chunk_size`` samples with ``overlap`` on each side, bases collapsed on
the card and stitched at the seams on the host."""
import numpy as np
import torch

from benchmark.harness import generators
from benchmark.harness.basecall import BasecallDriver, window_jobs
from benchmark.reference import model, viterbi


class Driver(BasecallDriver):

    def make_caller(self):
        from sloika_tpu_torch.basecall import Basecaller
        t = self.traffic
        return Basecaller(self.layer, self.config["kmer_len"],
                          min_prob=t["min_prob"], skip=t["skip"],
                          batch_size=t["batch_size"],
                          chunk_size=t["chunk_size"], overlap=t["overlap"],
                          output="bases", chunked=True, device=self.device)

    def call(self):
        return self.caller.basecall_dac_reads(self.reads)

    def work_of(self, calls):
        t = self.traffic
        C = t["chunk_size"]
        jobs = window_jobs(self.lengths, C, t["overlap"])
        frames = model.out_lengths(self.layers,
                                   np.array([j[3] for j in jobs]))
        return {"samples": float(self.lengths.sum()) * calls,
                "gru_steps": [(l["size"], int(frames.sum()) * calls)
                              for l in self.layers if l["type"] == "gru"],
                "viterbi_frames": int(frames.sum()) * calls,
                "viterbi_rows": len(jobs) * calls}

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
        score, path, moved, _ = self.post_paths(x, lengths, precision,
                                               t["reference_block"])
        Tp = path.shape[1]
        out, parts, total = [], [], 0.0
        for b, (i, w, _, _, nwin) in enumerate(jobs):
            total += float(np.float32(score[b]))
            parts.append(viterbi.window_bases(
                path[b], moved[b], self.config["kmer_len"],
                0 if w == 0 else V // stride,
                Tp if w == nwin - 1 else (C - V) // stride, w == 0))
            if w == nwin - 1:
                out.append((total, np.concatenate(parts)))
                parts, total = [], 0.0
        return out
