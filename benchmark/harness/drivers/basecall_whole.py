"""Whole-read basecalling, the ``raw`` CLI's default route:
``Basecaller(output="states").basecall_signals`` over reads normalised on
the host, in batches of ``batch_size`` in order of length, each read's
state path collapsed on the host."""
import numpy as np
import torch

from benchmark.harness import generators
from benchmark.harness.basecall import BasecallDriver
from benchmark.reference import model, viterbi


class Driver(BasecallDriver):

    def make_caller(self):
        from sloika_tpu_torch.basecall import Basecaller
        t = self.traffic
        self.signals = [generators.normalise(*r) for r in self.reads]
        return Basecaller(self.layer, self.config["kmer_len"],
                          min_prob=t["min_prob"], skip=t["skip"],
                          batch_size=t["batch_size"], output="states",
                          device=self.device)

    def call(self):
        return self.caller.basecall_signals(self.signals)

    def work_of(self, calls):
        frames = model.out_lengths(self.layers, self.lengths)
        return {"samples": float(self.lengths.sum()) * calls,
                "gru_steps": [(l["size"], int(frames.sum()) * calls)
                              for l in self.layers if l["type"] == "gru"],
                "frames": int(frames.sum()) * calls,
                "viterbi_rows": len(frames) * calls}

    def reference(self, precision):
        reads = [r for _, r in self.checked()]
        sigs = [generators.normalise(*self.reads[r]) for r in reads]
        order = np.argsort([len(s) for s in sigs])
        B = self.traffic["reference_rows"]
        out = [None] * len(reads)
        for lo in range(0, len(order), B):
            idx = order[lo:lo + B]
            T = max(len(sigs[i]) for i in idx)
            x = torch.zeros((T, len(idx), 1), dtype=torch.float32)
            for b, i in enumerate(idx):
                x[:len(sigs[i]), b, 0] = torch.from_numpy(sigs[i])
            lengths = torch.tensor([len(sigs[i]) for i in idx])
            score, path, moved, frames = self.post_paths(x, lengths,
                                                         precision, B)
            for b, i in enumerate(idx):
                out[i] = (float(np.float32(score[b])),
                          viterbi.collapse_states(path[b], moved[b],
                                                  int(frames[b])))
        return out
