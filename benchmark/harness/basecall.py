"""The basecall drivers' shared part: the reads, the program's
``Basecaller`` and the reference's calls of the sampled reads."""
import numpy as np
import torch

from benchmark.harness import compare, generators, port
from benchmark.harness.driver import Driver, sync
from benchmark.harness.spec import sub_seed
from benchmark.reference import model, viterbi


def window_jobs(read_lens, chunk_size, overlap):
    """The chunked window split (frozen copy of
    ``sloika_tpu_torch/basecall.py:89-106``): window w of a read covers
    samples [w*core, w*core + C), core = C - 2*overlap.

    :returns: [(read, window, start, length, windows of the read)]
    """
    core = chunk_size - 2 * overlap
    jobs = []
    for r, L in enumerate(read_lens):
        nwin = max(1, -(-max(L - 2 * overlap, 1) // core))
        for w in range(nwin):
            start = w * core
            jobs.append((r, w, start, min(chunk_size, L - start), nwin))
    return jobs


class BasecallDriver(Driver):
    """Reads made on the card from the seed, called in a closed loop: one
    unit a call over the whole pool."""

    span_name = "basecall"

    def setup(self):
        t = self.traffic
        with self.spans("inputs"):
            self.params = generators.weights(self.layers, t["weights"],
                                             self.seed, self.device)
            self.reads = generators.dac_reads(t, self.seed, self.device)
            self.lengths = np.array([len(d) for d, _ in self.reads])
        self.layer = port.load_weights(port.network(self.config),
                                       self.params)
        self.caller = self.make_caller()
        with self.spans("warmup"):
            self.call()
        sync(self.device)

    def tally(self, calls):
        failed = sum(a is None for ans in self.answers for a in ans)
        self.work.update(self.work_of(calls))
        return (float(self.lengths.sum()) * calls, len(self.reads) * calls,
                failed)

    def checked(self):
        """The (call, read) pairs compared: reads drawn from the seed
        across the pool in the order the program is given them, the
        longest among them (:meth:`sample`), each read's call drawn from
        the seed."""
        reads = self.sample(min(self.traffic["check_reads"], len(self.reads)),
                            len(self.reads), int(np.argmax(self.lengths)))
        rs = np.random.RandomState(sub_seed(self.seed, 10))
        return [(int(rs.randint(len(self.answers))), r) for r in reads]

    def program(self):
        return [self.answers[c][r] for c, r in self.checked()]

    def numbers(self, got, want):
        """The widest relative gap of a read's score, and the compared
        reads' calls' edit distance from the reference's over the
        reference's bases."""
        return self.limits([
            ("score_gap", compare.score_gap([g[0] for g in got],
                                            [w[0] for w in want])),
            ("base_error", compare.base_error([g[1] for g in got],
                                              [w[1] for w in want]))])

    def notes(self):
        """The calls' size, on standard error: the first call's bases a
        read and a frame."""
        bases = sum(len(a[1]) for a in self.answers[0])
        frames = int(model.out_lengths(self.layers, self.lengths).sum())
        return "calls: {:.1f} bases a read, {:.4f} a frame".format(
            bases / len(self.lengths), bases / frames)

    def post_paths(self, x, lengths, precision, block):
        """Reference scores, paths, moves and frame counts of a batch of
        float32 rows (T, B, 1) on the card, in blocks of ``block`` rows."""
        t = self.traffic
        out = []
        for lo in range(0, x.shape[1], block):
            xb = x[:, lo:lo + block].to(self.device)
            lb = lengths[lo:lo + block].to(self.device)
            with torch.no_grad():
                post, frames = model.posterior(self.layers, self.params, xb,
                                               lb, precision)
                post = viterbi.floor(post, t["min_prob"], frames)
                score, path, moved = viterbi.viterbi(
                    post, self.config["kmer_len"], t["skip"])
            out.append((score, path, moved, frames.cpu().numpy()))
            del post
        return [np.concatenate(parts) for parts in zip(*out)]
