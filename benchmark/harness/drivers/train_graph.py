"""Training through ``training.train`` with the chunk set on the card and
K steps a CUDA graph, at one fixed chunk length.

Set-up builds the network and its optimiser state and drives them from the
seed through their first K + 1 steps by the window's own call: step 1 as a
call of one step (the state read after it), steps 2 to K + 1 as a call of
one group of K steps at the window's K, a graph captured and replayed as
the window's are (it also warms up every shape the window uses).  The
window is one call of a fixed number of steps, ``steps_per_second`` for
each second asked for and at least two groups, so that every run does the
same work; its graph's capture is part of it, as in every job.

The reference follows all of set-up's steps and the window's first two
groups: every one of those steps' losses is compared, those of the
window's graph among them, with the first step's gradient and the
parameters after set-up's steps."""
import numpy as np
import torch

from benchmark.harness import compare, generators, port
from benchmark.harness.driver import Driver, sync
from benchmark.harness.spec import sub_seed
from benchmark.reference import train as ref_train


def _clone(tree):
    return {k: v.detach().clone() for k, v in tree.items()}


class Driver(Driver):

    span_name = "train"

    def _train(self, niteration, K, tag, stats=None):
        from sloika_tpu_torch import training
        t = self.traffic
        self.opt_state, hist = training.train(
            self.layer, self.data, adam=tuple(t["adam"]),
            batch_size=t["batch_size"], chunk_len_range=(1.0, 1.0),
            drop=t["drop"], min_prob=t["min_prob"], lrdecay=t["lrdecay"],
            niteration=niteration, quiet=True, seed=self.seeds[tag],
            opt_state=self.opt_state, steps_per_dispatch=K,
            data_on_device=True, stats=stats, device=self.device)
        return hist

    def setup(self):
        t = self.traffic
        K = t["steps_per_dispatch"]
        self.seeds = {tag: sub_seed(self.seed, 20 + i)
                      for i, tag in enumerate(("step1", "group", "window"))}
        with self.spans("inputs"):
            self.params = generators.weights(self.layers, t["weights"],
                                             self.seed, self.device)
            self.data = generators.chunks(t, self.seed)
        self.layer = port.load_weights(port.network(self.config),
                                       self.params)
        self.opt_state = None
        named = lambda tree: port.named_tree(self.layer, tree)
        with self.spans("steps_checked"):
            h1 = self._train(1, K, "step1")
            self.moment1 = _clone(named(self.opt_state.mu))
            hg = self._train(K, K, "group")
            self.after = _clone(named(self.layer.param_tensors()))
            sync(self.device)
        self.losses = [float(h1[0, 0])] + [float(v) for v in hg[:, 0]]

    def run_window(self, seconds):
        K = self.traffic["steps_per_dispatch"]
        n = max(2 * K, int(round(seconds * self.traffic["steps_per_second"]
                                 / K)) * K)
        self.stats = {}
        with self.spans(self.span_name):
            hist = self._train(n, K, "window", stats=self.stats)
        sync(self.device)
        failed = int((~np.isfinite(hist[:, 0])).sum())
        self.window_losses = [float(v) for v in hist[:2 * K, 0]]
        B = self.traffic["batch_size"]
        frames = self.traffic["chunk_samples"] // self.traffic["stride"]
        self.work.update({
            "chunks": n * B, "steps": n,
            "samples": n * B * self.traffic["chunk_samples"],
            # the graph's warm-up group runs the same kernels, untrained
            "gru_kernel_steps": [(l["size"], (n + K) * B * frames)
                                 for l in self.layers
                                 if l["type"] == "gru"]})
        return float(n * B), n, failed

    def program(self):
        d0 = self.traffic["adam"][1]
        first = {k: v / (1.0 - d0) for k, v in self.moment1.items()}
        return self.losses + self.window_losses, first, self.after

    def reference(self, precision):
        t = self.traffic
        K = t["steps_per_dispatch"]
        d = self.data
        n, L = d["chunks"].shape[:2]
        draw = lambda tag, k: ref_train.sampler_draws(
            n, d["weights"], t["batch_size"], t["chunk_samples"], L,
            t["stride"], self.seeds[tag], k)
        draws = draw("step1", 1) + draw("group", K) + draw("window", 2 * K)
        # each call's learning rate decays from its own first step
        lr = lambda i: float(np.float32(t["adam"][0]
                                        / (1.0 + i / t["lrdecay"])))
        lrs = [lr(0)] + [lr(i) for i in range(K)] + [lr(i)
                                                    for i in range(2 * K)]
        chunks = torch.from_numpy(d["chunks"]).to(self.device)
        labels = torch.from_numpy(d["labels"].astype(np.int64)).to(
            self.device)
        return ref_train.follow(self.layers, self.params, chunks, labels,
                                draws, lrs, t["drop"], t["min_prob"],
                                t["chunk_samples"], t["stride"], 1 + K,
                                precision)

    def numbers(self, got, want):
        losses, first, after = got
        rlosses, rfirst, rafter = want
        gnorm = {k: float(v.double().norm()) for k, v in rfirst.items()}
        med = float(np.median(list(gnorm.values())))
        moved = [k for k, v in gnorm.items() if v >= 1e-3 * med]
        change = lambda p: {k: p[k] - self.params[k] for k in moved}
        return self.limits([
            ("loss_gap", compare.score_gap(losses, rlosses)),
            ("grad_gap", compare.leaf_norm_gap(first, rfirst)),
            ("change_gap", compare.leaf_norm_gap(change(after),
                                                 change(rafter)))])
