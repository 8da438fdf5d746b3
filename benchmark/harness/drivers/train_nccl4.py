"""Data-parallel training over the ranks of a group, one card a rank:
``training.train`` on every rank at the global batch, each rank training
its equal block of it (``mesh.local_batch_slice``), with one all-reduce of
the gradients a step inside the CUDA graph of K steps.  Every rank holds
the chunk set on its host, samples the global batch from the shared seed
and streams its block to its card (the program keeps a chunk set on the
card for a single rank only).

Rank 0 is the harness's process; :mod:`benchmark.harness.ranks` starts
the others, which make the same calls.  The weights are made from the seed
on rank 0 alone; ``training.train`` gives them to the others at each call
(``mesh.broadcast_params``), so the other ranks start from their network's
own initialisation.  Set-up ends in a barrier of every rank, and the
window's steps are rank 0's, agreed at its start.

The calls and the comparison are :mod:`train_graph`'s: the reference
follows the global batch (the ranks' blocks joined in rank order) with the
mean gradient.  One number more, ``replica_gap``: the widest gap between a
rank's parameters after set-up's steps and rank 0's, which data
parallelism keeps equal bit for bit.  The rate counts every rank's chunks
over rank 0's window; ``work`` holds rank 0's share."""
import torch
import torch.distributed as dist

from benchmark.harness import generators, port, ranks
from benchmark.harness.driver import sync
from benchmark.harness.drivers import train_graph
from benchmark.harness.spec import sub_seed


class Driver(train_graph.Driver):

    #: this process's rank (the ranks that ``ranks`` starts set theirs)
    rank = 0
    group = None

    def setup(self):
        try:
            self._setup()
        except BaseException:
            if self.group is not None:
                self.group.abort()
            raise

    def _setup(self):
        t = self.traffic
        if self.rank == 0:
            with self.spans("ranks"):
                self.group = ranks.Group(self.cell, self.seed, self.device,
                                         t["ranks"])
        self.seeds = {tag: sub_seed(self.seed, 20 + i)
                      for i, tag in enumerate(("step1", "group", "window"))}
        with self.spans("inputs"):
            self.data = generators.chunks(t, self.seed)
            self.layer = port.network(self.config)
            if self.rank == 0:
                self.params = generators.weights(self.layers, t["weights"],
                                                 self.seed, self.device)
                port.load_weights(self.layer, self.params)
        with self.spans("group"):
            ranks.join_group(self.device)
        self.steps_checked()
        flat = torch.cat([p.detach().reshape(-1)
                          for p in self.layer.parameters()])
        self.replicas = [torch.empty_like(flat) for _ in range(t["ranks"])]
        dist.all_gather(self.replicas, flat)
        sync(self.device)
        if self.rank != 0:
            del self.replicas
        from sloika_tpu_torch.parallel import mesh
        dist.barrier(group=mesh.host_group())

    def window_steps(self, seconds):
        from sloika_tpu_torch.parallel import mesh
        return mesh.agree(super().window_steps(seconds) if self.rank == 0
                          else None)

    def run_window(self, seconds):
        try:
            if self.group is not None:
                self.group.window(seconds)
            return super().run_window(seconds)
        except BaseException:
            if self.group is not None:
                self.group.abort()
            raise

    def release(self):
        super().release()
        if self.group is not None:
            self.group.close()
            self.group = None

    def notes(self):
        return "ranks: {}, global batch {}, {} a rank".format(
            self.traffic["ranks"], self.traffic["batch_size"],
            self.traffic["batch_size"] // self.traffic["ranks"])

    def program(self):
        first = self.replicas[0]
        gap = max(float((r - first).abs().max()) for r in self.replicas)
        return super().program() + (gap,)

    def numbers(self, got, want):
        gap = got[3] if len(got) > 3 else 0.0
        return super().numbers(got[:3], want) + self.limits(
            [("replica_gap", gap)])
