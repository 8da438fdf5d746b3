"""Rank bodies for the port's multi-rank CPU tests
(``tests/test_torch_parallel*.py``), started by
``sloika_tpu_torch.parallel.spawn.run``.  jax-free: a spawned rank imports
this module and the port only.

Each body takes ``argv`` = [output directory, ...], joins the group from
the environment the launcher set, and writes what the test compares as
``rank<r>.npz`` (arrays) or ``rank<r>.json`` in that directory.
"""
import json
import os
import time

import numpy as np
import torch

#: the small model of tests/multihost_worker.py: Gru(1, 8) + Softmax(8, 65)
T, B, NSTATE, WIDTH, DROP = 40, 8, 65, 8, 2
STEPS, K, LR = 4, 2, 1e-3


def small_model(seed=0):
    """The port's Gru(1, 8) + Softmax(8, 65), its weights made with numpy
    from ``seed`` (sd 0.4 / sqrt(fan-in))."""
    from sloika_tpu_torch import nn
    from sloika_tpu_torch import serialize
    layer = nn.Serial([nn.Gru(1, WIDTH, has_bias=True),
                       nn.Softmax(WIDTH, NSTATE, has_bias=True)])
    rs = np.random.RandomState(seed)
    tree = layer.param_tree()
    serialize.params_from_numpy(layer, _draw(tree, rs))
    return layer


def _draw(tree, rs):
    if isinstance(tree, dict):
        return {k: _draw(v, rs) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_draw(v, rs) for v in tree)
    shape = tuple(tree.shape)
    return (0.4 * rs.normal(size=shape) / np.sqrt(shape[-1])).astype(
        np.float32)


def global_batches(n, seed=7):
    """n numpy-made global batches (x (T, B, 1), labels, weights (T, B));
    the first two columns' weights are zero over the first half of the
    chunk, so the ranks' blocks hold different counts of valid labels."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.normal(size=(T, B, 1)).astype(np.float32)
        labels = rs.randint(0, NSTATE, size=(T, B)).astype(np.int64)
        weights = np.ones((T, B), np.float32)
        weights[:T // 2, :2] = 0.0
        out.append((x, labels, weights))
    return out


def steps(layer):
    """STEPS single steps, then one group of K, of ADAMski on the global
    batches (each rank on its block): (losses, accuracies)."""
    from sloika_tpu_torch import optim, training
    from sloika_tpu_torch.parallel import mesh
    opt_init, opt_update = optim.adamski()
    opt_state = opt_init(layer)
    step = training.make_train_step(layer, opt_update, min_prob=1e-30,
                                    drop=DROP)
    batches = [tuple(torch.from_numpy(np.ascontiguousarray(
        mesh.local_batch(a))) for a in b)
        for b in global_batches(STEPS + K)]
    out = []
    for b in batches[:STEPS]:
        opt_state, loss, acc = step(opt_state, *b, LR)
        out.append((float(loss), float(acc)))
    loss_fn = training.make_loss_fn(layer, min_prob=1e-30, drop=DROP,
                                    counts=True)
    scal, opt_state = training._group_scalars(opt_update, opt_state,
                                              [LR] * K)
    got = training._group_body(layer, loss_fn, opt_update.apply, opt_state,
                               K, lambda j: batches[STEPS + j],
                               torch.from_numpy(scal))
    out.extend(tuple(map(float, r)) for r in got)
    return np.asarray(out)


def params_of(layer):
    return {n: p.detach().cpu().numpy().copy()
            for n, p in layer.named_parameters()}


def train_ranks(argv):
    """Rank body: :func:`steps` from a model whose ranks start apart (rank
    r's weights from seed r: rank 0's are broadcast), then ``training.
    train`` (2 ranks, K = 1 and K = 2 on the CPU) with rank 0 writing its
    checkpoints, and ``data_on_device=True``, which must raise."""
    from sloika_tpu_torch import training
    from sloika_tpu_torch.parallel import mesh
    out = argv[0]
    mesh.maybe_init_distributed("cpu")
    r = mesh.rank()
    layer = small_model(seed=r)
    mesh.broadcast_params(layer)
    hist = steps(layer)
    res = {"steps": hist}
    res.update(("steps/" + n, v) for n, v in params_of(layer).items())
    for k in (1, 2):
        layer = training_model(seed=r)
        _, h = training.train(layer, training_data(), device="cpu",
                              output=os.path.join(out, "train{}".format(k)),
                              **train_kwargs(k))
        res["train{}".format(k)] = h
        res.update(("train{}/{}".format(k, n), v)
                   for n, v in params_of(layer).items())
    try:
        training.train(training_model(), training_data(), device="cpu",
                       data_on_device=True,
                       **dict(train_kwargs(2), niteration=2))
        res["refused"] = ""
    except ValueError as e:
        res["refused"] = str(e)
    np.savez(os.path.join(out, "rank{}.npz".format(r)), **res)
    return 0


def training_model(seed=0):
    from sloika_tpu_torch import models
    return models.network_factory("raw_0.98_rgrgr")(klen=3, sd=0.5, size=8,
                                                    seed=seed)


def training_data(n=24, chunk_len=200, stride=5, seed=0):
    rs = np.random.RandomState(seed)
    chunks = rs.normal(size=(n, chunk_len, 1)).astype(np.float32)
    labels = rs.randint(0, 65, size=(n, chunk_len // stride)).astype(
        np.int32)
    return {"chunks": chunks, "labels": labels,
            "bad": np.zeros(labels.shape, bool),
            "weights": np.ones(n) / n, "attrs": {"kmer": 3}}


def train_kwargs(k):
    return dict(niteration=6, batch_size=8, chunk_len_range=(1.0, 1.0),
                drop=5, seed=3, save_every=4, quiet=True,
                steps_per_dispatch=k, prefetch=False)


def fail_ranks(argv):
    """Rank body: rank 1 raises at once (``argv[1] == "raise"``) or sleeps
    past any test's limit ("hang"); rank 0 waits in an all-reduce."""
    import torch.distributed as dist
    from sloika_tpu_torch.parallel import mesh
    mesh.maybe_init_distributed("cpu")
    if mesh.rank() == 1:
        if argv[1] == "raise":
            raise RuntimeError("rank 1 fails on purpose")
        time.sleep(3600)
    dist.all_reduce(torch.ones(1))
    return 0


def gather_ranks(argv):
    """Rank body: every gather of ``parallel.multihost`` on uneven
    payloads; writes rank<r>.json."""
    from sloika_tpu_torch.parallel import mesh, multihost
    mesh.maybe_init_distributed("cpu")
    r, items = mesh.rank(), list(range(7))
    share = multihost.process_shard(items, with_indices=True)
    recs = [(i, {"a": np.arange(i + 1, dtype=np.int64) * 10,
                 "s": np.frombuffer(b"x" * i, np.uint8)}) for i, _ in share]
    got = multihost.gather_indexed_arrays(recs)
    res = {
        "share": share,
        "indexed": [[i, {k: v.tolist() for k, v in rec.items()}]
                    for i, rec in got],
        "allgather": [b.decode() for b in multihost.allgather_bytes(
            ("r%d" % r).encode() * (r + 1))],
        "to_rank0": multihost.gather_bytes_to_rank0(
            b"" if r == 1 else ("p%d" % r).encode()),
        "records": multihost.allgather_records([[r, "x" * r]]),
    }
    if res["to_rank0"] is not None:
        res["to_rank0"] = [b.decode() for b in res["to_rank0"]]
    with open(os.path.join(argv[0], "rank{}.json".format(r)), "w") as fh:
        json.dump(res, fh)
    return 0
