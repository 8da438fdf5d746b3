"""The port's multi-device layer against the JAX package's (CPU): the host
helpers it copies (``iterators``, ``parallel.imap``), the read share and
the batch slice for world sizes 1-4, and data-parallel training in two
gloo ranks against one process of the port and the JAX package's
single-device train step on the same numpy-made global batches.

The ranks are spawned by ``parallel.spawn.run`` with a time limit; their
bodies are in ``tests/torch_parallel_worker.py``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sloika_tpu.nn as jnn
from sloika_tpu import iterators as jit_
from sloika_tpu import optim as joptim
from sloika_tpu import training as jtraining
from sloika_tpu.parallel import imap as jimap
from sloika_tpu.parallel import mesh as jmesh
from sloika_tpu.parallel import multihost as jmh
from sloika_tpu_torch import iterators as tit
from sloika_tpu_torch import training as ttraining
from sloika_tpu_torch.parallel import imap as timap
from sloika_tpu_torch.parallel import mesh as tmesh
from sloika_tpu_torch.parallel import multihost as tmh
from sloika_tpu_torch.parallel import spawn
import torch_parallel_worker as W

RTOL = 1e-5          # tests/test_multihost.py:70
SPAWN_TIMEOUT = 240


@pytest.mark.parametrize("name,args", [
    ("empty_iterator", ([],)), ("empty_iterator", ([3, 1],)),
    ("take", (2, [5, 6, 7])), ("take", (4, [5])),
    ("window", ([1, 2, 3, 4], 2)), ("window", ([1, 2], 3)),
    ("centered_truncated_window", ([1, 2, 3, 4, 5], 3)),
    ("centered_truncated_window", ([1, 2, 3, 4], 4)),
    ("blocker", (range(7), 3)), ("blocker", ([], 2)),
    ("pairwise", ([1, 2, 3],)), ("window", ([1], 0)),
])
def test_iterators_equal_jax(name, args):
    def run(mod):
        try:
            got = getattr(mod, name)(*args)
            if name == "empty_iterator":
                return got[0], list(got[1])
            return list(got)
        except ValueError as e:
            return "ValueError", str(e)
    assert run(tit) == run(jit_)


def _square_or_fail(x, offset=0, scale=1):
    if x == 3:
        raise KeyError(x)
    return (x * x + offset) * scale


@pytest.mark.parametrize("kw", [
    {}, {"threads": 3}, {"fix_args": (2,), "threads": 2},
    {"fix_kwargs": {"scale": 3}}, {"pass_exception": True, "threads": 2},
    {"threads": 3, "unordered": True},
])
def test_imap_equal_jax(kw):
    args = [0, 1, 2, 4, 5] + ([3] if kw.get("pass_exception") else [])
    seen = []
    init = {"init": seen.append, "initargs": ("ready",)}

    def run(mod):
        got = list(mod.imap_mp(_square_or_fail, args, **kw, **init))
        return sorted(got, key=repr) if kw.get("unordered") else got

    assert run(timap) == run(jimap)
    assert seen == ["ready", "ready"]
    with pytest.raises(KeyError):
        list(timap.imap_mp(_square_or_fail, [3]))


@pytest.mark.parametrize("nproc", [1, 2, 3, 4])
def test_process_shard_and_batch_slice_equal_jax(nproc, monkeypatch):
    items = ["r{}".format(i) for i in range(11)]
    for pid in range(nproc):
        monkeypatch.setattr(jax, "process_index", lambda: pid)
        monkeypatch.setattr(jax, "process_count", lambda: nproc)
        monkeypatch.setattr(tmesh, "rank", lambda: pid)
        monkeypatch.setattr(tmesh, "world_size", lambda: nproc)
        for with_indices in (False, True):
            assert (tmh.process_shard(items, with_indices)
                    == jmh.process_shard(items, with_indices))
        for B in (8, 12, 100):
            assert tmesh.local_batch_slice(B) == jmesh.local_batch_slice(B)
            a = np.arange(3 * B * 2).reshape(3, B, 2)
            assert np.array_equal(tmesh.local_batch(a),
                                  a[:, jmesh.local_batch_slice(B)])
    assert tmesh.round_up(13, 4) == jmesh.round_up(13, 4) == 16


def _jax_losses(params):
    """The JAX package's single-device step (and its K-step fused step) on
    the global batches, from the same weights."""
    layer = jnn.Serial([jnn.Gru(1, W.WIDTH, has_bias=True),
                        jnn.Softmax(W.WIDTH, W.NSTATE, has_bias=True)])
    params = jax.tree_util.tree_map(jnp.asarray, params)
    opt_init, opt_update = joptim.adamski()
    opt_state = opt_init(params)
    step = jtraining.make_train_step(layer, opt_update, min_prob=1e-30,
                                     drop=W.DROP)
    out = []
    batches = W.global_batches(W.STEPS + W.K)
    for x, labels, weights in batches[:W.STEPS]:
        params, opt_state, loss, acc = step(
            params, opt_state, x, labels.astype(np.int32), weights,
            jnp.float32(W.LR))
        out.append((float(loss), float(acc)))
    mstep = jtraining.make_train_multi_step(layer, opt_update,
                                            min_prob=1e-30, drop=W.DROP)
    rest = batches[W.STEPS:]
    params, opt_state, loss, acc = mstep(
        params, opt_state, np.stack([b[0] for b in rest]),
        np.stack([b[1] for b in rest]).astype(np.int32),
        np.stack([b[2] for b in rest]),
        jnp.full((W.K,), W.LR, jnp.float32))
    out.extend(zip(map(float, loss), map(float, acc)))
    return np.asarray(out)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_ranks")
    rc = spawn.run(W.train_ranks, [str(out)], 2, timeout=SPAWN_TIMEOUT)
    assert rc == 0
    ranks = [dict(np.load(out / "rank{}.npz".format(r))) for r in (0, 1)]
    return out, ranks


def test_two_ranks_step_equal_one_process_and_jax(two_ranks):
    """4 single steps and a group of 2 in two ranks: parameters bit-equal
    on both ranks (rank 1 started from other weights, and takes rank 0's),
    losses within 1e-5 of one process of the port and of the JAX package's
    step, and the accuracy the global ratio (the ranks' blocks hold
    different counts of valid labels)."""
    _, ranks = two_ranks
    names = [k for k in ranks[0] if k.startswith("steps/")]
    assert names
    for k in names:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    assert np.array_equal(ranks[0]["steps"], ranks[1]["steps"])

    layer = W.small_model(seed=0)
    jax_hist = _jax_losses(layer.param_tree())
    one = W.steps(layer)
    got = ranks[0]["steps"]
    np.testing.assert_allclose(got[:, 0], one[:, 0], rtol=RTOL)
    np.testing.assert_allclose(got[:, 0], jax_hist[:, 0], rtol=RTOL)
    np.testing.assert_array_equal(got[:, 1], one[:, 1])
    np.testing.assert_allclose(got[:, 1], jax_hist[:, 1], rtol=RTOL)
    for n, p in W.params_of(layer).items():
        np.testing.assert_allclose(ranks[0]["steps/" + n], p, rtol=0,
                                   atol=1e-5, err_msg=n)
    # the mean of the blocks' ratios is not the global ratio
    x, labels, weights = W.global_batches(1)[0]
    valid = (weights > 0)[W.DROP:-W.DROP]
    assert valid[:, :W.B // 2].sum() != valid[:, W.B // 2:].sum()


@pytest.mark.parametrize("k", [1, 2])
def test_two_ranks_train_equal_one_process(two_ranks, k):
    """``training.train`` in two ranks (K = 1, and K = 2 a group of eager
    steps on the CPU): the same history on both ranks, within 1e-5 of one
    process; the same parameters on both ranks; only rank 0 wrote the
    output directory, and its final checkpoint holds them."""
    from sloika_tpu_torch import serialize
    out, ranks = two_ranks
    layer = W.training_model(seed=0)
    _, hist = ttraining.train(layer, W.training_data(), device="cpu",
                              **W.train_kwargs(k))
    tag = "train{}".format(k)
    assert np.array_equal(ranks[0][tag], ranks[1][tag])
    np.testing.assert_allclose(ranks[0][tag][:, 0], hist[:, 0], rtol=RTOL)
    names = [n for n in ranks[0] if n.startswith(tag + "/")]
    for n in names:
        assert np.array_equal(ranks[0][n], ranks[1][n]), n
    ckpts = ["model_checkpoint_00000.npz", "model_checkpoint_00001.npz",
             "model_final.npz"]
    assert sorted(p.name for p in (out / tag).iterdir()) == sorted(
        ["model.log"] + ckpts + [c + ".json" for c in ckpts])
    saved = serialize.load_checkpoint(str(out / tag / "model_final.npz"))[0]
    for n, p in W.params_of(saved).items():
        assert np.array_equal(p, ranks[0][tag + "/" + n]), n


def test_resident_chunk_set_needs_one_rank(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        assert "single rank (have 2)" in str(r["refused"])


def test_one_process_train_is_unchanged_by_the_group_code():
    """Without a group the step is the one-device step: bit-equal
    histories from ``make_train_step`` and ``train``'s eager groups."""
    a, b = W.small_model(0), W.small_model(0)
    np.testing.assert_array_equal(W.steps(a), W.steps(b))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert np.array_equal(p.detach().numpy(), q.detach().numpy()), n
    assert list(itertools.islice(tit.blocker(range(3), 2), 1)) == [[0, 1]]
