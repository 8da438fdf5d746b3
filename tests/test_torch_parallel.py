"""The port's process-group layer on its own (jax-free, so its GPU tests run
on the card's machine): the gathers of ``parallel.multihost`` in two gloo
ranks and in one process, a failed or hung rank ending the launcher within
its time limit, the launcher's world size held to the flag, and on the
card, that a gloo group refuses K > 1 steps a CUDA graph and that an NCCL
group's all-reduce is captured in one.

The ranks are spawned by ``parallel.spawn.run``; their bodies are in
``tests/torch_parallel_worker.py``.
"""
import datetime
import json
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sloika_tpu_torch.parallel import mesh, multihost, spawn
import torch_parallel_worker as W

SPAWN_TIMEOUT = 240


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def test_gathers_in_two_ranks(tmp_path):
    assert spawn.run(W.gather_ranks, [str(tmp_path)], 2,
                     timeout=SPAWN_TIMEOUT) == 0
    got = [json.load(open(tmp_path / "rank{}.json".format(r)))
           for r in (0, 1)]
    assert [g["share"] for g in got] == [
        [[i, i] for i in range(0, 7, 2)], [[i, i] for i in range(1, 7, 2)]]
    # rank 0 holds every read's record, in read order; rank 1 none
    assert [i for i, _ in got[0]["indexed"]] == list(range(7))
    for i, rec in got[0]["indexed"]:
        assert rec == {"a": list(range(0, 10 * (i + 1), 10)),
                       "s": [ord("x")] * i}
    assert got[1]["indexed"] == []
    for g in got:
        assert g["allgather"] == ["r0", "r1r1"]
        assert g["records"] == [[0, ""], [1, "x"]]
    assert got[0]["to_rank0"] == ["p0", ""]
    assert got[1]["to_rank0"] is None


def test_one_process_gathers_are_the_identity():
    assert not mesh.active()
    recs = [(3, {"a": np.ones(2)}), (1, {"a": np.zeros(1)})]
    assert [i for i, _ in multihost.gather_indexed_arrays(recs)] == [1, 3]
    assert multihost.allgather_bytes(b"xy") == [b"xy"]
    assert multihost.gather_bytes_to_rank0(b"xy") == [b"xy"]
    assert multihost.allgather_records([[1, 2]]) == [[1, 2]]
    assert multihost.process_shard("abc", with_indices=True) == [
        (0, "a"), (1, "b"), (2, "c")]
    assert mesh.local_batch(np.arange(6).reshape(1, 6)).shape == (1, 6)
    assert mesh.all_reduce_grads([], torch.ones(2)).tolist() == [1.0, 1.0]
    assert mesh.agree(5) == 5 and mesh.describe("cpu") == "cpu"


@pytest.mark.parametrize("how,code,limit", [("raise", 1, SPAWN_TIMEOUT),
                                            ("hang", 124, 5)])
def test_a_failed_rank_ends_the_launcher(how, code, limit, capfd):
    """Rank 1 raises (or hangs) while rank 0 waits in an all-reduce: the
    launcher stops both ranks and exits non-zero, naming rank 1, well
    within its limit."""
    t0 = time.monotonic()
    rc = spawn.run(W.fail_ranks, ["", how], 2, timeout=limit)
    took = time.monotonic() - t0
    err = capfd.readouterr().err
    assert rc == code
    assert took < (60 if how == "raise" else limit + 30)
    if how == "raise":
        assert "rank 1 raised" in err and "fails on purpose" in err
    else:
        assert "rank(s) [0, 1] did not finish within 5 s" in err


def test_the_launchers_world_size_is_held_to_the_flag(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert mesh.launched()
    with pytest.raises(ValueError, match="asks for 3 devices but the "
                                         "launcher started WORLD_SIZE=2"):
        mesh.launch(W.fail_ranks, [], 3, "cpu")
    assert not mesh.active()


def _one_rank_group(tmp_path, backend):
    dist.init_process_group(backend, init_method="file://{}".format(
        tmp_path / "store"), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))


@pytest.mark.gpu
def test_gloo_refuses_a_cuda_graph_of_steps(cuda_device, tmp_path):
    """Ranks sharing a card run gloo, whose all-reduce a CUDA graph cannot
    hold: K = 2 on the card raises, K = 1 trains."""
    from sloika_tpu_torch import training
    _one_rank_group(tmp_path, "gloo")
    try:
        with pytest.raises(ValueError, match="gloo all-reduce cannot be "
                                             "captured"):
            training.train(W.training_model(), W.training_data(),
                           device="cuda", **W.train_kwargs(2))
        _, hist = training.train(W.training_model(), W.training_data(),
                                 device="cuda", **W.train_kwargs(1))
        assert np.isfinite(hist).all()
    finally:
        mesh.shutdown()


@pytest.mark.gpu
def test_nccl_all_reduce_is_captured_in_the_group_graph(cuda_device,
                                                        tmp_path,
                                                        monkeypatch):
    """One rank of an NCCL group: two groups of K = 2 steps, each
    all-reduce captured in the CUDA graph, give the bits of 4 eager steps
    (cuDNN's deterministic algorithms, as tests/test_torch_train_graph.py
    holds them)."""
    from sloika_tpu_torch import training
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    _one_rank_group(tmp_path, "nccl")
    try:
        kw = dict(W.train_kwargs(2), niteration=4, data_on_device=False)
        layers, stats = [W.training_model(), W.training_model()], {}
        training.train(layers[0], W.training_data(), device="cuda",
                       stats=stats, **kw)
        training.train(layers[1], W.training_data(), device="cuda",
                       **dict(kw, steps_per_dispatch=1))
        assert stats["replays"] == 2
        for p, q in zip(layers[0].parameters(), layers[1].parameters()):
            assert torch.equal(p, q)
    finally:
        mesh.shutdown()

