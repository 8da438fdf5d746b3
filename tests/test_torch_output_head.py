"""The basecaller's output head as one kernel (``ops/output_head.py``,
``csrc/output_head.cu``): its plain version against ``Softmax.forward``
followed by the Basecaller's floor and mask, the dispatch, the plan, and on
the card the kernel against the plain version and its launch count on each
basecall route.

This file imports no jax, so the ``gpu``-marked tests run on a machine with
a CUDA card and without jax::

    python -m pytest tests/test_torch_output_head.py -m gpu --noconftest -q
"""
import numpy as np
import pytest
import torch

from sloika_tpu_torch import basecall, config, models, nn, training
from sloika_tpu_torch.ops import output_head as oh
from sloika_tpu_torch.variables import nstate

#: the shared shape of the CPU tests: frames, batch rows, features, kmer
#: length (K = 65 states) and each row's frames: one of none, one of all
T, B, I, KLEN = 23, 6, 12, 3
LENGTHS = (23, 0, 11, 1, 17, 22)
#: float32's unit roundoff
U = 2.0 ** -24


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _network(nbase=4):
    return models.network_factory("raw_1_00_rGr")(
        klen=KLEN, sd=0.5, nbase=nbase, winlen=3, stride=5,
        sizes=(8, 8, 8, I))


def _inputs(T=T, B=B, I=I, K=nstate(KLEN), lengths=LENGTHS, seed=7):
    """numpy-made x (T, B, I), W (K, I), b (K,) and out_lengths (B,): the
    logits spread over ~3 nats a state, as a trained head's do."""
    rs = np.random.RandomState(seed)
    x = rs.normal(size=(T, B, I)).astype(np.float32)
    W = (2.0 * rs.normal(size=(K, I)) / np.sqrt(I)).astype(np.float32)
    b = rs.normal(size=K).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(b),
            torch.tensor(lengths, dtype=torch.int64))


def _softmax(W, b):
    layer = nn.Softmax(W.shape[1], W.shape[0], has_bias=True)
    layer.load_param_tree({"W": W.numpy(), "b": b.numpy()})
    return layer


@pytest.mark.parametrize("post_dtype", [torch.float32, torch.bfloat16])
def test_plain_head_equals_softmax_then_floor_mask(post_dtype):
    """Bit for bit, the zero-length row's every frame a stay and the
    full-length row's none."""
    x, W, b, lengths = _inputs()
    caller = basecall.Basecaller(_network(), KLEN, device="cpu",
                                 post_dtype=str(post_dtype).split(".")[1])
    with torch.inference_mode():
        ref = caller._floor_mask(_softmax(W, b)(x), lengths)
        got = oh.output_head_plain(x, W, b, lengths, caller.min_prob,
                                   post_dtype)
    assert got.dtype == post_dtype and got.is_contiguous()
    assert torch.equal(got, ref)
    stay = torch.zeros(W.shape[0], dtype=post_dtype)
    stay[0] = 1
    assert all(torch.equal(got[t, 1], stay) for t in range(T))
    assert not any(torch.equal(got[t, 0], stay) for t in range(T))
    assert torch.equal(got[LENGTHS[2]:, 2], stay.expand(T - LENGTHS[2], -1))


def test_plain_head_under_bf16_compute_rounds_as_affine(monkeypatch):
    """Under bfloat16 compute the plain head's product is
    ``nn.core.affine``'s: x and W rounded to bfloat16."""
    monkeypatch.setattr(config, "compute_dtype", torch.bfloat16)
    x, W, b, lengths = _inputs()
    with torch.inference_mode():
        ref = basecall.Basecaller(_network(), KLEN, device="cpu")._floor_mask(
            _softmax(W, b)(x), lengths)
        got = oh.output_head_plain(x, W, b, lengths, 1e-5, torch.bfloat16)
    assert torch.equal(got, ref)


def test_wrapper_hands_cpu_tensors_to_the_plain_head():
    x, W, b, lengths = _inputs()
    before = oh.output_head.launches
    with torch.inference_mode():
        got = oh.output_head(x, W, b, lengths, 1e-5, torch.float32)
        ref = oh.output_head_plain(x, W, b, lengths, 1e-5, torch.float32)
    assert torch.equal(got, ref)
    assert oh.output_head.launches == before
    with pytest.raises(ValueError):
        oh.output_head(x, W, b, lengths, 1e-5, torch.float16)


def test_the_cpu_keeps_todays_path():
    """On the CPU the Basecaller runs the whole network, then the floor
    and mask; the wrapper is never called."""
    layer = _network()
    caller = basecall.Basecaller(layer, KLEN, device="cpu")
    assert caller._head is None
    rs = np.random.RandomState(2)
    xs = torch.from_numpy(rs.normal(size=(60, 3, 1)).astype(np.float32))
    lengths = torch.tensor([60, 31, 7])
    before = oh.output_head.launches
    with torch.inference_mode():
        got, got_len = caller._floored_masked_post(xs, lengths)
        post, ref_len = layer.apply_with_lengths(xs, lengths)
        ref = caller._floor_mask(post, ref_len)
    assert torch.equal(got, ref) and torch.equal(got_len, ref_len)
    assert oh.output_head.launches == before


def test_terminal_softmax_runs_the_layers_before_it():
    """``body`` is the network's ``apply_with_lengths`` up to its Softmax,
    reached through nested ``Serial``s, and the head is that Softmax."""
    layer = _network()
    nested = nn.Serial([layer.layers[0], nn.Serial(list(layer.layers[1:]))])
    rs = np.random.RandomState(3)
    xs = torch.from_numpy(rs.normal(size=(50, 2, 1)).astype(np.float32))
    lengths = torch.tensor([50, 24])
    for net in (layer, nested):
        body, softmax = oh.terminal_softmax(net)
        assert softmax is layer.layers[-1]
        with torch.inference_mode():
            h, h_len = body(xs, lengths)
            post, post_len = net.apply_with_lengths(xs, lengths)
            assert torch.equal(softmax(h), post)
        assert torch.equal(h_len, post_len)
    body, softmax = oh.terminal_softmax(layer.layers[-1])
    assert softmax is layer.layers[-1]
    assert body(xs, lengths) == (xs, lengths)


@pytest.mark.parametrize("tail", ["feed-forward", "parallel", "reverse"])
def test_a_network_not_ending_in_a_softmax_keeps_todays_path(tail):
    K = nstate(KLEN)
    head = {"feed-forward": nn.FeedForward(I, K, has_bias=True),
            "parallel": nn.Parallel([nn.Softmax(I, K - 1),
                                     nn.FeedForward(I, 1)]),
            "reverse": nn.Reverse(nn.Softmax(I, K))}[tail]
    net = nn.Serial(list(_network().layers[:-1]) + [head])
    assert oh.terminal_softmax(net) is None
    assert oh.terminal_softmax(head) is None
    assert basecall.Basecaller(net, KLEN, device="cpu")._head is None


def test_the_training_loss_still_takes_terminal_softmax_logits(monkeypatch):
    """The loss reads logits through ``terminal_softmax_logits`` and never
    reaches the head."""
    layer = _network()
    logits_fn = training.terminal_softmax_logits(layer)
    assert logits_fn is not None

    def refuse(*args, **kw):
        raise AssertionError("the training loss called the output head")

    monkeypatch.setattr(oh, "output_head", refuse)
    monkeypatch.setattr(oh.OutputHead, "__call__", refuse)
    rs = np.random.RandomState(4)
    xs = torch.from_numpy(rs.normal(size=(40, 3, 1)).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, nstate(KLEN), size=(8, 3)))
    loss, acc = training.make_loss_fn(layer, min_prob=1e-5)(
        xs, labels, torch.ones(8, 3))
    body, softmax = oh.terminal_softmax(layer)
    with torch.no_grad():
        h, _ = body(xs, torch.full((3,), 40))
        assert torch.equal(logits_fn(xs), softmax.logits(h))
    assert torch.isfinite(loss) and 0.0 <= float(acc) <= 1.0


@pytest.mark.parametrize("I_", [64, 96, 112, 144])
def test_plan_routes_by_k_and_fits(I_):
    """The logits of a block's 32 rows stay on chip up to K ~1,150; past
    that the product runs twice.  Every plan fits the card's shared
    memory; W^T's rows are 16-byte aligned and its depth a whole number of
    stages; the whole tiles are 64 states wide."""
    for K, route in ((17, "stash"), (82, "stash"), (257, "stash"),
                     (1025, "stash"), (3126, "recompute"),
                     (4097, "recompute"), (65537, "recompute")):
        plan = oh.output_head_plan(K, I_)
        assert plan["route"] == route
        assert plan["smem"] <= oh.SMEM_OPTIN
        assert plan["Kp"] % 4 == 0 and K <= plan["Kp"] < K + 4
        assert plan["Ip"] % oh.STAGE_K == 0 and I_ <= plan["Ip"]
        assert plan["Kmain"] % oh.WARP_STATES == 0
        assert 0 <= K - plan["Kmain"] < oh.WARP_STATES
        fixed = (oh.ROWS * (plan["Ip"] + 4)
                 + oh.STAGES * oh.STAGE_K * oh.WINDOW + 3 * oh.ROWS
                 + (K - plan["Kmain"]) * plan["Ip"])
        logits = oh.ROWS * (K if route == "stash" else oh.WINDOW + 1)
        assert plan["smem"] == oh.BAR_BYTES + 4 * (fixed + logits)


def test_plan_refuses_rows_that_do_not_fit():
    with pytest.raises(ValueError):
        oh.output_head_plan(1025, 2000)
    with pytest.raises(ValueError):
        oh.output_head_plan(0, 112)


# -- on the card --------------------------------------------------------------

def _gamma(n):
    return n * U / (1 - n * U)


def _tolerance(x, W, b, ref, bf16_out, product_slack=1.0):
    """The largest |kernel - plain| the two may differ by: only the orders
    of the product's and the row sum's summations differ.  Each side's
    logit lies within gamma_{I+1} sum_k |x_k W_ck| + |b_c| of the exact one,
    so a softmax value moves by a factor of at most exp(2 delta), delta
    twice that over the row's states; each side's sum of K positive terms
    lies within gamma_K of the exact sum; exp, the divide and the floor's
    two roundings add a few units of roundoff; a bfloat16 store may round
    the two to neighbouring values, one bfloat16 ulp (2^-7 relative)
    apart.  ``product_slack`` widens the product's term where the plain
    version's product runs on the tensor cores (bfloat16 compute)."""
    I_, K = x.shape[2], W.shape[0]
    mag = (x.abs() @ W.abs().t() + b.abs()).amax(dim=2, keepdim=True)
    delta = 2 * product_slack * _gamma(I_ + 1) * mag
    rel = torch.expm1(2 * delta) + 2 * _gamma(K) + 16 * U
    if bf16_out:
        rel = rel + 2.0 ** -7
    return rel * ref.float().abs() + 4 * U


def _against_plain(dev, K, I_, post_dtype, T_=37, B_=7,
                   lengths=(37, 0, 13, 1, 37, 25, 7), product_slack=1.0):
    x, W, b, ln = (t.to(dev) for t in _inputs(T_, B_, I_, K, lengths,
                                              seed=K + I_))
    before = oh.output_head.launches
    with torch.inference_mode():
        got = oh.output_head(x, W, b, ln, 1e-5, post_dtype)
        ref = oh.output_head_plain(x, W, b, ln, 1e-5, post_dtype)
    torch.cuda.synchronize()
    assert oh.output_head.launches == before + 1
    assert got.dtype == post_dtype and got.shape == (T_, B_, K)
    mask = torch.arange(T_, device=dev)[:, None] < ln[None, :]
    # the stays bit for bit
    assert torch.equal(got[~mask], ref[~mask])
    tol = _tolerance(x, W, b, ref, post_dtype == torch.bfloat16,
                     product_slack)
    d = (got.float() - ref.float()).abs()
    assert bool(torch.isfinite(got.float()).all())
    assert bool((d <= tol).all()), float((d - tol).max())
    return got, ref


@pytest.mark.gpu
@pytest.mark.parametrize("post_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("I_", [64, 96, 112, 144])
@pytest.mark.parametrize("K", [82, 1025, 3126, 4097])
def test_kernel_equals_the_plain_head(cuda_device, K, I_, post_dtype):
    _against_plain(cuda_device, K, I_, post_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1025, 4097])
def test_kernel_under_bf16_compute(cuda_device, monkeypatch, K):
    """x and W rounded to bfloat16, products summed in float32; the plain
    version's product runs on the tensor cores, whose float32 sums align
    their addends less exactly: twice the product's term."""
    monkeypatch.setattr(config, "compute_dtype", torch.bfloat16)
    _against_plain(cuda_device, K, 112, torch.bfloat16, product_slack=2.0)


@pytest.mark.gpu
def test_kernel_at_a_batch_of_whole_padded_blocks(cuda_device):
    """Rows past 3 frames everywhere: from frame 3 on whole blocks of 32
    rows are padding, which skip the product and write stays; an odd
    feature count takes the scalar loads."""
    _against_plain(cuda_device, 1025, 13, torch.float32, T_=40, B_=32,
                   lengths=(3,) * 31 + (1,))


def _route_reads():
    rs = np.random.RandomState(3)
    return [(rs.randint(1500, 2500, size=n).astype(np.int16),
             (10.0, 0.15, 300.0, 30.0)) for n in (300, 520, 150)]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["dac", "chunked_states", "whole"])
def test_one_launch_a_batch_on_each_route(cuda_device, route):
    """``OutputHead.launches`` counts one launch a batch, and the calls
    are the CPU route's."""
    layer = _network()
    reads = _route_reads()
    kw = {"dac": dict(chunked=True, output="bases", chunk_size=200,
                      overlap=20),
          "chunked_states": dict(chunked=True, chunk_size=200, overlap=20),
          "whole": {}}[route]
    if route == "whole":
        nbatch = 2
    else:
        nbatch = -(-len(basecall._window_jobs([len(d) for d, _ in reads],
                                              200, 20)) // 2)
    signals = [basecall.normalise_dac_f32(d, n) for d, n in reads]
    out = {}
    for dev in ("cpu", cuda_device):
        caller = basecall.Basecaller(layer, KLEN, batch_size=2, device=dev,
                                     **kw)
        assert (caller._head is None) == (dev == "cpu")
        oh.output_head.launches = 0
        out[str(dev)] = (caller.basecall_dac_reads(reads) if route == "dac"
                         else caller.basecall_signals(signals))
        torch.cuda.synchronize()
        assert oh.output_head.launches == (0 if dev == "cpu" else nbatch)
    for (s0, c0), (s1, c1) in zip(*out.values()):
        assert np.array_equal(c0, c1)
        assert abs(s0 - s1) <= 1e-4 * abs(s0)
