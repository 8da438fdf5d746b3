"""Transducer training for the port (cf. ``sloika_tpu/training.py``).

The step is the JAX package's step (``training.py:109-172``):

* a weighted cross-entropy computed from logits (fused log-softmax) with
  the ``min_prob`` floor applied in log space, ``drop`` edge trimming and
  an optional L2 penalty; accuracy over positions with nonzero weight;
* gradients by autograd, through :class:`~sloika_tpu_torch.nn.fused_gru.
  GruFunction` for each GRU (the CUDA forward and backward kernels on the
  GPU, their plain twins on the CPU);
* ADAMski (default), Adam or SGD from :mod:`sloika_tpu_torch.optim`.

:func:`train` is the JAX package's training loop.  It draws the same
batches from the same seed (:class:`ChunkSampler` is a verbatim copy) and
writes the same ``model.log`` lines and checkpoints.  With
``steps_per_dispatch`` K > 1 (a fixed chunk length) it runs K optimiser
steps a group: on a CUDA device one replay of a CUDA graph of the K
forward, backward and update steps (:class:`GroupGraph`), fed by one copy of
the group's stacked batches or, with the chunk set resident on the device,
of its sampler indices; on the CPU, K eager steps.  A worker thread
prefetches the next group.  :func:`validate` is its held-out evaluation.

Under a process group (:mod:`sloika_tpu_torch.parallel.mesh`, one rank a
device) training is data-parallel as the JAX package's over its mesh
(``sloika_tpu/training.py:112-142, 483, 523, 562, 581-620``): the sampler's
batch is a multiple of the world size, every rank draws the same global
batch from the shared seed and steps on its contiguous block of it, and
between each backward and the update one all-reduce of a flat buffer
averages the gradients and sums the step's loss, correct and valid
counts, so the loss reported is the global batch's mean and the accuracy
its Σcorrect / Σvalid.  Parameters start as rank 0's.  Only rank 0 writes
checkpoints, the log and a profile.  A resident chunk set needs a single
rank.  Under NCCL the all-reduce is captured in each group's CUDA graph; a
gloo collective cannot be, so K > 1 on a card under gloo (ranks sharing a
card) raises.

The numpy-only helpers below are copied, with their source lines, because
``sloika_tpu/training.py`` imports jax.
"""
import os
import socket
import sys
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from sloika_tpu_torch import config, optim, serialize, tracing
from sloika_tpu_torch.nn.combinators import Serial
from sloika_tpu_torch.nn.layers import Softmax
from sloika_tpu_torch.parallel import mesh


class ExponentialSmoother(object):
    """Exponentially smoothed metric (``sloika_tpu/training.py:31-46``)."""

    def __init__(self, factor, val=0.0, weight=1e-30):
        assert 0.0 <= factor <= 1.0
        self.factor = factor
        self.val = val
        self.weight = weight

    @property
    def value(self):
        return self.val / self.weight

    def update(self, val, weight=1.0):
        self.val = self.factor * self.val + (1.0 - self.factor) * val
        self.weight = self.factor * self.weight + (1.0 - self.factor) * weight


def remove_blanks(labels):
    """Propagate the previous label into blanks (non-transducer training;
    ``sloika_tpu/training.py:49-57``)."""
    out = labels.copy()
    for lbl in out:
        nz = np.arange(len(lbl)) * (lbl != 0)
        np.maximum.accumulate(nz, out=nz)
        lbl[:] = np.where(lbl == 0, lbl[nz], lbl)
    return out


class Logger(object):
    """Unbuffered tee to a log file and stdout
    (``sloika_tpu/training.py:60-72``), with a ``close``."""

    def __init__(self, log_file_name=None, quiet=False):
        self.fh = open(log_file_name, 'wb', 0) if log_file_name else None
        self.quiet = quiet

    def write(self, message):
        if not self.quiet:
            sys.stdout.write(message)
            sys.stdout.flush()
        if self.fh is not None:
            self.fh.write(message.encode('utf-8'))

    def close(self):
        if self.fh is not None:
            self.fh.close()
            self.fh = None


def apply_bad_mask(all_labels, all_bad):
    """Zero (blank) labels marked bad (``sloika_tpu/training.py:303-314``).
    Raw pipelines store the bad mask at sample resolution while labels are
    stride-downsampled; a label is bad if any sample in its block is bad."""
    all_labels = all_labels.copy()
    if all_bad.shape != all_labels.shape:
        stride = all_bad.shape[1] // all_labels.shape[1]
        all_bad = (all_bad[:, :all_labels.shape[1] * stride]
                   .reshape(all_bad.shape[0], all_labels.shape[1], stride)
                   .any(axis=2))
    all_labels[all_bad] = 0
    return all_labels


class ChunkSampler(object):
    """Weighted chunk/window sampler with a bucketed chunk-length curriculum
    (verbatim from ``sloika_tpu/training.py:317-387``: its ``RandomState``
    stream decides the batches, so one seed trains the same batches in both
    packages).

    Reference behaviour (train_network.py:288-306): per batch, sample a
    random chunk length in [min_chunk, max_chunk] rounded to the stride,
    scale batch size inversely, pick a random window start, and draw chunks
    weighted without replacement.  Lengths are bucketed to ``n_buckets``
    static values.
    """

    def __init__(self, data, batch_size, min_chunk, max_chunk, stride,
                 label_weights, seed=None, n_buckets=4, device_multiple=1):
        self.chunks = data["chunks"]
        self.labels = data["labels"]
        self.weights = data["weights"]
        self.batch_size = batch_size
        self.stride = stride
        self.label_weights = label_weights
        self.rs = np.random.RandomState(seed)
        self.max_batch_size = int((self.weights > 0).sum())
        self.device_multiple = device_multiple

        lengths = np.unique(np.linspace(min_chunk, max_chunk, n_buckets)
                            .astype(int) // stride * stride)
        self.bucket_lengths = lengths[lengths >= stride]
        self.max_chunk = max_chunk
        self.data_chunk = self.chunks.shape[1]

    def sample_indices(self):
        """Draw one batch's (chunk indices, window start, chunk length).

        :returns: (idx (B,) int, start int, chunk_len int)
        """
        chunk_len = int(self.rs.choice(self.bucket_lengths))
        batch_size = int(self.batch_size * float(self.max_chunk) / chunk_len)
        batch_size = min(batch_size, self.max_batch_size)
        batch_size = max(self.device_multiple,
                         batch_size // self.device_multiple * self.device_multiple)

        start = self.rs.randint(self.data_chunk - chunk_len + 1)
        start -= start % self.stride

        # sampling is without replacement while the nonzero-weight
        # population allows it; a tiny dataset on a wide mesh (population <
        # device multiple) falls back to with-replacement so the batch can
        # still fill every device shard
        replace = batch_size > self.max_batch_size
        idx = np.sort(self.rs.choice(len(self.chunks), size=batch_size,
                                     replace=replace, p=self.weights))
        return idx, start, chunk_len

    def materialise(self, idx, start, chunk_len):
        """Build the host arrays for a draw from :meth:`sample_indices`."""
        label_lb = start // self.stride
        label_ub = (start + chunk_len) // self.stride
        x = np.ascontiguousarray(
            self.chunks[idx, start:start + chunk_len].transpose((1, 0, 2)))
        labels = np.ascontiguousarray(
            self.labels[idx, label_lb:label_ub].transpose())
        weights = self.label_weights[labels]
        return x, labels, weights

    def sample(self):
        """Draw one time-major training batch.

        :returns: (x (T, B, F), labels (T', B), weights (T', B))
        """
        return self.materialise(*self.sample_indices())


def label_frequency_weights(all_labels, chunk_weights, ilf=False):
    """Per-label weights; inverse label frequency when ``ilf``
    (``sloika_tpu/training.py:390-401``)."""
    nlabel = int(np.max(all_labels)) + 1
    if not ilf:
        return np.ones(nlabel, dtype='f4')
    label_weights = np.zeros(nlabel, dtype='f4')
    for i, lbls in enumerate(all_labels):
        label_weights += chunk_weights[i] * np.bincount(lbls, minlength=nlabel)
    label_weights = np.reciprocal(label_weights)
    label_weights /= np.mean(label_weights)
    return label_weights


def terminal_softmax_logits(layer):
    """``f(x) -> logits`` when the network ends in a Softmax, else None
    (``sloika_tpu/training.py:75-106``).

    The loss through ``log(softmax(x))`` overflows float32 in the backward
    pass when the labelled posterior falls below ~1e-20; the fused
    log-softmax form has the bounded ``y - onehot`` logit gradient, so the
    loss is computed from logits whenever the terminal layer is a softmax.
    """
    if isinstance(layer, Softmax):
        return layer.logits
    if isinstance(layer, Serial):
        inner = terminal_softmax_logits(layer.layers[-1])
        if inner is None:
            return None

        def apply_logits(x):
            for sub in layer.layers[:-1]:
                x = sub(x)
            return inner(x)

        return apply_logits
    return None


def make_loss_fn(layer, min_prob=0.0, l2=0.0, drop=0, counts=False):
    """Weighted cross-entropy loss + accuracy over time-major batches
    (``sloika_tpu/training.py:109-144``).

    :param counts: return the accuracy's terms, (loss, correct, valid)
    :returns: ``loss_fn(x, labels, weights) -> (loss, acc)`` where x
        (T, B, F); labels (int64), weights (T', B) at label resolution
    """
    ldrop = drop
    udrop = None if drop == 0 else -drop
    logits_fn = terminal_softmax_logits(layer)
    log_min = float(np.log(min_prob)) if min_prob > 0.0 else None
    log1m_min = float(np.log1p(-min_prob))

    def loss_fn(x, labels, weights):
        if logits_fn is not None:
            lpost = torch.log_softmax(logits_fn(x).float(), dim=2)
            if min_prob > 0.0:
                # log(min_prob + (1 - min_prob) * post), computed stably
                lpost = torch.logaddexp(lpost.new_full((), log_min),
                                        log1m_min + lpost)
            post = lpost   # argmax of log-post == argmax of post
        else:
            post = min_prob + (1.0 - min_prob) * layer(x)
            lpost = torch.log(post)
        xent = -torch.gather(lpost, 2, labels[..., None])[..., 0]
        loss = torch.mean((weights * xent)[ldrop:udrop])
        if l2 > 0.0:
            loss = loss + l2 * optim.param_sqr(layer)
        correct = (torch.argmax(post, dim=2) == labels)[ldrop:udrop]
        # accuracy over positions with nonzero weight
        valid = (weights > 0)[ldrop:udrop]
        ncorrect, nvalid = torch.sum(correct & valid), torch.sum(valid)
        if counts:
            return loss, ncorrect, nvalid
        return loss, (ncorrect / torch.clamp(nvalid, min=1)).float()

    return loss_fn


def _backward(layer, loss_fn, x, labels, weights):
    """One step's loss and gradients, the gradients averaged over the
    ranks of a group: (loss, accuracy) of the global batch."""
    params = list(layer.parameters())
    layer.zero_grad(set_to_none=True)
    loss, ncorrect, nvalid = loss_fn(x, labels, weights)
    loss.backward()
    for p in params:
        # a parameter no output reads (MUT3's W_xu and b_u, the peepholes
        # of a scanned LSTM without them): JAX's zero
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if not mesh.active():
        return loss.detach(), (ncorrect / torch.clamp(nvalid, min=1)).float()
    # the loss is a mean over equal blocks: their mean is the global one
    sums = mesh.all_reduce_grads(params, torch.stack(
        [loss.detach(), ncorrect.float(), nvalid.float()]))
    return sums[0] / mesh.world_size(), sums[1] / torch.clamp(sums[2], min=1)


def make_train_step(layer, opt_update, min_prob=0.0, l2=0.0, drop=0):
    """The train step (``sloika_tpu/training.py:147-172``); under a group,
    the data-parallel step over the ranks.

    :returns: ``step(opt_state, x, labels, weights, lr) -> (opt_state,
        loss, acc)``; the layer's parameters are updated in place
    """
    loss_fn = make_loss_fn(layer, min_prob=min_prob, l2=l2, drop=drop,
                           counts=True)

    def step(opt_state, x, labels, weights, lr):
        loss, acc = _backward(layer, loss_fn, x, labels, weights)
        opt_state = opt_update(layer, opt_state, lr)
        return opt_state, loss, acc

    return step


def make_eval_step(layer, min_prob=0.0, drop=0):
    """Loss/accuracy evaluation without updates
    (``sloika_tpu/training.py:285-300``)."""
    loss_fn = make_loss_fn(layer, min_prob=min_prob, l2=0.0, drop=drop)

    def step(x, labels, weights):
        with torch.no_grad():
            return loss_fn(x, labels, weights)

    return step


def _make_optimiser(optimiser, adam):
    if optimiser == "adamski":
        init, update = optim.adamski(decay=(adam[1], adam[2]))
        return init, update, optim.OptState
    if optimiser == "adam":
        init, update = optim.adam(decay=(adam[1], adam[2]))
        return init, update, optim.OptState
    if optimiser == "sgd":
        init, update = optim.sgd(momentum=adam[1])
        return init, update, optim.SGDState
    raise ValueError("unknown optimiser {!r}".format(optimiser))


def _put(dev, *arrays):
    """Host arrays on ``dev``: on a CUDA device copied asynchronously from
    pinned memory (PyTorch's host allocator keeps a pinned block until the
    copy that reads it is done), so the host does not wait on the card."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        tracing.count("h2d_bytes", t.nbytes)
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out.append(t)
    return tuple(out)


def _to_device(batch, dev):
    x, labels, weights = batch
    return _put(dev, x, labels.astype(np.int64), weights)


def gather_batch(chunks_d, labels_d, lwts_d, idx, start, chunk_len, stride):
    """One batch gathered from the chunk set resident on the device
    (``make_train_multi_step_resident``, sloika_tpu/training.py:259-268):
    rows ``idx``, the window at ``start``, time-major.  The elements the
    host sampler copies (:meth:`ChunkSampler.materialise`), so training on
    it is bit-identical to streaming.

    :param chunks_d: (N, Tdata, F) f32;  :param labels_d: (N, Ldata) int64
    :param lwts_d: (nlabel,) f32;  :param idx: (B,) int64
    :param start: 0-d int64 tensor (on the device: no host value is read)
    :returns: (x (chunk_len, B, F), labels (L, B) int64, weights (L, B))
    """
    dev = chunks_d.device
    tidx = start + torch.arange(chunk_len, device=dev)
    x = chunks_d[idx[:, None], tidx[None, :]].transpose(0, 1).contiguous()
    lidx = start // stride + torch.arange(chunk_len // stride, device=dev)
    labels = labels_d[idx[:, None], lidx[None, :]].t().contiguous()
    return x, labels, lwts_d[labels]


def kernel_wrappers():
    """The port's kernel wrappers, whose ``launches`` (and
    ``general_launches``, ``wide_launches``) a graph replay adds to."""
    from sloika_tpu_torch.nn import fused_gru, fused_lstm
    from sloika_tpu_torch.ops import (crf_decode, output_head, remap_kernel,
                                      viterbi_kernel)
    return (fused_gru.gru_forward, fused_gru.gru_backward,
            fused_gru.gru_wgrad, fused_lstm.lstm_forward,
            fused_lstm.lstm_backward, fused_lstm.lstm_wgrad,
            viterbi_kernel.viterbi_forward, viterbi_kernel.viterbi_backtrace,
            remap_kernel.remap_banded, remap_kernel.remap_backtrack,
            output_head.output_head, crf_decode.crf_decode)


_COUNTS = ("launches", "general_launches", "wide_launches")


def _counts():
    return {(w, c): getattr(w, c) for w in kernel_wrappers()
            for c in _COUNTS if hasattr(w, c)}


def _group_body(layer, loss_fn, apply, opt_state, K, batch_at, scalars):
    """K optimiser steps, as ``make_train_step``'s but for the update's
    step-size factors, which are read from ``scalars`` (nscal, K) on the
    device.

    :param loss_fn: a ``make_loss_fn(..., counts=True)``
    :returns: (K, 2) tensor of each step's (loss, accuracy)
    """
    out = []
    for j in range(K):
        loss, acc = _backward(layer, loss_fn, *batch_at(j))
        apply(layer, opt_state, *(s[j] for s in scalars))
        out.append(torch.stack([loss, acc]))
    return torch.stack(out)


class GroupGraph:
    """K optimiser steps captured as one CUDA graph on static buffers.

    The inputs are the group's stacked batches, xs (K, T, B, F), labels and
    weights (K, L, B), or, with ``resident`` = (chunks_d, labels_d, lwts_d)
    on the device, its sampler draws idx (K, B) and starts (K,), gathered in
    the graph (:func:`gather_batch`); and the optimiser's step-size factors
    (nscal, K), computed on the host for each group (``update.scalars``).
    :meth:`run` copies them into the static buffers and replays the graph.

    The capture follows a warm-up of the whole group on a side stream with
    the first group's inputs: it builds and loads every kernel (nvcc runs
    there, never in the capture).  (A launcher's ``cudaFuncSetAttribute``
    is legal in a capture: a captured launch that calls it replays to the
    eager bits on the card.)  The parameters and the
    optimiser's tensors are restored after the warm-up, so the first replay
    takes the first group's steps; the gradients are allocated in the
    graph's memory pool during the capture.  A failed capture raises.

    Under an NCCL group each step's all-reduce is captured too: the warm-up
    group's collectives start the communicator before the capture, and the
    capture runs in the thread-local mode, since ``ProcessGroupNCCL``'s
    watchdog thread queries events while the stream captures (the global
    mode, kept without a group, would fail it).  A gloo collective cannot
    be captured: :func:`train` refuses K > 1 on a card under gloo.

    The wrappers' launch counts do not tick on a replay: the launches
    captured into the graph are counted once (``captured``) and added on
    each replay.
    """

    def __init__(self, layer, loss_fn, apply, opt_state, K, first, scalars,
                 resident=None, chunk_len=None, stride=None):
        self.replays = 0
        dev = scalars.device
        self.static = [torch.empty_like(t) for t in first]
        self.scalars = torch.empty_like(scalars)
        if resident is None:
            xs, labels, weights = self.static
            batch_at = lambda j: (xs[j].clone(), labels[j].clone(),
                                  weights[j].clone())
        else:
            idx, starts = self.static
            batch_at = lambda j: gather_batch(*resident, idx[j], starts[j],
                                              chunk_len, stride)

        def body():
            return _group_body(layer, loss_fn, apply, opt_state, K, batch_at,
                               self.scalars)

        tensors = list(layer.parameters()) + optim.state_tensors(opt_state)
        saved = [t.detach().clone() for t in tensors]
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._load(first, scalars)
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        layer.zero_grad(set_to_none=True)
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        mode = "thread_local" if mesh.active() else "global"
        with torch.cuda.graph(self.graph, capture_error_mode=mode):
            self.out = body()
        after = _counts()
        #: kernel launches in one replay, by (wrapper, counter)
        self.captured = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        for (w, c), n in before.items():
            setattr(w, c, n)

    def _load(self, inputs, scalars):
        for t, v in zip(self.static, inputs):
            t.copy_(v)
        self.scalars.copy_(scalars)

    def run(self, inputs, scalars):
        """One group: (K, 2) (loss, accuracy) of its steps."""
        self._load(inputs, scalars)
        self.graph.replay()
        self.replays += 1
        for (w, c), n in self.captured.items():
            setattr(w, c, getattr(w, c) + n)
        return self.out.clone()


def _group_scalars(opt_update, opt_state, lrs):
    """The step-size factors (nscal, K) of K steps from ``opt_state`` at
    learning rates ``lrs``, and the state after them (its tensors are
    those the steps update in place)."""
    values = []
    for lr in lrs:
        v, opt_state = opt_update.scalars(opt_state, lr)
        values.append(v)
    return np.asarray(values, np.float32).T.copy(), opt_state


def _profile_path(profile_dir):
    """Where JAX's ``profile_dir`` puts a run's trace
    (``plugins/profile/<run>/<host>``), for the Chrome trace."""
    run = time.strftime("%Y_%m_%d_%H_%M_%S")
    path = os.path.join(profile_dir, "plugins", "profile", run)
    os.makedirs(path, exist_ok=True)
    return os.path.join(path, socket.gethostname() + ".pt.trace.json")


def train(layer, data, *, output=None, adam=(1e-3, 0.9, 0.999),
          batch_size=100, chunk_len_range=(0.5, 1.0), drop=20, ilf=False,
          l2=0.0, lrdecay=5000.0, min_prob=1e-30, niteration=50000,
          quiet=False, save_every=5000, seed=None, smooth=0.45,
          transducer=True, bad=True, log=None, opt_state=None,
          n_length_buckets=4, optimiser="adamski", lr_warmup=0,
          steps_per_dispatch=1, prefetch=True, data_on_device="auto",
          profile_dir=None, stats=None, device="cuda"):
    """Train a network on labelled chunks: the JAX package's
    ``training.train`` (``sloika_tpu/training.py:404-753``).  The layer is
    moved to ``device`` and trained in place.

    :param data: dict from
        :func:`sloika_tpu_torch.data.hdf5.load_labelled_chunks`
    :param optimiser: ``"adamski"`` (default), ``"adam"`` or ``"sgd"``
        (``adam[1]`` is then the momentum)
    :param lr_warmup: run the first N iterations at lr 0
    :param steps_per_dispatch: K, optimiser steps a group (a fixed chunk
        length only; else 1, logged): one CUDA graph replay on a card, K
        eager steps on the CPU.  A tail shorter than K runs as single
        steps; a checkpoint lands at the end of the group that crosses
        ``save_every``
    :param prefetch: sample (and copy) the next group on a worker thread,
        in the serial loop's order
    :param data_on_device: "auto" keeps the chunk set on the device for
        K > 1 on a single rank when it fits ``SLOIKA_TPU_RESIDENT_BYTES``
        (read at the call; default 1.2 GB) and gathers the batches there;
        True requires that; False streams the batches
    :param profile_dir: write a ``torch.profiler`` Chrome trace of the
        steady groups (from the second on) under this directory
    :param stats: a dict to fill with the run's K, whether the data was
        resident, the graph's replays and the launches captured in it
        (``{(wrapper, counter): n}``)
    :param opt_state: optimiser state to resume from (e.g. from
        :func:`sloika_tpu_torch.serialize.load_checkpoint`); a state of
        another optimiser's type is logged and replaced by a fresh one
    :param device: torch device, the card unless the caller asks for the
        CPU; a CUDA device without a card raises.  Under a group, "cuda" is
        the rank's card (:func:`~sloika_tpu_torch.parallel.mesh.
        local_device`)
    :returns: (opt_state, history) with history an (niteration, 2) float32
        array of each iteration's (loss, accuracy), the global batch's
    """
    with tracing.span("train"):
        dev = mesh.local_device(device)
        if dev.type == "cuda":
            config.disable_tf32()
        layer.to(dev)
        mesh.broadcast_params(layer)
        lead = mesh.rank() == 0
        if not lead:
            output, profile_dir = None, None
        if output:
            os.makedirs(output, exist_ok=True)
        own_log = log is None
        if own_log:
            log = Logger(os.path.join(output, 'model.log') if output
                         else None, quiet or not lead)
        try:
            return _train(
                layer, data, dev, log, output=output, adam=adam,
                batch_size=batch_size, chunk_len_range=chunk_len_range,
                drop=drop, ilf=ilf, l2=l2, lrdecay=lrdecay,
                min_prob=min_prob, niteration=niteration,
                save_every=save_every, seed=seed, smooth=smooth,
                transducer=transducer, bad=bad, opt_state=opt_state,
                n_length_buckets=n_length_buckets, optimiser=optimiser,
                lr_warmup=lr_warmup, steps_per_dispatch=steps_per_dispatch,
                prefetch=prefetch, data_on_device=data_on_device,
                profile_dir=profile_dir, stats=stats)
        finally:
            if own_log:
                log.close()


def _train(layer, data, dev, log, *, output, adam, batch_size,
           chunk_len_range, drop, ilf, l2, lrdecay, min_prob, niteration,
           save_every, seed, smooth, transducer, bad, opt_state,
           n_length_buckets, optimiser, lr_warmup, steps_per_dispatch,
           prefetch, data_on_device, profile_dir, stats):
    all_chunks = data["chunks"]
    all_labels = data["labels"]
    all_bad = data["bad"]

    stride = int(np.ceil(float(all_chunks.shape[1]) / all_labels.shape[1]))
    log.write('* Stride is {}\n'.format(stride))

    data_chunk = all_chunks.shape[1]
    min_chunk = (2 * drop + 1 if chunk_len_range[0] is None
                 else int(np.around(chunk_len_range[0] * data_chunk)))
    max_chunk = (data_chunk if chunk_len_range[1] is None
                 else int(np.around(chunk_len_range[1] * data_chunk)))
    log.write('* Will use min_chunk, max_chunk = {}, {}\n'.format(
        min_chunk, max_chunk))
    if not data_chunk >= max_chunk >= min_chunk >= 2 * drop + 1:
        raise ValueError(
            "inconsistent chunk sizes: need data chunk ({}) >= max_chunk ({}) "
            ">= min_chunk ({}) >= 2*drop+1 ({}); reduce --drop or widen "
            "--chunk_len_range".format(data_chunk, max_chunk, min_chunk,
                                       2 * drop + 1))

    if not transducer:
        all_labels = remove_blanks(all_labels)
    if bad:
        all_labels = apply_bad_mask(all_labels, all_bad)

    label_weights = label_frequency_weights(all_labels, data["weights"], ilf)
    nrank = mesh.world_size()
    # the same seed on every rank: each draws the global batch
    sampler = ChunkSampler({"chunks": all_chunks, "labels": all_labels,
                            "weights": data["weights"]},
                           batch_size, min_chunk, max_chunk, stride,
                           label_weights, seed=seed,
                           n_buckets=n_length_buckets,
                           device_multiple=nrank)

    opt_init, opt_update, state_type = _make_optimiser(optimiser, adam)
    if opt_state is not None and not isinstance(opt_state, state_type):
        log.write('* Resumed optimiser state is {} but optimiser is {}; '
                  'starting the optimiser fresh\n'.format(
                      type(opt_state).__name__, optimiser))
        opt_state = None
    opt_state = (opt_init(layer) if opt_state is None
                 else optim.state_to(opt_state, dev))

    warmup = max(0, int(lr_warmup))

    def sched(i):
        """Per-iteration learning rate: optional warmup at lr 0, then the
        reference 1/(1+i/lrdecay) decay (train_network.py:289)."""
        if i < warmup:
            return 0.0
        return adam[0] / (1.0 + (i - warmup) / lrdecay)

    K = max(1, int(steps_per_dispatch))
    if K > 1 and min_chunk != max_chunk:
        log.write('* steps_per_dispatch needs a fixed chunk length '
                  '(--chunk_len_range x x); falling back to 1\n')
        K = 1
    # the chunk set resident on the device: the host ships the sampler's
    # indices only (sloika_tpu/training.py:539-560)
    budget = int(os.environ.get("SLOIKA_TPU_RESIDENT_BYTES", 1_200_000_000))
    resident_bytes = (all_chunks.nbytes + all_labels.nbytes
                      + label_weights.nbytes)
    resident_ok = K > 1 and nrank == 1 and resident_bytes <= budget
    if data_on_device == "auto":
        resident = resident_ok
    elif data_on_device:
        if not resident_ok:
            raise ValueError(
                "data_on_device=True needs steps_per_dispatch > 1 (fixed "
                "chunk length), a single rank (have {}) and <= {} resident "
                "bytes (have {})".format(nrank, budget, resident_bytes))
        resident = True
    else:
        resident = False
    if K > 1 and dev.type == "cuda" and mesh.backend() == "gloo":
        raise ValueError(
            "steps_per_dispatch {} runs a group as one CUDA graph, and a "
            "gloo all-reduce cannot be captured in one (ranks sharing a "
            "card run gloo): use steps_per_dispatch 1, or one card a rank "
            "(NCCL)".format(K))
    fixed_len = int(sampler.bucket_lengths[0])
    if resident:
        resident_d = _put(dev, np.ascontiguousarray(all_chunks,
                                                    dtype=np.float32),
                          np.ascontiguousarray(all_labels, dtype=np.int64),
                          label_weights.astype(np.float32))
        log.write('* Chunk set resident on device ({:.1f} MB); dispatches '
                  'ship sampler indices only\n'.format(resident_bytes / 1e6))

    loss_fn = make_loss_fn(layer, min_prob=min_prob, l2=l2, drop=drop,
                           counts=True)
    step = make_train_step(layer, opt_update, min_prob=min_prob, l2=l2,
                           drop=drop)
    score_smoothed = ExponentialSmoother(smooth)
    acc_smoothed = ExponentialSmoother(smooth)

    if output:
        with tracing.span("train.checkpoint"):
            serialize.save_checkpoint(
                os.path.join(output, 'model_checkpoint_00000.npz'), layer,
                opt_state)

    total_ev = 0
    t0 = time.time()
    log.write('* Training\n')

    def put_group():
        """Sample a group of K same-shape batches (or, resident, their
        draws) and start their copy to the device."""
        with tracing.span("train.sample"):
            if resident:
                draws = [sampler.sample_indices() for _ in range(K)]
                arrays = (np.stack([d[0] for d in draws]).astype(np.int64),
                          np.asarray([d[1] for d in draws], np.int64))
                nev = arrays[0].size * (draws[0][2] // stride)
            else:
                bs = [sampler.sample() for _ in range(K)]
                nev = sum(b[1].size for b in bs)  # the global batches' labels
                bs = [tuple(mesh.local_batch(a) for a in b) for b in bs]
                if K == 1:
                    x, labels, weights = bs[0]
                    arrays = (x, labels.astype(np.int64), weights)
                else:
                    arrays = (np.stack([b[0] for b in bs]),
                              np.stack([b[1] for b in bs]).astype(np.int64),
                              np.stack([b[2] for b in bs]))
        with tracing.span("train.h2d"):
            return _put(dev, *arrays), nev

    def lr_of(i):
        return float(np.float32(sched(i)))

    def eager(batches, g, nsteps):
        """nsteps single steps from iteration g: the tail, the CPU's
        groups, and K = 1"""
        nonlocal opt_state
        out = []
        for j in range(nsteps):
            opt_state, loss, acc = step(opt_state, *batches(j), lr_of(g + j))
            out.append(torch.stack([loss, acc]))
        return torch.stack(out)

    graph = None
    pool = ThreadPoolExecutor(max_workers=1) if prefetch else None
    profiler = None
    pending, history = [], []
    try:
        submit = pool.submit if pool is not None else _done
        next_group = submit(tracing.carry(put_group))
        for g in range(0, niteration, K):
            nsteps = min(K, niteration - g)
            with tracing.span("train.wait_group"):
                inputs, nev = next_group.result()
            full = nsteps == K and K > 1
            if full and dev.type == "cuda" and graph is None:
                # captured before the worker runs again: no other thread
                # touches the card during a capture
                with tracing.span("train.capture"):
                    scal, _ = _group_scalars(
                        opt_update, opt_state,
                        [lr_of(i) for i in range(g, g + K)])
                    graph = GroupGraph(
                        layer, loss_fn, opt_update.apply, opt_state, K,
                        inputs, _put(dev, scal)[0],
                        resident=resident_d if resident else None,
                        chunk_len=fixed_len, stride=stride)
            if g + K < niteration:
                next_group = submit(tracing.carry(put_group))
            if profile_dir and profiler is None and (
                    g > 0 or niteration <= K):
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU] + (
                    [torch.profiler.ProfilerActivity.CUDA]
                    if dev.type == "cuda" else []))
                profiler.start()
            if resident:
                batches = lambda j: gather_batch(
                    *resident_d, inputs[0][j], inputs[1][j], fixed_len,
                    stride)
            elif K == 1:
                batches = lambda j: inputs
            else:
                batches = lambda j: tuple(t[j].clone() for t in inputs)
            if full and graph is not None:
                with tracing.span("train.scalars"):
                    scal, opt_state = _group_scalars(
                        opt_update, opt_state,
                        [lr_of(i) for i in range(g, g + K)])
                    scal = _put(dev, scal)[0]
                with tracing.span("train.replay"):
                    got = graph.run(inputs, scal)
            else:
                # the CPU's groups, K = 1, and a tail (its resident draws
                # gathered as a group's are: the host sampler's elements)
                with tracing.span("train.eager"):
                    got = eager(batches, g, nsteps)
                nev = nev // K * nsteps
            total_ev += nev
            pending.append(got)

            i_last = min(g + K, niteration) - 1
            if output and (i_last + 1) // save_every > g // save_every:
                with tracing.span("train.checkpoint"):
                    serialize.save_checkpoint(os.path.join(
                        output, 'model_checkpoint_{:05d}.npz'.format(
                            (i_last + 1) // save_every)), layer, opt_state)
                log.write('C')
            else:
                log.write('.' * nsteps)

            # per-step (loss, acc) stay on the device until the 50-iteration
            # progress line reads them, so the loop does not wait on a group
            if (i_last + 1) // 50 > g // 50:
                with tracing.span("train.log_sync"):
                    got = tracing.to_host(torch.cat(pending)).numpy()
                pending = []
                history.append(got)
                for v, a in got:
                    score_smoothed.update(float(v))
                    acc_smoothed.update(float(a))
                tn = time.time()
                dt = tn - t0
                log.write(' {:5d} {:5.3f}  {:5.2f}%  {:5.2f}s ({:.2f} kev/s)\n'
                          .format((i_last + 1) // 50, score_smoothed.value,
                                  100.0 * acc_smoothed.value, dt,
                                  total_ev / 1000.0 / dt))
                total_ev = 0
                t0 = tn
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
        if profiler is not None:
            profiler.stop()
    if pending:
        with tracing.span("train.log_sync"):
            history.append(tracing.to_host(torch.cat(pending)).numpy())
    if profiler is not None:
        profiler.export_chrome_trace(_profile_path(profile_dir))
        log.write('* Wrote profiler trace to {}\n'.format(profile_dir))
    if stats is not None:
        stats.update(steps_per_dispatch=K, resident=resident,
                     replays=graph.replays if graph else 0,
                     captured=graph.captured if graph else {})

    if output:
        with tracing.span("train.checkpoint"):
            serialize.save_checkpoint(
                os.path.join(output, 'model_final.npz'), layer, opt_state)
    history = (np.concatenate(history) if history
               else np.zeros((0, 2), np.float32))
    return opt_state, history


def _done(fn):
    """A finished future of ``fn()``: the serial loop's stand-in for the
    prefetch worker's."""
    future = Future()
    future.set_result(fn())
    return future


def validate(layer, data, *, batch_size=200, min_prob=1e-30, drop=0,
             transducer=True, bad=True, log=None, quiet=False,
             device="cuda"):
    """Held-out evaluation over all chunks
    (``sloika_tpu/training.py:756-808``, one device).  The layer is moved to
    ``device``, the card unless the caller asks for the CPU.

    :returns: (mean loss, mean accuracy)
    """
    dev = config.resolve_device(device)
    if dev.type == "cuda":
        config.disable_tf32()
    layer.to(dev)
    if log is None:
        log = Logger(None, quiet)
    all_chunks = data["chunks"]
    all_labels = data["labels"]
    if not transducer:
        all_labels = remove_blanks(all_labels)
    if bad:
        all_labels = apply_bad_mask(all_labels, data["bad"])
    if len(all_chunks) == 0:
        raise ValueError("validation set is empty")

    step = make_eval_step(layer, min_prob=min_prob, drop=drop)
    nchunk = 0
    per_batch = []        # device (loss*b, acc*b) pairs, read once at the end
    t0 = time.time()
    total_ev = 0
    for lo in range(0, len(all_chunks), batch_size):
        # the tail runs as a smaller batch
        b = min(batch_size, len(all_chunks) - lo)
        x = np.ascontiguousarray(all_chunks[lo:lo + b].transpose((1, 0, 2)))
        labels = np.ascontiguousarray(all_labels[lo:lo + b].T)
        w = np.ones(labels.shape, np.float32)
        loss, acc = step(*_to_device((x, labels, w), dev))
        # chunk-weighted, so a small tail batch does not carry a full
        # batch's weight
        per_batch.append(torch.stack([loss * b, acc * b]))
        nchunk += b
        total_ev += b * all_labels.shape[1]
        log.write('.')
    sums = torch.stack(per_batch).cpu().numpy().sum(axis=0)
    dt = time.time() - t0
    log.write('\n* {:.2f} kev/s\n'.format(total_ev / 1000.0 / max(dt, 1e-9)))
    return float(sums[0]) / nchunk, float(sums[1]) / nchunk
