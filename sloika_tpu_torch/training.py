"""Transducer training for the port (cf. ``sloika_tpu/training.py``).

The step is the JAX package's step (``training.py:109-172``):

* a weighted cross-entropy computed from logits (fused log-softmax) with
  the ``min_prob`` floor applied in log space, ``drop`` edge trimming and
  an optional L2 penalty; accuracy over positions with nonzero weight;
* gradients by autograd, through :class:`~sloika_tpu_torch.nn.fused_gru.
  GruFunction` for each GRU (the CUDA forward and backward kernels on the
  GPU, their plain twins on the CPU);
* ADAMski (default), Adam or SGD from :mod:`sloika_tpu_torch.optim`.

:func:`train` is the JAX package's training loop, one optimiser step per
batch.  It draws the same batches from the same seed (:class:`ChunkSampler`
is a verbatim copy) and writes the same ``model.log`` lines and
checkpoints.  :func:`validate` is its held-out evaluation.

The numpy-only helpers below are copied, with their source lines, because
``sloika_tpu/training.py`` imports jax.
"""
import os
import sys
import time

import numpy as np
import torch

from sloika_tpu_torch import config, optim, serialize
from sloika_tpu_torch.nn.combinators import Serial
from sloika_tpu_torch.nn.layers import Softmax


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


def make_loss_fn(layer, min_prob=0.0, l2=0.0, drop=0):
    """Weighted cross-entropy loss + accuracy over time-major batches
    (``sloika_tpu/training.py:109-144``).

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
        acc = (torch.sum(correct & valid)
               / torch.clamp(torch.sum(valid), min=1)).float()
        return loss, acc

    return loss_fn


def make_train_step(layer, opt_update, min_prob=0.0, l2=0.0, drop=0):
    """The train step (``sloika_tpu/training.py:147-172``, one device).

    :returns: ``step(opt_state, x, labels, weights, lr) -> (opt_state,
        loss, acc)``; the layer's parameters are updated in place
    """
    loss_fn = make_loss_fn(layer, min_prob=min_prob, l2=l2, drop=drop)

    def step(opt_state, x, labels, weights, lr):
        layer.zero_grad(set_to_none=True)
        loss, acc = loss_fn(x, labels, weights)
        loss.backward()
        for p in layer.parameters():
            # a parameter no output reads (MUT3's W_xu and b_u, the
            # peepholes of a scanned LSTM without them): JAX's zero
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt_state = opt_update(layer, opt_state, lr)
        return opt_state, loss.detach(), acc

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


def _to_device(batch, dev):
    x, labels, weights = batch
    return (torch.from_numpy(x).to(dev),
            torch.from_numpy(labels.astype(np.int64)).to(dev),
            torch.from_numpy(weights).to(dev))


def train(layer, data, *, output=None, adam=(1e-3, 0.9, 0.999),
          batch_size=100, chunk_len_range=(0.5, 1.0), drop=20, ilf=False,
          l2=0.0, lrdecay=5000.0, min_prob=1e-30, niteration=50000,
          quiet=False, save_every=5000, seed=None, smooth=0.45,
          transducer=True, bad=True, log=None, opt_state=None,
          n_length_buckets=4, optimiser="adamski", lr_warmup=0,
          device="cuda"):
    """Train a network on labelled chunks: the JAX package's
    ``training.train`` (``sloika_tpu/training.py:404-753``) with one
    optimiser step per batch.  The layer is moved to ``device`` and trained
    in place.

    :param data: dict from
        :func:`sloika_tpu_torch.data.hdf5.load_labelled_chunks`
    :param optimiser: ``"adamski"`` (default), ``"adam"`` or ``"sgd"``
        (``adam[1]`` is then the momentum)
    :param lr_warmup: run the first N iterations at lr 0
    :param opt_state: optimiser state to resume from (e.g. from
        :func:`sloika_tpu_torch.serialize.load_checkpoint`); a state of
        another optimiser's type is logged and replaced by a fresh one
    :param device: torch device, the card unless the caller asks for the
        CPU; a CUDA device without a card raises
    :returns: (opt_state, history) with history an (niteration, 2) float32
        array of each iteration's (loss, accuracy)
    """
    dev = config.resolve_device(device)
    if dev.type == "cuda":
        config.disable_tf32()
    layer.to(dev)
    if output:
        os.makedirs(output, exist_ok=True)
    own_log = log is None
    if own_log:
        log = Logger(os.path.join(output, 'model.log') if output else None,
                     quiet)
    try:
        return _train(layer, data, dev, log, output=output, adam=adam,
                      batch_size=batch_size, chunk_len_range=chunk_len_range,
                      drop=drop, ilf=ilf, l2=l2, lrdecay=lrdecay,
                      min_prob=min_prob, niteration=niteration,
                      save_every=save_every, seed=seed, smooth=smooth,
                      transducer=transducer, bad=bad, opt_state=opt_state,
                      n_length_buckets=n_length_buckets, optimiser=optimiser,
                      lr_warmup=lr_warmup)
    finally:
        if own_log:
            log.close()


def _train(layer, data, dev, log, *, output, adam, batch_size,
           chunk_len_range, drop, ilf, l2, lrdecay, min_prob, niteration,
           save_every, seed, smooth, transducer, bad, opt_state,
           n_length_buckets, optimiser, lr_warmup):
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
    sampler = ChunkSampler({"chunks": all_chunks, "labels": all_labels,
                            "weights": data["weights"]},
                           batch_size, min_chunk, max_chunk, stride,
                           label_weights, seed=seed,
                           n_buckets=n_length_buckets)

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

    step = make_train_step(layer, opt_update, min_prob=min_prob, l2=l2,
                           drop=drop)
    score_smoothed = ExponentialSmoother(smooth)
    acc_smoothed = ExponentialSmoother(smooth)

    if output:
        serialize.save_checkpoint(
            os.path.join(output, 'model_checkpoint_00000.npz'), layer,
            opt_state)

    total_ev = 0
    t0 = time.time()
    log.write('* Training\n')
    # per-step (loss, acc) stay on the device until the 50-iteration
    # progress line reads them, so the loop does not wait on each step
    pending, history = [], []
    for i in range(niteration):
        batch = sampler.sample()
        opt_state, loss, acc = step(opt_state, *_to_device(batch, dev),
                                    float(np.float32(sched(i))))
        total_ev += batch[1].size
        pending.append(torch.stack([loss, acc]))

        if output and (i + 1) % save_every == 0:
            serialize.save_checkpoint(
                os.path.join(output, 'model_checkpoint_{:05d}.npz'.format(
                    (i + 1) // save_every)), layer, opt_state)
            log.write('C')
        else:
            log.write('.')

        if (i + 1) % 50 == 0:
            got = torch.stack(pending).cpu().numpy()
            pending = []
            history.append(got)
            for v, a in got:
                score_smoothed.update(float(v))
                acc_smoothed.update(float(a))
            tn = time.time()
            dt = tn - t0
            log.write(' {:5d} {:5.3f}  {:5.2f}%  {:5.2f}s ({:.2f} kev/s)\n'
                      .format((i + 1) // 50, score_smoothed.value,
                              100.0 * acc_smoothed.value, dt,
                              total_ev / 1000.0 / dt))
            total_ev = 0
            t0 = tn
    if pending:
        history.append(torch.stack(pending).cpu().numpy())

    if output:
        serialize.save_checkpoint(os.path.join(output, 'model_final.npz'),
                                  layer, opt_state)
    history = (np.concatenate(history) if history
               else np.zeros((0, 2), np.float32))
    return opt_state, history


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
