"""The plain reference of sloika's training step: the chunk sampler's
draws, the transducer cross-entropy and ADAMski, over the plain network of
:mod:`benchmark.reference.model`.

It imports nothing of the measured program and nothing of the JAX
package.  Each part follows sloika (``bin/train_network.py``,
``sloika/updates.py``) as the frozen sources cited below state it.
"""
import numpy as np
import torch

from benchmark.reference import model


def sampler_draws(nchunk, weights, batch_size, chunk_len, data_chunk,
                  stride, seed, ndraw):
    """The first ``ndraw`` draws (idx (B,), start) of a chunk sampler seeded
    with ``seed`` at one chunk length: its ``RandomState`` stream, draw for
    draw (frozen copy of ``sloika_tpu_torch/training.py:150-171``, one
    length bucket, one device)."""
    rs = np.random.RandomState(seed)
    max_batch = int((weights > 0).sum())
    out = []
    for _ in range(ndraw):
        length = int(rs.choice(np.array([chunk_len])))
        b = min(int(batch_size * float(chunk_len) / length), max_batch)
        start = rs.randint(data_chunk - length + 1)
        start -= start % stride
        idx = np.sort(rs.choice(nchunk, size=b, replace=b > max_batch,
                                p=weights))
        out.append((idx, start))
    return out


def loss(layers, params, x, labels, drop, min_prob, precision="float32"):
    """Mean cross-entropy of the labels (T', B) under the floored
    posterior, the first and last ``drop`` frames left out (sloika's
    ``train_network.py`` cost with unit label weights)."""
    z, _ = model.logits(layers, params, x, None, precision)
    lpost = torch.log_softmax(z, dim=2)
    if min_prob > 0.0:
        lpost = torch.logaddexp(
            lpost.new_full((), float(np.log(min_prob))),
            float(np.log1p(-min_prob)) + lpost)
    xent = -torch.gather(lpost, 2, labels[..., None])[..., 0]
    return torch.mean(xent[drop:xent.shape[0] - drop])


class LossGrad:
    """The loss of a batch and its gradients as :func:`loss` and autograd
    give them.  On the card the whole of it is one CUDA graph over static
    buffers, captured once and replayed for each batch, so that a step
    costs the card's time rather than the host's launches; the arithmetic
    is the same either way."""

    def __init__(self, layers, params, x, labels, drop, min_prob,
                 precision):
        self.params = params

        def run(x, labels):
            # the backward's products at the same precision as the forward
            with model.Precision(precision, x.device):
                value = loss(layers, params, x, labels, drop, min_prob,
                             precision)
                return (value,) + torch.autograd.grad(
                    value, list(params.values()))

        self.run = run
        self.graph = None
        if x.device.type != "cuda":
            return
        self.x, self.labels = x.clone(), labels.clone()
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            run(self.x, self.labels)        # builds what the capture must not
        torch.cuda.current_stream(x.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = run(self.x, self.labels)

    def __call__(self, x, labels):
        """(loss, {name: gradient}) of a batch."""
        if self.graph is None:
            out = self.run(x, labels)
        else:
            self.x.copy_(x)
            self.labels.copy_(labels)
            self.graph.replay()
            out = [t.clone() for t in self.out]
        return out[0].detach(), dict(zip(self.params, out[1:]))


class Adamski:
    """ADAMski (sloika's ``updates.adamski``; the float32 step-size
    arithmetic of ``sloika_tpu_torch/optim.py:109-155``): Adam with the
    momentum phased in at rate ``mrate`` and gradients clipped to
    +/- ``clip``."""

    def __init__(self, params, decay=(0.9, 0.999), eps=1e-8, clip=5.0,
                 mrate=0.0005):
        self.d0, self.d1 = float(decay[0]), float(decay[1])
        self.eps, self.clip = eps, clip
        f32 = np.float32
        self.m_rate = -f32(mrate)
        m_p = np.exp(self.m_rate, dtype=f32)
        self.m_k = f32((1.0 - self.d0) * self.d0 * m_p / (1.0 - m_p * self.d0))
        self.ld0 = np.log(self.d0, dtype=f32)
        self.ld1 = np.log(self.d1, dtype=f32)
        self.t = f32(0.0)
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params, grads, lr):
        f32 = np.float32
        t_old, t_new = self.t, f32(self.t + f32(1.0))
        factor = (self.m_k * np.expm1(t_old * f32(self.ld0 + self.m_rate))
                  - np.expm1(t_new * self.ld0))
        lr_t = f32(f32(lr) * np.sqrt(-np.expm1(t_new * self.ld1)) / factor)
        decay = f32(-self.d0 * np.expm1(t_new * self.m_rate))
        self.t = t_new
        with torch.no_grad():
            for k, p in params.items():
                g = torch.clamp(grads[k], -self.clip, self.clip)
                self.m[k] = decay * self.m[k] + (1.0 - self.d0) * g
                self.v[k] = self.d1 * self.v[k] + (1.0 - self.d1) * g * g
                p -= float(lr_t) * self.m[k] / (torch.sqrt(self.v[k])
                                                 + self.eps)


def follow(layers, params, chunks, labels, draws, lrs, drop, min_prob,
           chunk_len, stride, keep, precision="float32"):
    """Train a copy of ``params`` through the batches of ``draws`` at the
    learning rates ``lrs``.

    :returns: (each step's loss, the clipped gradients of the first step
        {name: tensor}, the parameters after the first ``keep`` steps)
    """
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    opt = Adamski(p)
    losses, first, kept, step = [], None, None, None
    for n, ((idx, start), lr) in enumerate(zip(draws, lrs), 1):
        ii = torch.as_tensor(idx, device=chunks.device)
        x = chunks[ii, start:start + chunk_len].transpose(0, 1).contiguous()
        lab = labels[ii, start // stride:(start + chunk_len) // stride]
        lab = lab.t().contiguous()
        if step is None:
            step = LossGrad(layers, p, x, lab, drop, min_prob, precision)
        value, grads = step(x, lab)
        if first is None:
            first = {k: torch.clamp(g, -opt.clip, opt.clip)
                     for k, g in grads.items()}
        opt.step(p, grads, lr)
        losses.append(float(value))
        if n == keep:
            kept = {k: v.detach().clone() for k, v in p.items()}
    return losses, first, kept
