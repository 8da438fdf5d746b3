"""GRU (sloika's Theano ``sloika/layers.py``): gate-major iW (3, S, I) =
[z; r; h], sW (2, S, S) = [z; r], sW2 (S, S), b (3, S);
``[z, r] = sigmoid(x iW_zr^T + b_zr + h sW^T)``,
``hbar = tanh(x iW_h^T + b_h + (r * h) sW2^T)``,
``h' = z * h + (1 - z) * hbar``; a reversed GRU (``reverse`` true) runs
from each row's last valid frame back to frame 0, and a frame past a row's
length keeps the state.  Its FLOPs follow the counting rule of
``sloika_tpu_torch/nn/flops.py:20-78``."""
import math

import torch

from benchmark.reference import steps


def param_shapes(spec, i):
    S, I = spec["size"], spec["insize"]
    return [("{}.iW".format(i), (3, S, I), math.sqrt(I + S)),
            ("{}.sW".format(i), (2, S, S), math.sqrt(2.0 * S)),
            ("{}.sW2".format(i), (S, S), math.sqrt(2.0 * S)),
            ("{}.b".format(i), (3, S), 1.0)]


def flops(spec):
    S, I = spec["size"], spec["insize"]
    return 2.0 * (3 * S * I + 2 * S * S + S * S)


def stride(spec):
    return 1


def out_lengths(spec, lengths):
    return lengths


def forward(spec, p, i, x, lengths, prec):
    """One GRU layer over (T, B, I), rows valid up to ``lengths`` (None:
    every row whole)."""
    S = spec["size"]
    T, B, _ = x.shape
    iW = p["{}.iW".format(i)].reshape(3 * S, -1)
    xp = torch.matmul(prec.operand(x), prec.operand(iW).t()) \
        + p["{}.b".format(i)].reshape(-1)
    sWT = prec.operand(p["{}.sW".format(i)].reshape(2 * S, S).t())
    sW2T = prec.operand(p["{}.sW2".format(i)].t())
    if lengths is None:
        valid = torch.ones((T, B), dtype=torch.bool, device=x.device)
        full = True
    else:
        valid = torch.arange(T, device=x.device)[:, None] < lengths[None, :]
        full = bool(valid.all())
    reverse = bool(spec.get("reverse"))

    def cell(x_t, h):
        zr = torch.sigmoid(torch.addmm(x_t[:, :2 * S], prec.operand(h),
                                       sWT))
        hbar = torch.tanh(torch.addmm(x_t[:, 2 * S:],
                                      prec.operand(zr[:, S:] * h), sW2T))
        return torch.lerp(hbar, h, zr[:, :S])      # z * h + (1 - z) * hbar

    if xp.requires_grad and torch.is_grad_enabled():
        h = x.new_zeros((B, S))
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            new = cell(xp[t], h)
            h = new if full else torch.where(valid[t][:, None], new, h)
            outs[t] = h
        return torch.stack(outs)
    if reverse:
        xp, valid = xp.flip(0), valid.flip(0)
    h = x.new_zeros((B, S))
    out = x.new_empty((T, B, S))

    def step(x_t, m_t, o_t):
        new = cell(x_t, h)
        if not full:
            new = torch.where(m_t[:, None], new, h)
        h.copy_(new)
        o_t.copy_(new)

    steps.run_steps(step, [xp.contiguous(), valid.contiguous()], [out])
    return out.flip(0) if reverse else out
