"""LSTM (``torch.nn.LSTM``'s cell, with sloika's optional peepholes; the
kind ``lstm_cell``, as ``lstm`` stands in the harness's tests for a kind
that has no file), in
the program's parameter layout: gate-major iW (4, S, I), sW (4, S, S), one
bias b (4, S) and peepholes p (3, S), gates 0 candidate, 1 input, 2 forget,
3 output::

    g    = x iW^T + b + h sW^T
    c'   = c sigmoid(g2 + c p1) + tanh(g0) sigmoid(g1 + c p0)
    h'   = tanh(c') sigmoid(g3 + c' p2)

With ``"peep": false`` the peepholes are zero (drawn with an infinite
divisor), and the cell is ``torch.nn.LSTM``'s with ``b = b_ih + b_hh``.
A reversed LSTM (``reverse`` true) runs from each row's last valid frame
back to frame 0, and a frame past a row's length keeps the state.  Its
FLOPs follow the counting rule of ``sloika_tpu_torch/nn/flops.py:20-78``
(the peepholes are elementwise)."""
import math

import torch

from benchmark.reference import steps


def param_shapes(spec, i):
    S, I = spec["size"], spec["insize"]
    peep = math.sqrt(S) if spec.get("peep", False) else float("inf")
    return [("{}.iW".format(i), (4, S, I), math.sqrt(I + S)),
            ("{}.sW".format(i), (4, S, S), math.sqrt(2.0 * S)),
            ("{}.b".format(i), (4, S), 1.0),
            ("{}.p".format(i), (3, S), peep)]


def flops(spec):
    S, I = spec["size"], spec["insize"]
    return 2.0 * (4 * S * I + 4 * S * S)


def stride(spec):
    return 1


def out_lengths(spec, lengths):
    return lengths


def forward(spec, p, i, x, lengths, prec):
    """One LSTM layer over (T, B, I), rows valid up to ``lengths`` (None:
    every row whole)."""
    S = spec["size"]
    T, B, _ = x.shape
    iW = p["{}.iW".format(i)].reshape(4 * S, -1)
    xp = torch.matmul(prec.operand(x), prec.operand(iW).t()) \
        + p["{}.b".format(i)].reshape(-1)
    sWT = prec.operand(p["{}.sW".format(i)].reshape(4 * S, S).t())
    peep = p["{}.p".format(i)]
    if lengths is None:
        valid = torch.ones((T, B), dtype=torch.bool, device=x.device)
        full = True
    else:
        valid = torch.arange(T, device=x.device)[:, None] < lengths[None, :]
        full = bool(valid.all())
    if spec.get("reverse"):
        xp, valid = xp.flip(0), valid.flip(0)
    h = x.new_zeros((B, S))
    c = x.new_zeros((B, S))
    out = x.new_empty((T, B, S))

    def step(x_t, m_t, o_t):
        g = torch.addmm(x_t, prec.operand(h), sWT)
        g0, g1, g2, g3 = g.split(S, dim=1)
        c_new = c * torch.sigmoid(g2 + c * peep[1]) \
            + torch.tanh(g0) * torch.sigmoid(g1 + c * peep[0])
        h_new = torch.tanh(c_new) * torch.sigmoid(g3 + c_new * peep[2])
        if not full:
            m = m_t[:, None]
            c_new = torch.where(m, c_new, c)
            h_new = torch.where(m, h_new, h)
        c.copy_(c_new)
        h.copy_(h_new)
        o_t.copy_(h_new)

    steps.run_steps(step, [xp.contiguous(), valid.contiguous()], [out])
    return out.flip(0) if spec.get("reverse") else out
