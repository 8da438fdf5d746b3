"""The plain reference of the benchmark's models: sloika's raw networks
(a strided convolution, GRUs that alternate direction, a softmax) as plain
PyTorch operations, read from a configuration file's ``layers`` list.

It imports nothing of the measured program and nothing of the JAX
package.  Its equations are sloika's (Theano ``sloika/layers.py``):

* Convolution: ``fun(conv1d(pad(x), W, stride) + b)``, W (out, in, winlen),
  'same' padding ((winlen - 1) // 2, winlen // 2), no filter flip;
* GRU (gate-major iW (3, S, I) = [z; r; h], sW (2, S, S) = [z; r], sW2
  (S, S), b (3, S)): ``[z, r] = sigmoid(x iW_zr^T + b_zr + h sW^T)``,
  ``hbar = tanh(x iW_h^T + b_h + (r * h) sW2^T)``,
  ``h' = z * h + (1 - z) * hbar``; a reversed GRU runs from each row's
  last valid frame back to frame 0, and a frame past a row's length keeps
  the state;
* Softmax: ``softmax(x W^T + b)`` over the features.

``precision="tf32"`` is the control of the benchmark's comparisons: every
matrix product and the convolution take their operands rounded to TF32
(10 mantissa bits, round to nearest), as the card's TF32 path does, with
float32 sums.  On the card it runs the card's own TF32 path.
"""
import math

import torch
import torch.nn.functional as F

from benchmark.reference import steps

ACTIVATIONS = {
    "tanh": torch.tanh,
    "elu": F.elu,
    "linear": lambda x: x,
}


def param_shapes(layers):
    """[(name, shape, fan scale)] of a configuration's parameters, in the
    order the benchmark draws them.  The scale is sloika's initialiser
    divisor (``layers.py``: the fan of each weight; biases 1)."""
    out = []
    for i, spec in enumerate(layers):
        kind, S, I = spec["type"], spec["size"], spec["insize"]
        if kind == "convolution":
            w, st = spec["winlen"], spec["stride"]
            out += [("{}.W".format(i), (S, I, w),
                     math.sqrt(I * w + S * w / float(st))),
                    ("{}.b".format(i), (S,), 1.0)]
        elif kind == "gru":
            out += [("{}.iW".format(i), (3, S, I), math.sqrt(I + S)),
                    ("{}.sW".format(i), (2, S, S), math.sqrt(2.0 * S)),
                    ("{}.sW2".format(i), (S, S), math.sqrt(2.0 * S)),
                    ("{}.b".format(i), (3, S), 1.0)]
        elif kind == "softmax":
            out += [("{}.W".format(i), (S, I), math.sqrt(S + I)),
                    ("{}.b".format(i), (S,), 1.0)]
        else:
            raise ValueError("unknown layer type {!r}".format(kind))
    return out


def stride(layers):
    """The network's total temporal stride."""
    s = 1
    for spec in layers:
        s *= spec.get("stride", 1)
    return s


def out_lengths(layers, lengths):
    """Frames a row of ``lengths`` samples gives (the convolution's
    'same'-padded count)."""
    for spec in layers:
        if spec["type"] == "convolution":
            w = spec["winlen"]
            lengths = 1 + (lengths + w - 1 - w) // spec["stride"]
    return lengths


def round_tf32(x):
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Precision:
    """The arithmetic of a run: float32 (TF32 off), or the TF32 control."""

    def __init__(self, precision, device):
        if precision not in ("float32", "tf32"):
            raise ValueError("precision {!r}".format(precision))
        self.tf32 = precision == "tf32"
        #: on the card the card's own TF32 path; elsewhere its rounding
        self.native = self.tf32 and device.type == "cuda"
        self.emulate = self.tf32 and not self.native

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.native
        torch.backends.cudnn.allow_tf32 = self.native
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved

    def operand(self, x):
        if not self.emulate:
            return x
        # the rounding passes gradients straight through
        return x + (round_tf32(x.detach()) - x.detach())


def _conv(spec, p, i, x, prec):
    w = spec["winlen"]
    lhs = F.pad(x.permute(1, 2, 0), ((w - 1) // 2, w // 2))
    y = F.conv1d(prec.operand(lhs), prec.operand(p["{}.W".format(i)]),
                 stride=spec["stride"])
    y = y + p["{}.b".format(i)][None, :, None]
    return ACTIVATIONS[spec.get("activation", "tanh")](y).permute(2, 0, 1)


def gru(spec, p, i, x, lengths, prec):
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


def logits(layers, p, x, lengths, precision="float32"):
    """The network's softmax logits (T', B, nstate) and frame counts of a
    (T, B, 1) float32 batch whose rows hold ``lengths`` samples (None:
    every row whole, with no look at the device's values, so that the
    network can be captured in a CUDA graph)."""
    with Precision(precision, x.device) as prec:
        for i, spec in enumerate(layers):
            kind = spec["type"]
            if kind == "convolution":
                x = _conv(spec, p, i, x, prec)
                if lengths is not None:
                    lengths = out_lengths([spec], lengths)
            elif kind == "gru":
                x = gru(spec, p, i, x, lengths, prec)
            else:
                W = p["{}.W".format(i)]
                x = torch.matmul(prec.operand(x), prec.operand(W).t()) \
                    + p["{}.b".format(i)]
    return x, lengths


def posterior(layers, p, x, lengths, precision="float32"):
    """Softmax posterior (T', B, nstate) and frame counts."""
    z, n = logits(layers, p, x, lengths, precision)
    return torch.softmax(z, dim=2), n
