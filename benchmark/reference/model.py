"""The plain reference of the benchmark's models: a configuration file's
``layers`` list run as plain PyTorch operations, layer by layer, each by
the module of its kind (``benchmark/reference/layers/<type>.py``: sloika's
raw networks' strided convolution, GRUs that alternate direction and
softmax, with their equations there).  A new kind is a new file there; no
loop here names one.

It imports nothing of the measured program and nothing of the JAX
package.

``precision="tf32"`` is the control of the benchmark's comparisons: every
matrix product and the convolution take their operands rounded to TF32
(10 mantissa bits, round to nearest), as the card's TF32 path does, with
float32 sums.  On the card it runs the card's own TF32 path.
"""
import torch

from benchmark.reference.layers import kind


def param_shapes(layers):
    """[(name, shape, fan scale)] of a configuration's parameters, in the
    order the benchmark draws them (each kind's ``param_shapes``)."""
    out = []
    for i, spec in enumerate(layers):
        out += kind(spec["type"]).param_shapes(spec, i)
    return out


def stride(layers):
    """The network's total temporal stride."""
    s = 1
    for spec in layers:
        s *= kind(spec["type"]).stride(spec)
    return s


def out_lengths(layers, lengths):
    """Frames a row of ``lengths`` samples gives."""
    for spec in layers:
        lengths = kind(spec["type"]).out_lengths(spec, lengths)
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


def logits(layers, p, x, lengths, precision="float32"):
    """The network's logits, its last layer's output (T', B, nstate), and
    frame counts of a (T, B, 1) float32 batch whose rows hold ``lengths``
    samples (None: every row whole, with no look at the device's values,
    so that the network can be captured in a CUDA graph)."""
    with Precision(precision, x.device) as prec:
        for i, spec in enumerate(layers):
            k = kind(spec["type"])
            x = k.forward(spec, p, i, x, lengths, prec)
            if lengths is not None:
                lengths = k.out_lengths(spec, lengths)
    return x, lengths


def posterior(layers, p, x, lengths, precision="float32"):
    """Softmax posterior (T', B, nstate) and frame counts."""
    z, n = logits(layers, p, x, lengths, precision)
    return torch.softmax(z, dim=2), n
