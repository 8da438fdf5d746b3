"""Convolution with swish, bonito's ``Convolution`` with its default
activation: ``y * sigmoid(y)``, ``y = conv1d(pad(x), W, stride) + b``, W
(out, in, winlen).  Its shapes, FLOPs, stride and frame counts are
``convolution``'s, whose 'same' padding is bonito's ``winlen // 2`` on both
ends at the odd widths its models use."""
import torch

from benchmark.reference.layers import convolution

param_shapes = convolution.param_shapes
flops = convolution.flops
stride = convolution.stride
out_lengths = convolution.out_lengths


def forward(spec, p, i, x, lengths, prec):
    y = convolution.forward(dict(spec, activation="linear"), p, i, x,
                            lengths, prec)
    return y * torch.sigmoid(y)
