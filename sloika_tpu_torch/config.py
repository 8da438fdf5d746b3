"""Numeric configuration of the port (cf. ``sloika_tpu/config.py``).

float32 is the parameter and IO dtype, as in the JAX package.  cuDNN runs
float32 convolutions in TF32 by default, while the JAX package accumulates
its convolution and its GRU in full float32; :func:`disable_tf32` is the one
place that turns TF32 off, and the entry points (``Basecaller``, the CLI,
``chip_smoke.py``) call it.
"""
import numpy as np
import torch

#: dtype used for parameters, inputs and outputs (the JAX package's dtype)
sloika_dtype = np.float32


def disable_tf32():
    """Run float32 convolutions and matmuls in full float32 on the GPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device):
    """``torch.device`` for ``device``.

    Raises when a CUDA device is asked for and none is present: the port
    never drops to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device {!r} requested but CUDA is not available".format(
                str(device)))
    return dev
