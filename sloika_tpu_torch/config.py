"""Numeric configuration of the port (cf. ``sloika_tpu/config.py``).

float32 is the parameter and IO dtype, as in the JAX package.  cuDNN runs
float32 convolutions in TF32 by default, while the JAX package accumulates
its convolution and its GRU in full float32; :func:`disable_tf32` is the one
place that turns TF32 off, and the entry points (``Basecaller``, the CLI,
``chip_smoke.py``) call it.

:data:`compute_dtype` is the JAX package's switch, read from the same
variable (``SLOIKA_TPU_COMPUTE_DTYPE=bfloat16``).  Under bfloat16,
``nn.core.affine`` rounds its operands to bfloat16 and returns their float32
product (every FeedForward, Softmax and recurrent input projection), and
``Basecaller(post_dtype="auto")`` streams the posterior to the Viterbi in
bfloat16; the convolution and the recurrences stay float32.  Code reads it
as ``config.compute_dtype`` at call time, never by ``from config import``,
so that a test or a phase may set it.
"""
import os

import numpy as np
import torch

#: dtype used for parameters, inputs and outputs (the JAX package's dtype)
sloika_dtype = np.float32

#: dtype of the products of ``nn.core.affine`` (float32 by default;
#: ``SLOIKA_TPU_COMPUTE_DTYPE=bfloat16`` as ``sloika_tpu/config.py:21-24``)
compute_dtype = torch.bfloat16 if os.environ.get(
    "SLOIKA_TPU_COMPUTE_DTYPE", "float32") == "bfloat16" else torch.float32


def disable_tf32():
    """Run float32 convolutions and matmuls in full float32 on the GPU, and
    sum a bfloat16 product's partials in float32 (cuBLAS may otherwise
    reduce split-K partials in bfloat16, which the JAX package's
    ``preferred_element_type=float32`` never does)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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
