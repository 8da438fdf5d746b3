"""sloika_tpu_torch — the PyTorch/CUDA port of sloika_tpu.

A second package beside the JAX reference ``sloika_tpu``.  It covers the
chunked basecall path from raw int16 DAC samples
(:meth:`sloika_tpu_torch.basecall.Basecaller.basecall_dac_reads`): the
forward pass runs in PyTorch, and the GRU recurrence, the transducer
Viterbi forward and its backtrace are hand-written CUDA kernels for Hopper
(``csrc/``), built with ``nvcc`` at first use.  Every kernel has a plain
PyTorch twin in the same module; the twin runs for tensors on the CPU.

The port imports ``torch`` and never ``jax``; of the JAX package it uses
only the jax-free host modules (``bio``, ``maths``, ``util``,
``variables``, ``cmdargs``, ``data.fileio``).
"""

__version__ = "0.1.0"
