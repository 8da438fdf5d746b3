"""sloika_tpu_torch — the PyTorch/CUDA port of sloika_tpu.

A second package beside the JAX reference ``sloika_tpu``.  It covers three
paths: chunked basecalling from raw int16 DAC samples
(:meth:`sloika_tpu_torch.basecall.Basecaller.basecall_dac_reads`), training
(:func:`sloika_tpu_torch.training.train`) and remapping reads to known
references (:class:`sloika_tpu_torch.remap.Remapper`).  The forward and
backward passes run in PyTorch; the GRU recurrence and its backward, the
transducer Viterbi and its backtrace, and the banded remap DP and its
traceback are hand-written CUDA kernels for Hopper (``csrc/``), built with
``nvcc`` at first use.  Every kernel has a plain PyTorch twin in the same
module; the twin runs for tensors on the CPU.

The port imports ``torch`` and never ``jax``, and nothing of ``sloika_tpu``:
the host helpers it needs are copied into it, each with its source line.
"""

__version__ = "0.1.0"
