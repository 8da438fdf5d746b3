"""Faults planted in the program, for the check that the comparisons
catch them (``benchmark/readings.py --faults``, and the CPU tests): each
is a context manager that breaks the timed path underneath the harness."""
import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def answer_altered():
    """Calls altered where they are produced: a chunked window's base
    codes and a whole read's collapsed states, each shifted by one
    symbol on every eighth position."""
    from sloika_tpu_torch import basecall
    unpack, collapse = basecall._unpack_codes, basecall.collapse_path

    def bad_unpack(packed):
        out = unpack(packed)
        out[..., ::8] = (out[..., ::8] + 1) % 4
        return out

    def bad_collapse(*args, **kwargs):
        out = np.array(collapse(*args, **kwargs))
        out[::8] = (out[::8] + 1) % 1024
        return out

    with _patched(basecall, "_unpack_codes", bad_unpack), \
            _patched(basecall, "collapse_path", bad_collapse):
        yield


@contextlib.contextmanager
def tail_batch_altered():
    """The calls of one batch altered where they are produced: in each
    DAC call, the first batch that is short of the batch size (the first
    group's tail) has its packed base codes changed on every eighth code."""
    from sloika_tpu_torch import basecall
    cls = basecall.Basecaller
    call, decode = cls.basecall_dac_reads, cls._forward_decode_dac
    state = {"done": False}

    def bad_call(self, reads):
        state["done"] = False
        return call(self, reads)

    def bad_decode(self, flat, starts, lengths, norms):
        out = decode(self, flat, starts, lengths, norms)
        if state["done"] or len(starts) >= self.batch_size:
            return out
        state["done"] = True
        packed = out[-1].clone()
        packed[:, ::2] ^= 0x40
        return tuple(out[:-1]) + (packed,)

    with _patched(cls, "basecall_dac_reads", bad_call), \
            _patched(cls, "_forward_decode_dac", bad_decode):
        yield


@contextlib.contextmanager
def state_unchanged():
    """Each optimiser step returns the parameters unchanged."""
    from sloika_tpu_torch import optim
    adamski = optim.adamski

    def broken(*args, **kwargs):
        init, update = adamski(*args, **kwargs)
        return init, optim._update(update.scalars, lambda *a: None)

    with _patched(optim, "adamski", broken):
        yield


@contextlib.contextmanager
def half_batch():
    """Each training step's loss is the mean over the first half of the
    batch, the rest left out."""
    from sloika_tpu_torch import training
    make = training.make_loss_fn

    def broken(*args, **kwargs):
        loss_fn = make(*args, **kwargs)

        def half(x, labels, weights):
            h = x.shape[1] // 2
            return loss_fn(x[:, :h], labels[:, :h], weights[:, :h])
        return half

    with _patched(training, "make_loss_fn", broken):
        yield


FAULTS = {"answer_altered": answer_altered,
          "tail_batch_altered": tail_batch_altered,
          "state_unchanged": state_unchanged,
          "half_batch": half_batch}
