"""The diagnostic probes' plain twins against the Pallas kernels of the JAX
package's scripts (interpret mode on the CPU).

``scripts/`` is no package, so each script is loaded by path; nothing in it
changes.  The port's probes are ``sloika_tpu_torch/scripts/``.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sloika_tpu_torch.scripts import bench_dma as tdma
from sloika_tpu_torch.scripts import bench_gru_unroll as tgru
from sloika_tpu_torch.scripts import bench_viterbi_parts as tvit

_SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(_SCRIPTS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jgru = _script("bench_gru_unroll")
jvit = _script("bench_viterbi_parts")
jdma = _script("bench_dma")


@pytest.mark.parametrize("U", [1, 2, 4])
def test_gru_unroll_twin_matches_the_pallas_kernel(U):
    """Both ``run_case``s draw the same inputs; the twin's f32 forward
    agrees with the Pallas kernel's ``precision="highest"`` to 1e-5 (float32
    sums in another order over 8 steps)."""
    ref = jgru.run_case(U, B=4, S=8, T=8)
    got, ms = tgru.run_case(U, B=4, S=8, T=8, device="cpu")
    assert ms is None
    assert got.shape == ref.shape == (8, 4, 8)
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-5


def _jax_parts(variant, post, stay, nstep=4):
    """The traceback of the script's Pallas kernel for ``variant``, built
    around its ``make_kernel`` as ``run_variant`` (:103-130) builds it."""
    T, B, K = post.shape
    e = np.zeros((K // nstep, K), np.float32)
    e[np.arange(K) // nstep, np.arange(K)] = 1.0
    spec = lambda shape, index: pl.BlockSpec(shape, index,
                                             memory_space=pltpu.VMEM)
    tb, _ = pl.pallas_call(
        jvit.make_kernel(variant, B, K, nstep),
        grid=(T,),
        in_specs=[spec((1, B, K), lambda t: (t, 0, 0)),
                  spec((1, B, 1), lambda t: (t, 0, 0)),
                  spec((K // nstep, K), lambda t: (0, 0))],
        out_specs=[spec((1, B, K), lambda t: (t, 0, 0)),
                   spec((B, K), lambda t: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((T, B, K), jnp.int8),
                   jax.ShapeDtypeStruct((B, K), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((B, K), jnp.float32)],
        interpret=True,
    )(jnp.asarray(post), jnp.asarray(stay), jnp.asarray(e))
    return np.asarray(tb)


def _xla_log(x):
    """XLA's float32 log, which the Pallas kernel takes: torch's differs
    from it in the last ulp on the CPU (ROADMAP, traps)."""
    return torch.from_numpy(np.array(jnp.log(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("variant", jvit.VARIANTS)
def test_viterbi_parts_twin_matches_the_pallas_kernel(variant):
    """The twin's traceback equals the Pallas kernel's bit for bit on the
    script's own inputs (Dirichlet(0.05) posteriors, many of them at the
    1e-10 floor, so ties are common), given the same log."""
    assert tvit.VARIANTS == jvit.VARIANTS
    post, stay = tvit.variant_inputs(2, 5, K=64)
    ref = _jax_parts(variant, post, stay)
    tb, vf = tvit.viterbi_parts_plain(variant, torch.from_numpy(post),
                                      torch.from_numpy(stay), log=_xla_log)
    assert tb.dtype == torch.int8 and vf.shape == (2, 64)
    assert np.array_equal(tb.numpy(), ref)
    if variant not in ("noop", "nolog", "f32store"):
        assert (ref[1:] != 0).any()          # the variant wrote codes


def _chunks_the_tpu_ring_reads(nchunk, nslots):
    """The Pallas ring (bench_dma.py:40-48) starts the copy of chunk
    c + nslots into slot c % nslots before it reads chunk c from that slot.
    Interpret mode copies at the start, so chunk c is read only where no
    refill follows it: the chunks it folds are c + nslots for c < nchunk -
    nslots, and the last nslots."""
    return sorted({c + nslots for c in range(nchunk - nslots)}
                  | set(range(max(0, nchunk - nslots), nchunk)))


@pytest.mark.parametrize("rows,nslots", [(1, 2), (2, 3), (3, 2)])
def test_hbm_ring_twin_is_the_max_the_tpu_ring_races(rows, nslots,
                                                     monkeypatch):
    """The twin is bit-equal to the script's plain reference, the max over
    the first Tr = (T // rows) * rows rows (T = 11 is no multiple of rows).
    The Pallas kernel in interpret mode folds other chunks: it refills a
    slot before reading it (ROADMAP Queue 3), which this pins."""
    B, T, K = 4, 11, 128
    seen = []
    jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        compiled = jit(fn, *args, **kwargs)

        def call(*a):
            out = compiled(*a)
            seen.append((np.asarray(a[0]), np.asarray(out)))
            return out
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    jdma.run_case(rows, nslots, B, T, K=K)
    monkeypatch.undo()
    x, ref = seen[0]
    nchunk = T // rows
    assert np.array_equal(x, tdma.case_inputs(rows, B, T, K))
    got, ms = tdma.run_case(rows, nslots, B, T, K=K, device="cpu")
    assert ms is None
    assert np.array_equal(got.numpy(), x[:nchunk * rows].max(0))
    read = _chunks_the_tpu_ring_reads(nchunk, nslots)
    assert read[0] > 0                       # chunk 0 is never folded
    folded = np.concatenate([x[c * rows:(c + 1) * rows] for c in read])
    assert np.array_equal(ref, folded.max(0))
    assert not np.array_equal(ref, got.numpy())
