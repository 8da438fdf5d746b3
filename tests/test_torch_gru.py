"""The port's GRU against the JAX package's (CPU).

The port's plain masked scan (the CUDA kernel's twin) is held against the
fused Pallas GRU in interpret mode (``pallas_gru.run_gru_fused``) and the
XLA scan of ``Gru.apply``, forward and reverse with a ragged mask, compared
under the mask at atol 1e-5: the f32 matmul summation orders differ.  The
CUDA kernel is held against the twin in tests/test_torch_kernels.py and by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sloika_tpu.nn as jnn
from sloika_tpu.nn import pallas_gru
from sloika_tpu_torch import nn as tnn
from sloika_tpu_torch.serialize import params_from_numpy

ATOL = 1e-5


def _case(S, T=37, B=5, insize=6, seed=0):
    rs = np.random.RandomState(seed)
    layer = jnn.Gru(insize, S, init=jnn.truncated_normal(0.5), has_bias=True)
    params = layer.init(jax.random.PRNGKey(seed))
    x = rs.normal(size=(T, B, insize)).astype(np.float32)
    lengths = rs.randint(1, T + 1, size=B)
    lengths[0] = T
    mask = np.arange(T)[:, None] < lengths[None, :]
    port = tnn.Gru(insize, S, has_bias=True)
    params_from_numpy(port, {k: np.asarray(v) for k, v in params.items()})
    return layer, params, port, x, mask


def _under_mask(a, b, mask):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        * mask[:, :, None]))


@pytest.mark.parametrize("S", [8, 32])
@pytest.mark.parametrize("reverse", [False, True])
def test_port_gru_matches_pallas_and_xla(S, reverse):
    layer, params, port, x, mask = _case(S)
    jx, jmask = jnp.asarray(x), jnp.asarray(mask)
    ref_xla = layer.apply(params, jx, reverse=reverse, mask=jmask)
    ref_pallas = pallas_gru.run_gru_fused(
        params, layer.input_proj(params, jx), reverse=reverse, mask=jmask)
    with torch.no_grad():
        out = port(torch.from_numpy(x), reverse=reverse,
                   mask=torch.from_numpy(mask)).numpy()
    assert _under_mask(out, ref_xla, mask) <= ATOL
    assert _under_mask(out, ref_pallas, mask) <= ATOL


@pytest.mark.parametrize("reverse", [False, True])
def test_masked_steps_carry_state(reverse):
    """The plain twin follows the Pallas kernel's contract: a masked step
    keeps and emits the carried state, so padded tails emit zeros in
    reverse and the last valid state forward."""
    _, params, port, x, mask = _case(8, seed=3)
    with torch.no_grad():
        out = port(torch.from_numpy(x), reverse=reverse,
                   mask=torch.from_numpy(mask)).numpy()
    for b in range(x.shape[1]):
        L = int(mask[:, b].sum())
        tail = out[L:, b]
        expect = 0.0 if reverse else out[L - 1, b]
        np.testing.assert_array_equal(tail, np.broadcast_to(expect,
                                                            tail.shape))
