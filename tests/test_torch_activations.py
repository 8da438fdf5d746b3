"""The port's activation functions against the JAX package's (CPU).

Every function of ``sloika_tpu.activations.BY_NAME``, by name, on a grid
that holds 0, +/-1e-3, +/-30 and the kinks of the clipped functions
(+/-1, +/-2): value and gradient within 1e-6 absolute or 1e-6 relative
(float32 transcendental functions of two libraries).  At a kink the
gradient is JAX's: 1/2 at a tie of ``maximum`` or ``clip``, 1 for ``abs``
at 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sloika_tpu import activations as jact
from sloika_tpu_torch import activations as tact

GRID = np.array([-30.0, -3.0, -2.0, -1.5, -1.0, -0.5, -1e-3, 0.0, 1e-3, 0.5,
                 1.0, 1.5, 2.0, 3.0, 30.0], np.float32)
TOL = 1e-6


def _close(got, ref):
    return bool(np.all(np.abs(got - ref) <= TOL + TOL * np.abs(ref)))


def test_the_port_has_every_activation_of_the_jax_package():
    # and swish, bonito's, which the JAX package lacks
    assert sorted(tact.BY_NAME) == sorted(set(jact.BY_NAME) | {"swish"})
    for name, f in tact.BY_NAME.items():
        assert f.__name__ == name and tact.by_name(name) is f
    with pytest.raises(KeyError, match="unknown activation"):
        tact.by_name("mish")


@pytest.mark.parametrize("name", sorted(jact.BY_NAME))
def test_value_and_gradient_match_jax(name):
    fj, ft = jact.BY_NAME[name], tact.BY_NAME[name]
    ref = np.asarray(fj(jnp.asarray(GRID)))
    gref = np.asarray(jax.vmap(jax.grad(fj))(jnp.asarray(GRID)))
    x = torch.from_numpy(GRID.copy()).requires_grad_(True)
    y = ft(x)
    y.sum().backward()
    assert y.dtype == torch.float32
    assert _close(y.detach().numpy(), ref), (y.detach().numpy(), ref)
    assert _close(x.grad.numpy(), gref), (x.grad.numpy(), gref)


def test_softplus_at_large_inputs_equals_jax():
    x = torch.tensor([25.0, 30.0])
    ref = np.asarray(jact.softplus(jnp.asarray([25.0, 30.0])))
    assert np.array_equal(tact.softplus(x).numpy(), ref)
