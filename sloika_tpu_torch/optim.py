"""Optimisers of the port (cf. ``sloika_tpu/optim.py``, and the reference
``sloika/updates.py`` it re-implements).

* :func:`sgd`: SGD with momentum and elementwise +/-clip gradient clipping;
* :func:`adamski`: "ADAMski", Adam with momentum phased in from zero at rate
  ``mrate``; with ``mrate=None`` it is Adam with bias correction
  (:func:`adam`);
* :func:`param_sqr`: the sum of squared parameters, for the L2 penalty.

Each optimiser is a pair ``(init, update)``.  ``init(layer)`` makes the
state; ``update(layer, state, lr)`` reads each parameter's ``.grad``,
updates the parameters and the state's tensors in place, and returns the
new state.  The state is :class:`OptState` / :class:`SGDState` with trees
shaped like the JAX package's parameter tree, so checkpoints interchange.

The step-size arithmetic follows the JAX package in float32: the constants
``m_k``, ``ld0``, ``ld1``, ``m_rate`` and the step count are float32, and
the count is a 0-d float32 tensor kept on the CPU (so reading it never
waits for the device).  The momentum factor mixes the *old* count in its
first term and the *new* count elsewhere (``sloika_tpu/optim.py:84-87``).
"""
from collections import namedtuple

import numpy as np
import torch

from sloika_tpu_torch.nn.core import tree_items, tree_map

OptState = namedtuple("OptState", ["count", "mu", "nu"])
SGDState = namedtuple("SGDState", ["vel"])


def param_sqr(layer):
    """Sum of squares of all the layer's parameters."""
    return sum(torch.sum(torch.square(p))
               for _, p in tree_items(layer.param_tensors()))


def clip_grad(g, clip):
    return torch.clamp(g, -clip, clip)


def _zeros_like_params(layer):
    return tree_map(lambda p: torch.zeros_like(p.detach()),
                    layer.param_tensors())


def _leaves(tree):
    return [leaf for _, leaf in tree_items(tree)]


def state_to(state, device):
    """The optimiser state with its tensor trees on ``device`` (the count
    stays on the CPU)."""
    move = lambda t: t.to(device)
    if isinstance(state, SGDState):
        return SGDState(vel=tree_map(move, state.vel))
    return OptState(count=state.count, mu=tree_map(move, state.mu),
                    nu=tree_map(move, state.nu))


def sgd(momentum, clip=5.0):
    """SGD with momentum (``sloika_tpu/optim.py:39-53``); returns
    ``(init, update)``."""
    if momentum < 0:
        raise ValueError("Momentum for SGD must be non-negative")

    def init(layer):
        return SGDState(vel=_zeros_like_params(layer))

    def update(layer, state, lr):
        lr = float(np.float32(lr))
        with torch.no_grad():
            for p, v in zip(_leaves(layer.param_tensors()),
                            _leaves(state.vel)):
                # vel = momentum * vel - lr * clip(g); p = p + vel
                v.mul_(momentum).sub_(clip_grad(p.grad, clip) * lr)
                p.add_(v)
        return state

    return init, update


def adamski(decay=(0.9, 0.999), epsilon=1e-8, clip=5.0, mrate=0.0005):
    """ADAMski (``sloika_tpu/optim.py:56-102``); returns ``(init, update)``.

    :param decay: (decay1, decay2) for gradient and curvature estimates
    :param mrate: rate at which momentum ramps up from zero; None = plain Adam
    """
    d0, d1 = float(decay[0]), float(decay[1])
    if not (0.0 < d0 < 1.0 and 0.0 < d1 < 1.0):
        raise ValueError("Decay must be in (0, 1)")
    if mrate is not None and not mrate > 0.0:
        raise ValueError("Rate of momentum increase must be positive")

    # the JAX package's float32 constants, computed the same way
    if mrate is not None:
        m_rate = -np.float32(mrate)
        m_p = np.exp(m_rate, dtype=np.float32)
        m_k = np.float32((1.0 - d0) * d0 * m_p / (1.0 - m_p * d0))
    else:
        m_rate = np.float32(-1e30)
        m_k = np.float32(0.0)
    ld0, ld1 = np.log(d0, dtype=np.float32), np.log(d1, dtype=np.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    m_k_t, m_rate_t, ld0_t, ld1_t = f32(m_k), f32(m_rate), f32(ld0), f32(ld1)
    ld0_m_rate_t = f32(ld0 + m_rate)

    def init(layer):
        return OptState(count=torch.zeros((), dtype=torch.float32),
                        mu=_zeros_like_params(layer),
                        nu=_zeros_like_params(layer))

    def update(layer, state, lr):
        t_old = state.count
        t_new = t_old + 1.0
        momentum_factor = (m_k_t * torch.expm1(t_old * ld0_m_rate_t)
                           - torch.expm1(t_new * ld0_t))
        lr_t = (f32(lr) * torch.sqrt(-torch.expm1(t_new * ld1_t))
                / momentum_factor)
        momentum_decay = -d0 * torch.expm1(t_new * m_rate_t)
        # float32 values, exact as Python floats
        lr_t, momentum_decay = float(lr_t), float(momentum_decay)
        with torch.no_grad():
            for p, m, v in zip(_leaves(layer.param_tensors()),
                               _leaves(state.mu), _leaves(state.nu)):
                g = clip_grad(p.grad, clip)
                m.mul_(momentum_decay).add_((1.0 - d0) * g)
                v.mul_(d1).add_((1.0 - d1) * torch.square(g))
                p.sub_(lr_t * m / (torch.sqrt(v) + epsilon))
        return OptState(count=t_new, mu=state.mu, nu=state.nu)

    return init, update


def adam(decay=(0.9, 0.999), epsilon=1e-8, clip=5.0):
    """Plain Adam (ADAMski with the momentum ramp disabled)."""
    return adamski(decay=decay, epsilon=epsilon, clip=clip, mrate=None)
