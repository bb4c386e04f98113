"""The Q-network of the DQN signal-control learners (the JAX package's
rl/dqn.py, the parts the ring learner uses): a two-layer MLP over
per-intersection observations, shared across intersections.

The parameters keep the JAX package's orientation (obs @ w1, h @ w2), so
carry.qparams_from_numpy moves JAX's QParams across without a transpose.
"""

from typing import NamedTuple

import numpy as np
import torch


class QParams(NamedTuple):
    w1: torch.Tensor          # (obs_dim, hidden)
    b1: torch.Tensor          # (hidden,)
    w2: torch.Tensor          # (hidden, n_actions)
    b2: torch.Tensor          # (n_actions,)


def init_params(gen: torch.Generator, obs_dim: int, hidden: int,
                n_actions: int, device=None) -> QParams:
    """Weights uniform in +-1/sqrt(fan-in) drawn from `gen` (on `device`),
    biases 0; leaf tensors that require grad."""
    dev = gen.device if device is None else torch.device(device)

    def uni(shape, s):
        u = torch.rand(shape, generator=gen, device=dev)
        return (u * (2 * s) - s).requires_grad_()
    s1 = float(1.0 / np.sqrt(obs_dim))
    s2 = float(1.0 / np.sqrt(hidden))
    zeros = lambda n: torch.zeros(n, device=dev, requires_grad=True)
    return QParams(w1=uni((obs_dim, hidden), s1), b1=zeros(hidden),
                   w2=uni((hidden, n_actions), s2), b2=zeros(n_actions))


def copy_params(p: QParams) -> QParams:
    """A detached copy (the target network; the optimizer updates the
    online parameters in place)."""
    return QParams(*(t.detach().clone() for t in p))


def q_values(p: QParams, obs):
    h = torch.relu(obs @ p.w1 + p.b1)
    return h @ p.w2 + p.b2
