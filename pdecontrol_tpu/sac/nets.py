"""SAC policy / critic networks (reference ``pdecontrol/sac/policies.py``).

Same architecture family: 2x256 ReLU MLPs over flattened ``[C, H]``
observations; tanh-squashed Gaussian policy with log-std clamped to
[-20, 2] and the squash log-prob correction summed over channel+action dims
(policies.py:112-125); twin Q-network on concat(obs, action)
(policies.py:36-70).  Xavier-uniform weights, zero biases (policies.py:11-13).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from pdecontrol_tpu.models import nn
from pdecontrol_tpu.models.nn import Scope

Array = jax.Array

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -20.0
EPSILON = 1e-6


def _dense(p: Scope, name: str, x: Array, features: int) -> Array:
    return nn.dense(p.child(name), x, features, kernel_init=nn.xavier_uniform)


class GaussianPolicy(nn.Module):
    achannels: int
    asize: int
    hidden: int = 256
    action_scale: float = 1.0
    action_bias: float = 0.0

    def __call__(self, p: Scope, obs: Array) -> Tuple[Array, Array]:
        b = obs.shape[0]
        x = obs.reshape(b, -1)
        x = jax.nn.relu(_dense(p, "linear1", x, self.hidden))
        x = jax.nn.relu(_dense(p, "linear2", x, self.hidden))
        mean = _dense(p, "mean", x, self.achannels * self.asize)
        log_std = _dense(p, "log_std", x, self.achannels * self.asize)
        log_std = jnp.clip(log_std, LOG_SIG_MIN, LOG_SIG_MAX)
        shape = (b, self.achannels, self.asize)
        return mean.reshape(shape), log_std.reshape(shape)

    def sample(self, p: Scope, obs: Array,
               key: Array) -> Tuple[Array, Array, Array]:
        """Reparameterised sample -> (action, log_prob [B, 1], det_mean)."""
        mean, log_std = self(p, obs)
        std = jnp.exp(log_std)
        noise = jax.random.normal(key, mean.shape, mean.dtype)
        x_t = mean + std * noise
        y_t = jnp.tanh(x_t)
        action = y_t * self.action_scale + self.action_bias

        # Normal log-prob + tanh-squash correction (policies.py:119-123).
        log_prob = -0.5 * ((x_t - mean) / std) ** 2 - log_std - 0.5 * jnp.log(
            2.0 * jnp.pi
        )
        log_prob = log_prob - jnp.log(
            self.action_scale * (1.0 - y_t**2) + EPSILON
        )
        log_prob = jnp.sum(log_prob, axis=(1, 2)).reshape(-1, 1)

        det = jnp.tanh(mean) * self.action_scale + self.action_bias
        return action, log_prob, det


class QNetwork(nn.Module):
    """Twin Q (policies.py:36-70)."""

    hidden: int = 256

    def __call__(self, p: Scope, obs: Array,
                 action: Array) -> Tuple[Array, Array]:
        b = obs.shape[0]
        xu = jnp.concatenate([obs.reshape(b, -1), action.reshape(b, -1)], axis=1)

        x1 = jax.nn.relu(_dense(p, "linear1", xu, self.hidden))
        x1 = jax.nn.relu(_dense(p, "linear2", x1, self.hidden))
        x1 = _dense(p, "linear3", x1, 1)

        x2 = jax.nn.relu(_dense(p, "linear4", xu, self.hidden))
        x2 = jax.nn.relu(_dense(p, "linear5", x2, self.hidden))
        x2 = _dense(p, "linear6", x2, 1)
        return x1, x2
