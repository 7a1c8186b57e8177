"""Env-level wiring of the KS solver: ``KuramotoSivashinsky.step`` is the
plain control period applied to the jets' forcing, for any batch shape, and
the reset pool's burn-in is the same unforced period repeated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdecontrol_tpu.envs.kuramoto import (
    EnvState,
    KuramotoSivashinsky,
    make_reset_pool,
)
from pdecontrol_tpu.ops.kuramoto import ks_control_period


def _env(objective):
    # legacy_objective=False so the objective string is honored literally
    # (the quirk path is covered by test_solver.py).
    return KuramotoSivashinsky.create(
        cfg_steps=25,
        objective=objective,
        legacy_objective=False,
        dtype=jnp.float32,
    )


def _state(env, batch_shape=(8,), seed=0):
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, batch_shape + (env.n,), minval=-1.0,
                           maxval=1.0, dtype=jnp.float32)
    return EnvState(u=u, step=jnp.zeros(batch_shape, jnp.int32),
                    key=jax.random.PRNGKey(seed + 1))


@pytest.mark.parametrize("objective", ["l2control", "dissipation"])
def test_env_step_matches_plain_period(objective):
    env = _env(objective)
    state = _state(env)
    action = jax.random.uniform(jax.random.PRNGKey(42),
                                (8, 1, env.num_jets), minval=-1.0,
                                maxval=1.0, dtype=jnp.float32)
    new, out = jax.jit(env.step)(state, action)
    u, r = ks_control_period(env.ops, state.u, env.action_to_phi(action),
                             env.dt, env.cfg_steps, objective)
    np.testing.assert_array_equal(np.asarray(out.obs[:, 0]), np.asarray(u))
    np.testing.assert_array_equal(np.asarray(new.u), np.asarray(u))
    np.testing.assert_array_equal(np.asarray(out.reward), np.asarray(r))
    np.testing.assert_array_equal(np.asarray(new.step), 1)


@pytest.mark.parametrize("batch_shape", [(), (2, 3)])
def test_env_step_batch_shapes(batch_shape):
    """Unbatched and multi-axis batches give the same rows as a flat
    batch."""
    env = _env("dissipation")
    state = _state(env, batch_shape, seed=7)
    action = jnp.full(batch_shape + (1, env.num_jets), -0.2, jnp.float32)
    _, out = env.step(state, action)
    assert out.obs.shape == batch_shape + (1, env.n)
    assert out.reward.shape == batch_shape
    flat = EnvState(u=state.u.reshape(-1, env.n),
                    step=state.step.reshape(-1), key=state.key)
    _, flat_out = env.step(flat, action.reshape(-1, 1, env.num_jets))
    np.testing.assert_allclose(np.asarray(out.obs).reshape(-1, 1, env.n),
                               np.asarray(flat_out.obs), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(out.reward).reshape(-1),
                               np.asarray(flat_out.reward), rtol=1e-6,
                               atol=1e-7)


def test_reset_pool_transient_matches_plain_periods():
    """The reset pool's burn-in equals repeated plain unforced periods from
    the same ICs."""
    env = KuramotoSivashinsky.create(n=32, cfg_steps=10).replace(
        transient_time=0.05)
    key = jax.random.PRNGKey(9)
    pool = make_reset_pool(env, key, pool_size=4, chains=4)
    u = env.sample_ic(key, (4,))
    for _ in range(env.transient_periods):
        u, _ = ks_control_period(env.ops, u, jnp.zeros_like(u), env.dt,
                                 env.cfg_steps, "l2control")
    np.testing.assert_allclose(np.asarray(pool), np.asarray(u),
                               rtol=1e-6, atol=1e-7)
