"""Golden numerics: the JAX KS/Burgers solvers vs the NumPy/SciPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdecontrol_tpu.envs.kuramoto import KuramotoSivashinsky
from pdecontrol_tpu.envs.burgers import Burgers
from pdecontrol_tpu.ops import stencils
from pdecontrol_tpu.ops.burgers import BurgersOperators, burgers_heun_substep, burgers_rhs
from pdecontrol_tpu.ops.kuramoto import (
    KSOperators,
    ks_control_period,
    ks_derivatives,
    ks_rhs,
    ks_rk4_substep,
)

from .oracles import BurgersOracle, KSOracle


@pytest.fixture(scope="module")
def oracle():
    return KSOracle()


@pytest.fixture(scope="module")
def ops():
    return KSOperators.create(64, 22.0, dtype=jnp.float64)


def _field(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.4, 0.4, size=n)


def test_circulant_matches_convolve1d(oracle):
    """Stencil matrices reproduce scipy.ndimage.convolve1d with the
    reference's pre-flipped tables."""
    from scipy.ndimage import convolve1d

    u = _field(1)
    for taps, table in [
        (stencils.FIRST_DERIV_UPWIND_FWD, [-1 / 4, 4 / 3, -3, 4, -25 / 12, 0, 0, 0, 0]),
        (stencils.FIRST_DERIV_UPWIND_BWD, [0, 0, 0, 0, 25 / 12, -4, 3, -4 / 3, 1 / 4]),
        (stencils.SECOND_DERIV_CENTRAL_6, [1 / 90, -3 / 20, 3 / 2, -49 / 18, 3 / 2, -3 / 20, 1 / 90]),
        (
            stencils.FOURTH_DERIV_CENTRAL_6,
            [7 / 240, -2 / 5, 169 / 60, -122 / 15, 91 / 8, -122 / 15, 169 / 60, -2 / 5, 7 / 240],
        ),
    ]:
        mat = stencils.circulant(taps, 64)
        expected = convolve1d(u, weights=table, mode="wrap")
        np.testing.assert_allclose(mat @ u, expected, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(
            stencils.apply_taps_numpy(u, taps), expected, rtol=1e-13, atol=1e-13
        )


def test_rhs_matches_oracle(oracle, ops):
    u = _field(2)
    phi = 0.3 * np.sin(2 * np.pi * np.arange(64) / 64)
    expected, (ex, exx, exxxx) = oracle.rhs(u, phi)

    got = ks_rhs(ops, jnp.asarray(u), jnp.asarray(phi))
    np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-12, atol=1e-12)

    ux, uxx, uxxxx = ks_derivatives(ops, jnp.asarray(u))
    np.testing.assert_allclose(np.asarray(ux), ex, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(uxx), exx, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(uxxxx), exxxx, rtol=1e-12, atol=1e-10)


def test_rhs_batched(ops, oracle):
    rng = np.random.default_rng(3)
    u = rng.uniform(-0.4, 0.4, size=(5, 64))
    phi = rng.normal(size=(5, 64))
    got = np.asarray(ks_rhs(ops, jnp.asarray(u), jnp.asarray(phi)))
    for b in range(5):
        expected, _ = oracle.rhs(u[b], phi[b])
        np.testing.assert_allclose(got[b], expected, rtol=1e-12, atol=1e-12)


def test_rk4_substep(ops, oracle):
    u = _field(4)
    phi = 0.1 * np.cos(2 * np.pi * np.arange(64) / 64)
    got = np.asarray(ks_rk4_substep(ops, 1e-3, jnp.asarray(u), jnp.asarray(phi)))
    expected, _ = oracle.control_period(u, phi)
    # single substep comparison
    oracle1 = KSOracle(cfg_steps=1)
    expected, _ = oracle1.control_period(u, phi)
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-12)


@pytest.mark.slow
def test_full_episode_equivalence():
    """Solver-equivalence gate over a full 400-step control episode.

    KS is chaotic: *any* two floating-point realisations of the same scheme
    (even scipy linked against different BLAS) diverge exponentially from
    summation-order noise, so a free-running trajectory comparison measures
    Lyapunov growth, not scheme fidelity.  The rigorous gate is therefore
    *shadowing*: at every one of the 400 agent steps the JAX solver is
    restarted from the oracle's state and must reproduce the oracle's next
    control period (250 RK4 sub-steps) to <=1e-9 relative L2 — far inside
    the 1e-6 bar — for the whole episode, including both reward objectives.
    A free-running comparison is additionally bounded below.
    """
    env = KuramotoSivashinsky.create(dtype=jnp.float64)
    oracle_l2 = KSOracle(objective="dissipation")  # quirk -> l2control
    oracle_di = KSOracle(objective="")  # empty string -> dissipation

    u = _field(5)
    rng = np.random.default_rng(6)
    u_free = jnp.asarray(u)

    period_l2 = jax.jit(
        lambda u, phi: ks_control_period(env.ops, u, phi, env.dt, env.cfg_steps, "l2control")
    )
    period_di = jax.jit(
        lambda u, phi: ks_control_period(env.ops, u, phi, env.dt, env.cfg_steps, "dissipation")
    )

    max_shadow = 0.0
    max_rew = 0.0
    free_rels = []
    for t in range(400):
        action = rng.uniform(-1.0, 1.0, size=4)
        phi = np.squeeze(action[None, :] @ oracle_l2.forcing_matrix())
        phi_j = jnp.asarray(phi)

        u_prev = u
        u, rew_l2 = oracle_l2.control_period(u, phi)
        _, rew_di = oracle_di.control_period(u_prev, phi)

        # Shadowed: restart from the oracle's state for this period.
        u_shadow, rewj_l2 = period_l2(jnp.asarray(u_prev), phi_j)
        _, rewj_di = period_di(jnp.asarray(u_prev), phi_j)
        rel = np.linalg.norm(np.asarray(u_shadow) - u) / np.linalg.norm(u)
        max_shadow = max(max_shadow, rel)
        max_rew = max(max_rew, abs(float(rewj_l2) - rew_l2) / abs(rew_l2))
        max_rew = max(max_rew, abs(float(rewj_di) - rew_di) / (abs(rew_di) + 1e-12))

        # Free-running: never re-synchronised.
        u_free, _ = period_l2(u_free, phi_j)
        free_rels.append(np.linalg.norm(np.asarray(u_free) - u) / np.linalg.norm(u))

    assert max_shadow <= 1e-9, f"scheme mismatch: shadow rel L2 {max_shadow:.3e}"
    assert max_rew <= 1e-9, f"reward mismatch: rel {max_rew:.3e}"
    # Free-run divergence is pure chaotic roundoff amplification; it must stay
    # within the 1e-6 bar for most of the episode and never blow past 1e-4.
    assert free_rels[300] <= 1e-6, f"free-run diverged early: {free_rels[300]:.3e}"
    assert free_rels[-1] <= 1e-4, f"free-run blow-up: {free_rels[-1]:.3e}"


def test_env_step_and_forcing_pipeline():
    """env.step == oracle with the forcing matrix applied to the action."""
    env = KuramotoSivashinsky.create(dtype=jnp.float64)
    oracle = KSOracle()

    key = jax.random.PRNGKey(0)
    u0 = _field(7)
    from pdecontrol_tpu.envs.kuramoto import EnvState

    state = EnvState(u=jnp.asarray(u0), step=jnp.zeros((), jnp.int32), key=key)
    action = np.array([[0.5, -0.25, 0.1, 0.9]])

    state, out = env.step(state, jnp.asarray(action))
    phi = np.squeeze(action @ oracle.forcing_matrix())
    expected_u, expected_rew = oracle.control_period(u0, phi)

    np.testing.assert_allclose(np.asarray(state.u), expected_u, rtol=1e-9)
    np.testing.assert_allclose(float(out.reward), expected_rew, rtol=1e-9)
    assert not bool(out.terminated)
    assert not bool(out.truncated)
    assert int(out.info["step"]) == 1


def test_episode_truncation_and_autoreset():
    env = KuramotoSivashinsky.create(dtype=jnp.float64, t_max=1.0)  # 4 steps
    assert env.max_episode_steps == 4

    key = jax.random.PRNGKey(1)
    pool = jax.random.uniform(key, (8, 64), minval=-0.4, maxval=0.4, dtype=jnp.float64)
    state = env.reset_from_pool(key, pool, batch_shape=(3,))
    actions = jnp.zeros((3, 1, 4))

    for t in range(3):
        state, out = env.vec_step(state, actions, pool)
        assert not bool(out.truncated.any())
    state, out = env.vec_step(state, actions, pool)
    assert bool(out.truncated.all())
    assert not bool(out.terminated.any())
    # after auto-reset, steps are back to zero and obs differ from final_obs
    assert (np.asarray(state.step) == 0).all()
    assert not np.allclose(np.asarray(out.obs), np.asarray(out.info["final_obs"]))


def test_burgers_matches_oracle():
    ops = BurgersOperators.create(64, 16.0, nu=0.05, dtype=jnp.float64)
    oracle = BurgersOracle()
    rng = np.random.default_rng(8)
    u = 0.5 * np.sin(2 * np.pi * np.arange(64) / 64) + 0.1 * rng.normal(size=64)
    phi = 0.2 * np.cos(2 * np.pi * np.arange(64) / 64)

    got_rhs = np.asarray(burgers_rhs(ops, jnp.asarray(u), jnp.asarray(phi)))
    np.testing.assert_allclose(got_rhs, oracle.rhs(u, phi), rtol=1e-12, atol=1e-12)

    uj = jnp.asarray(u)
    un = u.copy()
    for _ in range(1000):
        uj = burgers_heun_substep(ops, 1e-3, uj, jnp.asarray(phi))
        un = oracle.heun(un, phi)
    rel = np.linalg.norm(np.asarray(uj) - un) / np.linalg.norm(un)
    assert rel <= 1e-9


def test_burgers_env_runs():
    env = Burgers.create(dtype=jnp.float64)
    state = env.reset(jax.random.PRNGKey(0), batch_shape=(2,))
    state, out = env.step(state, jnp.zeros((2, 1, 4)))
    assert out.obs.shape == (2, 1, 64)
    assert np.isfinite(np.asarray(out.reward)).all()


def test_reset_pool_statistics():
    """Pool states live on the attractor: RMS amplitude in the known KS band."""
    env = KuramotoSivashinsky.create(dtype=jnp.float64)
    from pdecontrol_tpu.envs.kuramoto import make_reset_pool

    pool = make_reset_pool(env, jax.random.PRNGKey(2), pool_size=8, chains=8)
    rms = np.sqrt(np.mean(np.asarray(pool) ** 2, axis=-1))
    assert pool.shape == (8, 64)
    # L=22 KS attractor has O(1) RMS amplitude; transients from U(-0.4, 0.4)
    # must have left the near-zero unstable equilibrium.
    assert (rms > 0.3).all() and (rms < 5.0).all()


def test_native_cc_solver_matches_scipy_oracle():
    """The C++ integrator (independent implementation) matches the
    scipy-based oracle at float64 over a control period."""
    from pdecontrol_tpu.utils import native

    oracle = KSOracle()
    u = _field(9)
    phi = 0.2 * np.sin(2 * np.pi * np.arange(64) / 64)

    got = native.ks_rhs(u, phi, oracle.dx)
    expected, _ = oracle.rhs(u, phi)
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-12)

    got_u, got_r = native.ks_control_period(u, phi, oracle.dx, 1e-3, 250)
    exp_u, exp_r = oracle.control_period(u, phi)
    np.testing.assert_allclose(got_u, exp_u, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(got_r, exp_r, rtol=1e-9)

    # dissipation objective too
    oracle_d = KSOracle(objective="")
    _, got_rd = native.ks_control_period(u, phi, oracle.dx, 1e-3, 50,
                                         objective="dissipation")
    oracle_d.cfg_steps = 50
    _, exp_rd = oracle_d.control_period(u, phi)
    np.testing.assert_allclose(got_rd, exp_rd, rtol=1e-9)
