"""Reduced-precision attractor gate: machinery tests (CPU).

The real fidelity verdict is taken on the GPU
(``python -m pdecontrol_tpu.evaluation.bf16_gate``); these tests pin the
gate's statistics plumbing and pass/fail logic so the verdict is
trustworthy.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np

from pdecontrol_tpu.envs.kuramoto import KuramotoSivashinsky
from pdecontrol_tpu.evaluation.bf16_gate import compare, rollout_stats, run_gate
from pdecontrol_tpu.ops.kuramoto import ks_control_period


def _tiny_stats(seed=0):
    env = KuramotoSivashinsky.create(n=32, cfg_steps=10, dtype=jnp.float32)
    return rollout_stats(env, jax.random.PRNGKey(seed), batch=8,
                         transient=3, periods=6)


def test_rollout_stats_shapes_and_determinism():
    a, b = _tiny_stats(), _tiny_stats()
    assert a["spectrum"].shape == (32 // 2 + 1,)
    for k in ("mean_energy", "mean_ux2", "mean_uxx2"):
        assert np.isfinite(a[k]) and a[k] > 0
        assert a[k] == b[k]
    np.testing.assert_array_equal(a["spectrum"], b["spectrum"])


def test_compare_pass_and_fail_logic():
    s = _tiny_stats()
    ok = compare(s, s, rtol_means=0.02, rtol_spec=0.10)
    assert ok["ok"]
    assert ok["spectrum"]["max_rel_err"] == 0.0
    # A 5% energy bias must trip the 2% gate.
    bad = copy.deepcopy(s)
    bad["mean_energy"] *= 1.05
    v = compare(s, bad, rtol_means=0.02, rtol_spec=0.10)
    assert not v["ok"] and not v["mean_energy"]["ok"]
    assert v["mean_ux2"]["ok"]
    # A tail-only spectrum deviation (below the 1e-4-of-peak band) must NOT
    # trip the gate — only dynamically relevant bins are compared.
    tail = copy.deepcopy(s)
    spec = tail["spectrum"].copy()
    weak = spec < 1e-4 * spec.max()
    assert weak.any()
    spec[weak] *= 10.0
    tail["spectrum"] = spec
    assert compare(s, tail, rtol_means=0.02, rtol_spec=0.10)["ok"]


def test_run_gate_with_candidate_solver():
    """The gate runs the caller's candidate solver: the plain solver passes
    against itself exactly, and a solver with a 5% energy bias fails."""
    env = KuramotoSivashinsky.create(n=32, cfg_steps=10, dtype=jnp.float32)
    kw = dict(batch=8, transient=3, periods=6, env=env)
    same = run_gate(ks_control_period, **kw)
    assert same["ok"] and same["spectrum"]["max_rel_err"] == 0.0

    def biased(ops, u, phi, dt, cfg_steps, objective):
        u, r = ks_control_period(ops, u, phi, dt, cfg_steps, objective)
        return 1.05 * u, r

    bad = run_gate(biased, **kw)
    assert not bad["ok"] and not bad["mean_energy"]["ok"]
