"""Attractor-statistics fidelity gate for reduced-precision KS solvers.

A solver that computes in fewer bits than fp32 (TF32, 3xTF32, bf16 limbs)
carries growing per-period error.  On a chaotic attractor trajectories
decorrelate no matter the precision, so the meaningful fidelity statement is
STATISTICAL: long-run attractor statistics must match full-precision ones.
This gate runs a candidate control-period solver (any function with the
signature of ``ops.kuramoto.ks_control_period``) and the plain fp32 XLA
reference for ``--periods`` control periods (after a discarded transient) on
a ``--batch``-wide ensemble and compares

- mean energy            ``E = <u^2>``
- mean dissipation terms ``<u_x^2>``, ``<u_xx^2>`` (the reward's fields)
- the energy spectrum    ``<|rfft(u)|^2>`` over resolved wavenumbers.

Exit status 0 = within tolerances; the verdict JSON goes to stdout and
(with ``--output``) to disk.  From the command line the candidate is named
as ``module:function``; run it on the GPU, e.g.:

    python -m pdecontrol_tpu.evaluation.bf16_gate \
        --solver pdecontrol_tpu.ops.kuramoto:ks_control_period \
        --output gate.json

No reference counterpart (the reference integrates fp64 NumPy only,
kuramoto.py:83-90); tolerances are set by the KS literature convention that
attractor means are reproducible to a few percent at these sample sizes.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import Callable, Dict, Optional

import numpy as np


def rollout_stats(env, key, batch: int, transient: int, periods: int,
                  solver: Optional[Callable] = None) -> Dict:
    """Unforced attractor rollout of ``env``'s physics through ``solver``
    (default: the plain XLA ``ks_control_period``); returns attractor
    statistics over ``periods`` post-transient control periods."""
    import jax
    import jax.numpy as jnp

    from pdecontrol_tpu.ops.kuramoto import ks_control_period, ks_derivatives

    solver = solver or ks_control_period
    ku, _ = jax.random.split(key)
    u0 = jax.random.uniform(ku, (batch, env.n), minval=-1.0, maxval=1.0,
                            dtype=jnp.float32)
    phi = jnp.zeros_like(u0)

    def period(u):
        return solver(env.ops, u, phi, env.dt, env.cfg_steps,
                      env.effective_objective)[0]

    @jax.jit
    def run(u):
        def burn(u, _):
            return period(u), None

        u, _ = jax.lax.scan(burn, u, None, length=transient)

        def collect(u, _):
            u = period(u)
            u_x, u_xx, _ = ks_derivatives(env.ops, u)
            spec = jnp.abs(jnp.fft.rfft(u, axis=-1)) ** 2
            return u, (
                jnp.mean(u * u),
                jnp.mean(u_x * u_x),
                jnp.mean(u_xx * u_xx),
                jnp.mean(spec, axis=0),
            )

        _, (e, dx, dxx, spec) = jax.lax.scan(
            collect, u, None, length=periods
        )
        return (jnp.mean(e), jnp.mean(dx), jnp.mean(dxx),
                jnp.mean(spec, axis=0))

    e, dx, dxx, spec = jax.device_get(run(u0))
    return {
        "mean_energy": float(e),
        "mean_ux2": float(dx),
        "mean_uxx2": float(dxx),
        "spectrum": np.asarray(spec),
    }


def compare(ref: Dict, cand: Dict, rtol_means: float, rtol_spec: float) -> Dict:
    """Relative-error comparison; the spectrum is compared bin-wise on
    wavenumbers carrying at least 1e-4 of the peak power (the dynamically
    relevant band — hyperviscous tail bins hold no energy and only noise)."""
    checks = {}
    for k in ("mean_energy", "mean_ux2", "mean_uxx2"):
        rel = abs(cand[k] - ref[k]) / abs(ref[k])
        checks[k] = {"reference": ref[k], "candidate": cand[k],
                     "rel_err": rel, "tol": rtol_means,
                     "ok": bool(rel <= rtol_means)}
    s_ref, s_cand = ref["spectrum"], cand["spectrum"]
    band = s_ref >= 1e-4 * s_ref.max()
    rel = np.abs(s_cand[band] - s_ref[band]) / s_ref[band]
    checks["spectrum"] = {
        "bins_compared": int(band.sum()),
        "max_rel_err": float(rel.max()),
        "mean_rel_err": float(rel.mean()),
        "tol": rtol_spec,
        "ok": bool(rel.max() <= rtol_spec),
    }
    checks["ok"] = all(v["ok"] for v in checks.values())
    return checks


def run_gate(solver: Callable, batch: int = 512, transient: int = 100,
             periods: int = 400, rtol_means: float = 0.02,
             rtol_spec: float = 0.10, seed: int = 0, env=None) -> Dict:
    """Compare ``solver``'s attractor statistics with the plain fp32 XLA
    solver's on the default KS env (or ``env``)."""
    import jax
    import jax.numpy as jnp

    from pdecontrol_tpu.envs.kuramoto import KuramotoSivashinsky

    env = env or KuramotoSivashinsky.create(dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    ref = rollout_stats(env, key, batch, transient, periods)
    cand = rollout_stats(env, key, batch, transient, periods, solver)
    verdict = compare(ref, cand, rtol_means, rtol_spec)
    verdict["config"] = {
        "batch": batch, "transient_periods": transient, "periods": periods,
        "total_agent_steps": batch * periods,
        "solver": getattr(solver, "__name__", repr(solver)),
        "device": jax.devices()[0].device_kind,
    }
    return verdict


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--transient", type=int, default=100)
    p.add_argument("--periods", type=int, default=400)
    p.add_argument("--rtol_means", type=float, default=0.02)
    p.add_argument("--rtol_spec", type=float, default=0.10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--solver", type=str, required=True,
                   help="candidate control-period solver, module:function")
    p.add_argument("--output", type=str, default=None)
    args = p.parse_args(argv)

    module, name = args.solver.split(":")
    solver = getattr(importlib.import_module(module), name)
    verdict = run_gate(solver, args.batch, args.transient, args.periods,
                       args.rtol_means, args.rtol_spec, args.seed)
    blob = json.dumps(verdict, indent=2)
    print(blob)
    if args.output:
        with open(args.output, "w") as f:
            f.write(blob + "\n")
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
