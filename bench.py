"""Benchmark: batched Kuramoto–Sivashinsky env throughput on one GPU.

Prints one JSON line right after the headline measurement and a final JSON
line with every secondary measurement; each line names the device (JAX's
platform, device kind and count, and ``nvidia-smi``'s name and power limit).
Any failure exits non-zero: nothing is skipped or measured on another
device.  Run on the GPU: ``python bench.py``.

value        = agent env-steps/sec through the product env API (jitted
               ``KuramotoSivashinsky.step``; each step = one full control
               period: 250 RK4 sub-steps x 4 RHS evals on N=64 at
               HIGHEST-precision fp32, forcing and reward included), median
               over BENCH_REPEATS measurements at batch BENCH_BATCH.
vs_baseline  = speedup over the reference-equivalent NumPy/SciPy integrator
               measured on this host, scaled by the reference's 10
               env-worker processes (--cpus default, script.py:33), i.e.
               value / (10 x single-process scipy-oracle steps/sec).

Secondary fields: env-steps/sec at the flagship loop's 10 envs, surrogate
TBPTT train-steps/s (single and member-fused x3) with XLA's FLOP count per
step, SAC updates/s, and the single-core native C++ integrator's rate.
"""

import json
import os
import statistics
import sys
import time

import numpy as np

from pdecontrol_tpu.utils import runtime

# Dense peak rates per device kind (NVIDIA H100 data sheet, SXM part, no
# sparsity; they assume the 700 W power limit — the JSON lines carry the
# card's actual limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_fields() -> dict:
    """Device identity for every JSON line; fails off the GPU or on a
    device kind without a peak entry."""
    info = runtime.device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {info}")
    if info["kind"] not in PEAKS:
        raise SystemExit(f"no peak rates for device kind {info['kind']!r}")
    return {"device": info, "gpu": runtime.gpu_name_and_power_limit()}


def bench_env(batch: int, iters: int = 10, repeats: int = 5):
    """Env-steps/sec through jitted ``env.step``, one rate per repeat."""
    import jax
    import jax.numpy as jnp

    from pdecontrol_tpu.envs.kuramoto import EnvState, KuramotoSivashinsky

    ku, ka, ks = jax.random.split(jax.random.PRNGKey(0), 3)
    env = KuramotoSivashinsky.create(dtype=jnp.float32)
    state0 = EnvState(
        u=jax.random.uniform(ku, (batch, env.n), minval=-1.0, maxval=1.0,
                             dtype=jnp.float32),
        step=jnp.zeros((batch,), jnp.int32),
        key=ks,
    )
    action = jax.random.uniform(ka, (batch, 1, env.num_jets), minval=-1.0,
                                maxval=1.0, dtype=jnp.float32)
    step = jax.jit(env.step)
    jax.block_until_ready(step(state0, action)[0].u)  # compile + warm
    rates = []
    for _ in range(repeats):
        state = state0
        t0 = time.perf_counter()
        for _ in range(iters):
            state, _ = step(state, action)
        jax.block_until_ready(state.u)
        rates.append(batch * iters / (time.perf_counter() - t0))
    return rates


def _compiled_flops(compiled) -> float:
    """XLA's FLOP estimate for a compiled program."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca.get("flops", 0.0))


def bench_tbtt(batch: int = 64, length: int = 20, iters: int = 40,
               repeats: int = 3, members: int = 1):
    """Surrogate TBPTT training steps/sec on the flagship conv-LSTM at the
    reference's tau/tbtt (``members > 1``: the member-fused step that
    ``fit_ensemble`` runs).  Returns (train_steps/s, flops_per_step)."""
    import jax
    import jax.numpy as jnp

    from pdecontrol_tpu.envs.transforms import Identity
    from pdecontrol_tpu.models import factories
    from pdecontrol_tpu.train.losses import mse_loss
    from pdecontrol_tpu.train.trainer import SurrogateTrainer, TrainConfig

    model = factories.make("KSAutoRegConvolutionalLSTM", delta=0.25)
    trainer = SurrogateTrainer(model, mse_loss, TrainConfig(tau=5, tbtt=10,
                                                            batch_size=batch))
    key = jax.random.PRNGKey(0)
    states = jax.random.normal(key, (members, batch, length, 1, 64),
                               jnp.float32)
    actions = jax.random.uniform(key, (members, batch, length, 1, 64),
                                 dtype=jnp.float32, minval=-1, maxval=1)
    tstate = jax.vmap(
        lambda k: trainer.init(k, states[0, :, :5], actions[0])
    )(jax.random.split(key, members))

    one = lambda st, s, a: trainer.train_step(  # noqa: E731
        st, s, a, Identity(), jnp.asarray(1e-3))[0]
    fn = jax.jit(jax.vmap(one))
    flops = _compiled_flops(fn.lower(tstate, states, actions).compile())

    tstate = fn(tstate, states, actions)
    jax.block_until_ready(tstate.params)
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            tstate = fn(tstate, states, actions)
        jax.block_until_ready(tstate.params)
        rates.append(iters / (time.perf_counter() - t0))
    return statistics.median(rates), flops


def bench_sac(batch: int = 256, iters: int = 50, chain: int = 100) -> float:
    """Sustained SAC updates/sec at the reference policy batch size
    (script.py:65), in the controller's policy-phase program shape: chained
    updates with on-device transition sampling from the real and imagined
    replays plus the real/imagined mix-select, in one jitted program."""
    import jax
    import jax.numpy as jnp

    from pdecontrol_tpu.data import replay as R
    from pdecontrol_tpu.sac.sac import SAC, SACConfig

    key = jax.random.PRNGKey(0)
    sac = SAC((1, 64), (1, 4), SACConfig())
    state = sac.init(key)

    def filled_replay(k):
        rep = R.create(64, 400, 1, (1, 64), (1, 4))
        return rep.replace(
            obs_seq=jax.random.normal(k, rep.obs_seq.shape, jnp.float32),
            actions=jax.random.uniform(k, rep.actions.shape, jnp.float32,
                                       minval=-1.0, maxval=1.0),
            rewards=jax.random.normal(k, rep.rewards.shape, jnp.float32),
            fill=jnp.full((64,), 400, jnp.int32),
            complete=jnp.ones((64,), bool),
        )

    kr, kw = jax.random.split(key)
    real_rep, world_rep = filled_replay(kr), filled_replay(kw)

    @jax.jit
    def step(state, k):
        def body(carry, _):
            st, k = carry
            k, k1, k2, k3, ku = jax.random.split(k, 5)
            real = R.sample_transitions(real_rep, k1, batch)
            imag = R.sample_transitions(world_rep, k2, batch)
            pick = jax.random.uniform(k3, (batch,)) < 0.5

            def sel(a, b):
                m = pick.reshape((-1,) + (1,) * (a.ndim - 1))
                return jnp.where(m, a, b)

            st, _ = sac.update(st, jax.tree.map(sel, imag, real), ku)
            return (st, k), None

        (state, _), _ = jax.lax.scan(body, (state, k), None, length=chain)
        return state

    state = step(state, key)
    jax.block_until_ready(jax.tree.leaves(state)[0])
    t0 = time.perf_counter()
    for i in range(iters):
        state = step(state, jax.random.fold_in(key, i))
    jax.block_until_ready(jax.tree.leaves(state)[0])
    return iters * chain / (time.perf_counter() - t0)


def bench_oracle(steps: int = 2, repeats: int = 8) -> float:
    """Best-of-``repeats`` rate of the scipy oracle (host load only ever
    slows it, so the max is the least-biased estimate of the
    ``vs_baseline`` denominator)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    from oracles import KSOracle

    oracle = KSOracle()
    rng = np.random.default_rng(0)
    u = rng.uniform(-1, 1, size=64)
    phi = 0.1 * np.sin(2 * np.pi * np.arange(64) / 64)
    oracle.control_period(u, phi)  # warm
    best = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        v = u
        for _ in range(steps):
            v, _ = oracle.control_period(v, phi)
        best = max(best, steps / (time.perf_counter() - t0))
    return best


def bench_native(steps: int = 50) -> float:
    from pdecontrol_tpu.utils import native

    rng = np.random.default_rng(0)
    u = rng.uniform(-1, 1, size=(1, 64))
    phi = np.zeros((1, 64))
    native.ks_control_period(u, phi, 22.0 / 64, 1e-3, 250)  # warm/build
    t0 = time.perf_counter()
    for _ in range(steps):
        u, _ = native.ks_control_period(u, phi, 22.0 / 64, 1e-3, 250)
    return steps / (time.perf_counter() - t0)


def main() -> int:
    runtime.enable_compile_cache()
    dev = device_fields()
    batch = int(os.environ.get("BENCH_BATCH", 16384))
    repeats = int(os.environ.get("BENCH_REPEATS", 5))

    oracle_sps = bench_oracle()
    log = lambda msg: print(f"[bench] {msg}", file=sys.stderr)  # noqa: E731
    log(f"scipy oracle (reference-equivalent, 1 core): {oracle_sps:.2f} "
        "agent_steps/s")

    rates = bench_env(batch, repeats=repeats)
    headline = statistics.median(rates)
    out = {
        "metric": "ks_env_steps_per_sec",
        "value": headline,
        "unit": "agent_steps/s",
        "vs_baseline": headline / (10.0 * oracle_sps),
        "batch": batch,
        "median_of": repeats,
        "spread": max(rates) - min(rates),
        **dev,
    }
    print(json.dumps(out), flush=True)

    flagship = bench_env(10, repeats=repeats)
    out["env_steps_per_sec_b10"] = statistics.median(flagship)
    rate1, flops1 = bench_tbtt(members=1)
    out["tbtt_train_steps_per_sec"] = rate1
    out["tbtt_flops_per_step"] = flops1
    rate3, flops3 = bench_tbtt(members=3)
    out["tbtt_ens3_steps_per_sec"] = rate3
    out["tbtt_ens3_flops_per_step"] = flops3
    out["sac_updates_per_sec"] = bench_sac()
    out["native_cc_agent_steps_per_sec"] = bench_native()
    out["peaks"] = PEAKS[dev["device"]["kind"]]
    log(json.dumps(out))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
