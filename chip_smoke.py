#!/usr/bin/env python3
"""Smoke test of the main path on NVIDIA GPUs.

    python chip_smoke.py            # one GPU: device, solver, surrogate, MBPO
    python chip_smoke.py --gpus 4   # only the 2 x 2 mesh: vs 1 x 1, then MBPO

Run from the repository root.  Every phase runs in this one process and
prints one line with its measured errors beside their tolerances; a failed
check or phase exits non-zero.  On success the last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Off a GPU (e.g. ``JAX_PLATFORMS=cpu``) the script fails at the device check.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

# Relative-L2 tolerances, each with its reason.
# fp32 control period (250 RK4 sub-steps, HIGHEST products): the GPU and the
# CPU run the same operations and differ only in summation order, 2.5e-7
# after one period on an H100.
TOL_SOLVER = 2e-6
# fp32 rounding itself, against float64: 1.9e-5 after five periods, the same
# from the GPU and from the CPU.
TOL_GOLDEN = 5e-5
GOLDEN_ROWS, GOLDEN_PERIODS = 64, 5
# The surrogate's convolutions run at XLA's default GPU precision, TF32,
# through a 15-step recurrent rollout.  Errors against fp32 HIGHEST (forward,
# loss, gradients): 2.5e-4, 5.7e-7, 5.3e-4 on an H100; one pass with
# operands rounded to bf16, products in fp32, gives 4.5e-3, 2.6e-6, 6.1e-3
# there.  Each limit lies between the two.  The scalar loss separates them
# least: its rounding errors largely cancel.
TOL_SURROGATE_OUT = 2e-3
TOL_SURROGATE_LOSS = 1.5e-6
TOL_SURROGATE_GRAD = 4e-3
# Mesh vs 1 x 1: the same seeds; the collect is row-independent, the fit's
# gradient sums are reduced in another order over the data axis.
TOL_MESH_REPLAY = 1e-5
TOL_MESH_LOSS = 2e-2

# runscripts/mbpo_ks.sh at its full widths; only the run's length is cut
# (mbpo_length) and the surrogate fits are capped (MBPO_FIT_CAPS).
MBPO_FLAGSHIP = [
    "--env_id", "KuramotoSivashinskyEnv-v0",
    "--factory", "KSAutoRegConvolutionalLSTM",
    "--training", json.dumps({
        "tau": 5,
        "initial": {"tbtt": 10, "patience": 10, "batch_size": 64},
        "iterations": {"tbtt": 10, "patience": 5, "batch_size": 64}}),
    "--curriculum", json.dumps({
        "scheduler": "LinearScheduler", "steptype": "iteration", "start": 0,
        "stop": 10, "vmin": 15, "vmax": 15}),
    "--loss", "MSELoss",
    "--rollout_length_schedule", json.dumps({
        "scheduler": "LinearScheduler", "steptype": "iteration", "start": 0,
        "stop": 200, "vmin": 3, "vmax": 7}),
    "--policy_train_steps_per_sample", "10",
    "--num_envs", "10",
    "--model_rollouts_per_sample", "100",
    "--model_rollouts_batch_size", "100",
    "--num_dynamics_models", "3",
    "--policy_batch_size", "256",
    "--hidden_size", "256",
    "--checkpoint_freq", "200",
    "--seed", "0",
    "--offline",
]

MBPO_FIT_CAPS = [
    "--trainer", json.dumps({
        "initial": {"min_steps": 20, "max_steps": 60},
        "iterations": {"min_steps": 10, "max_steps": 30}}),
]
LOSS_KEYS = ("train_loss", "val_loss", "sac_qf_loss", "sac_policy_loss")
RETURN_KEYS = ("eval_return_mean", "collect_reward_mean",
               "imagined_reward_mean", "world_return_mean")


def mbpo_length(dp: int = 1) -> list:
    """500 warmup env steps, then 25 iterations of ``10 * dp`` env steps
    (one per env): fits at iterations 0, 10, 20, evaluations at 0, 10, 20,
    the rest fused.  The step counts scale with the data-parallel width, so
    a mesh window has the one-card window's iterations."""
    return [
        "--learning_starts", "500",
        "--total_timesteps", str(500 + 250 * dp),
        "--surrogate_train_freq", str(100 * dp),
        "--agent_eval_freq", "10",
    ]


class Failed(Exception):
    pass


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def rel_l2(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check(phase: str, errors: dict) -> None:
    """Print ``phase: name=err (tol t) ...`` and fail on any err > tol."""
    parts = [f"{k}={v:.3e} (tol {t:g})" for k, (v, t) in errors.items()]
    say(f"{phase}: " + ", ".join(parts))
    bad = [k for k, (v, t) in errors.items() if not v <= t]
    if bad:
        raise Failed(f"{phase}: {', '.join(bad)} above tolerance")


def smooth_fields(rng, batch: int, n: int):
    """Random smooth periodic fields (wavenumbers 1-5), like states on the
    KS attractor."""
    import numpy as np

    x = 2 * np.pi * np.arange(n) / n
    k = np.arange(1, 6)[:, None]
    a = rng.normal(size=(batch, 5, 1))
    b = rng.normal(size=(batch, 5, 1))
    return 0.5 * (a * np.cos(k * x) + b * np.sin(k * x)).sum(axis=1)


# ------------------------------------------------------------------ phases
def device_phase(gpus: int) -> dict:
    try:
        from pdecontrol_tpu.utils import runtime
    except ImportError as e:
        raise Failed(f"run from the repository root ({e})")
    import jax
    import jaxlib

    # The comparisons need the CPU backend beside the GPU.
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")
    cache = runtime.enable_compile_cache()
    info = runtime.device_info()
    if info["platform"] != "gpu":
        raise Failed(f"no GPU found: JAX's devices are {jax.devices()}")
    if info["count"] < gpus:
        raise Failed(f"--gpus {gpus} needs {gpus} GPUs, JAX sees "
                     f"{info['count']}")
    say(f"gpu: {runtime.gpu_name_and_power_limit()}")
    say(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}; jax {jax.__version__}, jaxlib "
        f"{jaxlib.__version__}; compile cache {cache}")
    return info


def _env_run(env, u, a, device, periods: int = 1):
    """``periods`` jitted env steps on ``device``; returns (u, rewards)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pdecontrol_tpu.envs.kuramoto import EnvState

    state = EnvState(u=jnp.asarray(u, env.dtype),
                     step=jnp.zeros(u.shape[0], jnp.int32),
                     key=jax.random.PRNGKey(0))
    state, action = jax.device_put((state, jnp.asarray(a, env.dtype)),
                                   device)
    step = jax.jit(env.step)
    rewards = []
    for _ in range(periods):
        state, out = step(state, action)
        rewards.append(out.reward)
    rewards = np.stack([np.asarray(r) for r in rewards])
    return np.asarray(state.u), rewards


def solver_phase(gpu, cpu, batch: int = 16384, golden_rows: int = GOLDEN_ROWS,
                 golden_periods: int = GOLDEN_PERIODS) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pdecontrol_tpu.envs.burgers import Burgers
    from pdecontrol_tpu.envs.kuramoto import KuramotoSivashinsky

    rng = np.random.default_rng(0)
    env = KuramotoSivashinsky.create(dtype=jnp.float32)
    u0 = smooth_fields(rng, batch, env.n)
    a = rng.uniform(-1, 1, (batch, 1, env.num_jets))

    t0 = time.perf_counter()
    u_gpu, r_gpu = _env_run(env, u0, a, gpu)
    t_first = time.perf_counter() - t0
    u_cpu, r_cpu = _env_run(env, u0, a, cpu)
    if not (np.isfinite(u_gpu).all() and np.isfinite(r_gpu).all()):
        raise Failed("KS step on the GPU produced non-finite values")
    if u_gpu.shape != (batch, env.n) or r_gpu.shape != (1, batch):
        raise Failed(f"KS step shapes {u_gpu.shape}, {r_gpu.shape}")

    rows = slice(0, golden_rows)
    u_g, r_g = _env_run(env, u0[rows], a[rows], gpu, golden_periods)
    with jax.enable_x64(True):
        env64 = KuramotoSivashinsky.create(dtype=jnp.float64)
        u_64, r_64 = _env_run(env64, u0[rows], a[rows], cpu, golden_periods)

    burgers = Burgers.create(dtype=jnp.float32)
    ub0 = smooth_fields(rng, batch, burgers.n)
    ab = rng.uniform(-1, 1, (batch, 1, burgers.num_jets))
    ub_gpu, rb_gpu = _env_run(burgers, ub0, ab, gpu)
    ub_cpu, rb_cpu = _env_run(burgers, ub0, ab, cpu)

    say(f"solver: KS env.step B={batch} first call (compile + 1 period) "
        f"{t_first:.2f} s")
    check(f"solver (KS B={batch} GPU vs CPU fp32, 1 period; "
          f"{golden_rows} rows vs float64 CPU, {golden_periods} periods; "
          f"Burgers B={batch} GPU vs CPU fp32)", {
              "ks_u": (rel_l2(u_gpu, u_cpu), TOL_SOLVER),
              "ks_reward": (rel_l2(r_gpu, r_cpu), TOL_SOLVER),
              "golden_u": (rel_l2(u_g, u_64), TOL_GOLDEN),
              "golden_reward": (rel_l2(r_g, r_64), TOL_GOLDEN),
              "burgers_u": (rel_l2(ub_gpu, ub_cpu), TOL_SOLVER),
              "burgers_reward": (rel_l2(rb_gpu, rb_cpu), TOL_SOLVER),
          })


def surrogate_phase(gpu, cpu, batch: int = 64, length: int = 15,
                    n: int = 64) -> None:
    """Flagship conv-LSTM forward pass and one TBPTT step, GPU vs CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pdecontrol_tpu.envs.transforms import Identity
    from pdecontrol_tpu.models import factories
    from pdecontrol_tpu.train.losses import mse_loss
    from pdecontrol_tpu.train.trainer import SurrogateTrainer, TrainConfig

    rng = np.random.default_rng(1)
    model = factories.make("KSAutoRegConvolutionalLSTM", delta=0.25, N=n)
    trainer = SurrogateTrainer(model, mse_loss, TrainConfig(
        tau=5, tbtt=10, batch_size=batch))
    states = jnp.asarray(smooth_fields(rng, batch * length, n).reshape(
        batch, length, 1, n), jnp.float32)
    actions = jnp.asarray(rng.uniform(-1, 1, (batch, length, 1, n)),
                          jnp.float32)
    tstate = trainer.init(jax.random.PRNGKey(0), states[:, :5], actions)

    def forward(params, s, a):
        return model.apply({"params": params}, s[:, :5], a).outputs

    def loss(params, s, a):
        return jnp.mean(trainer._losses(params, s, a, Identity())[0])

    def run(device):
        args = jax.device_put((tstate.params, states, actions), device)
        out = jax.jit(forward)(*args)
        value, grads = jax.jit(jax.value_and_grad(loss))(*args)
        return jax.device_get((out, value, grads))

    out_g, loss_g, grads_g = run(gpu)
    with jax.default_matmul_precision("highest"):
        out_c, loss_c, grads_c = run(cpu)

    step = jax.jit(lambda st, s, a: trainer.train_step(
        st, s, a, Identity(), jnp.asarray(1e-3)))
    new, metrics = step(*jax.device_put((tstate, states, actions), gpu))
    leaves = jax.tree.leaves(jax.device_get(new.params))
    if not (all(np.isfinite(x).all() for x in leaves)
            and np.isfinite(float(metrics["train_loss"]))):
        raise Failed("TBPTT step on the GPU produced non-finite values")
    flat = lambda t: np.concatenate(  # noqa: E731
        [np.ravel(x) for x in jax.tree.leaves(t)])
    check(f"surrogate (conv-LSTM B={batch} T={length}, GPU TF32 vs CPU "
          "fp32 HIGHEST; TBPTT tau=5 tbtt=10)", {
              "forward": (rel_l2(out_g, out_c), TOL_SURROGATE_OUT),
              "tbptt_loss": (rel_l2(loss_g, loss_c), TOL_SURROGATE_LOSS),
              "tbptt_grads": (rel_l2(flat(grads_g), flat(grads_c)),
                              TOL_SURROGATE_GRAD),
          })


def _finite(rec: dict, keys) -> bool:
    vals = [rec[k] for k in keys if k in rec]
    return all(math.isfinite(float(v)) for v in vals)


def mbpo_phase(run_dir: str, extra=(), name: str = "mbpo") -> None:
    """The flagship MBPO loop through its CLI entry point, cut in length;
    ``extra`` flags override the flagship's (argparse keeps the last)."""
    from pdecontrol_tpu.mbrl import script

    argv = (MBPO_FLAGSHIP + mbpo_length() + MBPO_FIT_CAPS
            + ["--run_dir", run_dir] + list(extra))
    t0 = time.perf_counter()
    rc = script.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise Failed(f"{name}: mbrl.script.main returned {rc}")
    path = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(path):
        raise Failed(f"{name}: metrics.jsonl was not written")
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    counts = {
        "warmup": sum("t_warmup_collect" in r for r in recs),
        "fits": sum("val_loss" in r for r in recs),
        "fused": sum("t_dispatch" in r for r in recs),
        "evals": sum("eval_return_mean" in r for r in recs),
    }
    need = {"warmup": 1, "fits": 2, "fused": 10, "evals": 1}
    short = [k for k in need if counts[k] < need[k]]
    finite = all(_finite(r, LOSS_KEYS + RETURN_KEYS) for r in recs)
    evals = [r["eval_return_mean"] for r in recs if "eval_return_mean" in r]
    say(f"{name}: rc=0 in {wall:.1f} s; {len(recs)} records; warmup "
        f"{counts['warmup']}, fits {counts['fits']} (need >= 2), fused "
        f"iterations {counts['fused']} (need >= 10), evaluations "
        f"{counts['evals']}; losses and returns finite: {finite}; last "
        f"eval return {evals[-1] if evals else float('nan'):.4f}")
    if short or not finite:
        raise Failed(f"{name}: missing {short} or non-finite values")


def mesh_phase(tmp: str, extra=()) -> None:
    """The (data, model) = (2, 2) mesh on the flagship scaled as in
    runscripts/mbpo_ks_mesh.sh: first its first collect's replay and initial
    fit's losses against a 1 x 1 mesh of the same configuration, then the
    short MBPO window through the CLI entry point."""
    import jax
    import numpy as np

    from pdecontrol_tpu.mbrl import script
    from pdecontrol_tpu.mbrl.controller import PDEModelBasedController

    dp, mp = 2, 2
    scaled = [
        "--num_envs", str(10 * dp),
        "--num_dynamics_models", str(3 * mp),
        "--num_elite_models", str(3 * mp),
        "--model_rollouts_batch_size", str(100 * dp),
        "--policy_batch_size", str(256 * dp),
    ]
    results = {}
    for mesh in ((1, 1), (dp, mp)):
        argv = (MBPO_FLAGSHIP + MBPO_FIT_CAPS + scaled
                + ["--learning_starts", "500", "--logging_freq", "0"]
                + list(extra)
                + ["--data_parallel", str(mesh[0]),
                   "--model_parallel", str(mesh[1]),
                   "--run_dir", os.path.join(tmp, f"mesh{mesh}")])
        cfg = script.config_from_args(script.build_parser().parse_args(argv))
        ctl = PDEModelBasedController(cfg)
        t0 = time.perf_counter()
        ctl.collect(max(cfg.learning_starts // cfg.num_envs, 1), random=True)
        replay = np.asarray(jax.device_get(ctl.replay.obs_seq))
        ctl.update_delta_transform()
        logs = ctl.update_surrogates()
        results[mesh] = (replay, np.asarray(logs["elite_scores"]),
                         float(logs["train_loss"]),
                         time.perf_counter() - t0)
        ctl.logger.finish()
    (r1, s1, l1, t1), (r4, s4, l4, t4) = results[(1, 1)], results[(dp, mp)]
    say(f"mesh: collect + initial fit {t1:.1f} s at 1x1, {t4:.1f} s at "
        f"{dp}x{mp}")
    check(f"mesh ({dp}x{mp} vs 1x1: first collect's replay, initial fit's "
          "losses)", {
              "replay": (rel_l2(r4, r1), TOL_MESH_REPLAY),
              "val_losses": (rel_l2(s4, s1), TOL_MESH_LOSS),
              "train_loss": (rel_l2(l4, l1), TOL_MESH_LOSS),
          })
    mbpo_phase(os.path.join(tmp, "mesh_mbpo"),
               scaled + mbpo_length(dp) + list(extra)
               + ["--data_parallel", str(dp), "--model_parallel", str(mp)],
               name=f"mesh mbpo {dp}x{mp}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--gpus", type=int, choices=(1, 4), default=1,
                   help="4: run only the 2x2 mesh path and its comparison")
    args = p.parse_args(argv)
    try:
        info = device_phase(args.gpus)
        import jax

        gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            if args.gpus == 4:
                mesh_phase(tmp)
            else:
                solver_phase(gpu, cpu)
                surrogate_phase(gpu, cpu)
                mbpo_phase(os.path.join(tmp, "mbpo"))
    except Failed as e:
        print(f"[smoke] FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
