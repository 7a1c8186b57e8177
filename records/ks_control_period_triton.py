"""RECORD of a rejected design: a fused KS control-period kernel for NVIDIA
GPUs (Pallas through Triton).  Nothing imports this file.  It is kept so
that the next attempt at a solver kernel can see what was tried and why it
lost; PERF.md (Findings, PR 1) holds the table its ``__main__`` printed on
an H100.  The env runs the plain XLA path everywhere.

Operator layout: four ``[N, N]`` fp32 operators (the pre-summed linear part,
the forward and the backward upwind first derivatives, and ``c_xx`` for the
dissipation reward; 64 KB at N = 64), not the two stacked ``[N, 2N]``
central / upwind operators of ``KSOperators``.  Each RHS therefore does three
``[R, N] x [N, N]`` dots (four at RK4's first stage under the dissipation
objective) on the FMA units: Triton runs an IEEE-fp32 ``dot`` without the
tensor cores.

Reproduce on a GPU, from the repository root::

    PYTHONPATH=. python records/ks_control_period_triton.py

The design as it was measured follows.

The plain path (``ops.kuramoto.ks_control_period``) is a ``lax.scan`` over
``cfg_steps`` RK4 sub-steps of four RHS evaluations each: several small
kernels per sub-step, with ``u`` and ``k1..k4`` round-tripping through
device memory in between.  This kernel runs the whole control period in one
launch instead:

  * one program per block of ``R`` env rows (``R`` a power of two, >= 16 for
    ``pl.dot``); the wrapper pads the batch to a multiple of ``R``;
  * the stencil operators (three ``[N, N]`` matrices: the pre-summed linear
    part ``-(c_xx + c_xxxx)`` and the forward / backward upwind first
    derivatives of ``u^2``, plus ``c_xx`` for the dissipation objective) are
    loaded once per program;
  * ``u``, ``phi`` and the reward accumulator stay on chip for the whole
    ``fori_loop`` over sub-steps;
  * products run at ``Precision.HIGHEST`` (IEEE fp32 inputs).  TF32 would
    round the O(1e2-1e3) fourth-derivative coefficients to a 10-bit mantissa,
    an effective-viscosity shift that drains the attractor.

``ks_control_period_fused`` was the product entry point: it lowered to the
Triton kernel on CUDA and to the plain XLA path everywhere else, a choice
made at lowering from the platform (``lax.platform_dependent``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from pdecontrol_tpu.ops import stencils
from pdecontrol_tpu.ops.kuramoto import (
    DISSIPATION,
    L2CONTROL,
    KSOperators,
    ks_control_period,
)

Array = jax.Array

MIN_BLOCK_ROWS = 16  # smallest M that Triton's dot accepts
MAX_BLOCK_ROWS = 32
NUM_WARPS = 4


def block_rows(batch: int, max_rows: int = MAX_BLOCK_ROWS) -> int:
    """Rows per program: the smallest power of two >= ``batch``, clamped to
    ``[MIN_BLOCK_ROWS, max_rows]`` (a small batch runs as one program)."""
    r = MIN_BLOCK_ROWS
    while r < batch and r < max_rows:
        r *= 2
    return r


@functools.lru_cache(maxsize=None)
def kernel_operators(n: int, dx: float) -> Tuple[np.ndarray, ...]:
    """``(lin, up_fwd, up_bwd, c_xx)``, each ``[N, N]`` float32, built from
    the same stencil tables as ``KSOperators.create``.

    ``lin = -(c_xx + c_xxxx)`` is summed in float64 before the cast, so
    ``u @ lin`` equals ``-u_xxxx - u_xx`` of the plain path to fp32 rounding.
    """
    def mat(taps, order):
        return stencils.stacked_matrix([taps], n, [dx ** -order])

    c_xx = mat(stencils.SECOND_DERIV_CENTRAL_6, 2)
    c_xxxx = mat(stencils.FOURTH_DERIV_CENTRAL_6, 4)
    mats = (-(c_xx + c_xxxx), mat(stencils.FIRST_DERIV_UPWIND_FWD, 1),
            mat(stencils.FIRST_DERIV_UPWIND_BWD, 1), c_xx)
    return tuple(m.astype(np.float32) for m in mats)


def _kernel(u_ref, phi_ref, lin_ref, fwd_ref, bwd_ref, cxx_ref,
            u_out_ref, rew_out_ref, *, dt, cfg_steps, objective, inv_n):
    dot = functools.partial(pl.dot, precision=jax.lax.Precision.HIGHEST)
    u = u_ref[...]
    phi = phi_ref[...]
    lin, fwd, bwd = lin_ref[...], fwd_ref[...], bwd_ref[...]

    def rhs(u):
        u2 = u * u
        u_x = jnp.where(u < 0, dot(u2, fwd), dot(u2, bwd))
        return dot(u, lin) - 0.5 * u_x + phi, u_x

    def body(_, carry):
        u, acc = carry
        k1, u_x = rhs(u)
        if objective == L2CONTROL:
            r = -jnp.sum(u * u, axis=1) * inv_n
        else:
            u_xx = dot(u, cxx_ref[...])
            r = -(jnp.sum(u_xx * u_xx, axis=1) + jnp.sum(u_x * u_x, axis=1)
                  + jnp.sum(u * phi, axis=1)) * inv_n
        k2, _ = rhs(u + dt * k1 / 2.0)
        k3, _ = rhs(u + dt * k2 / 2.0)
        k4, _ = rhs(u + dt * k3)
        u = u + dt * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
        return u, acc + r

    acc0 = jnp.zeros((u.shape[0],), jnp.float32)
    u, acc = jax.lax.fori_loop(0, cfg_steps, body, (u, acc0))
    u_out_ref[...] = u
    rew_out_ref[...] = acc / cfg_steps


@functools.partial(
    jax.jit,
    static_argnames=("dt", "cfg_steps", "objective", "rows", "num_warps",
                     "interpret"),
)
def _call(u, phi, lin, fwd, bwd, cxx, dt, cfg_steps, objective, rows,
          num_warps, interpret):
    b, n = u.shape
    row_block = pl.BlockSpec((rows, n), lambda i: (i, 0))
    op_block = pl.BlockSpec((n, n), lambda i: (0, 0))
    kern = functools.partial(_kernel, dt=dt, cfg_steps=cfg_steps,
                             objective=objective, inv_n=1.0 / n)
    return pl.pallas_call(
        kern,
        grid=(b // rows,),
        in_specs=[row_block, row_block] + [op_block] * 4,
        out_specs=[row_block, pl.BlockSpec((rows,), lambda i: (i,))],
        out_shape=[
            jax.ShapeDtypeStruct((b, n), jnp.float32),
            jax.ShapeDtypeStruct((b,), jnp.float32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="ks_control_period",
    )(u, phi, lin, fwd, bwd, cxx)


def ks_control_period_triton(
    ops: KSOperators,
    u: Array,
    phi: Array,
    dt: float,
    cfg_steps: int,
    objective: str = L2CONTROL,
    max_rows: int = MAX_BLOCK_ROWS,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
) -> Tuple[Array, Array]:
    """Fused equivalent of ``ks_control_period`` for float32 ``[..., N]``
    fields.  Leading batch dims are flattened and padded to a multiple of the
    row block; ``interpret=True`` is for tests on a machine without a GPU."""
    if objective not in (L2CONTROL, DISSIPATION):
        raise ValueError(f"unknown objective {objective!r}")
    n = u.shape[-1]
    batch_shape = u.shape[:-1]
    u2 = u.reshape(-1, n).astype(jnp.float32)
    phi2 = jnp.broadcast_to(phi, u.shape).reshape(-1, n).astype(jnp.float32)
    b = u2.shape[0]
    rows = block_rows(b, max_rows)
    pad = -b % rows
    if pad:
        u2 = jnp.pad(u2, ((0, pad), (0, 0)))
        phi2 = jnp.pad(phi2, ((0, pad), (0, 0)))
    mats = [jnp.asarray(m) for m in kernel_operators(ops.n, ops.dx)]
    u_out, rew = _call(u2, phi2, *mats, dt=dt, cfg_steps=cfg_steps,
                       objective=objective, rows=rows, num_warps=num_warps,
                       interpret=interpret)
    return (u_out[:b].reshape(u.shape).astype(u.dtype),
            rew[:b].reshape(batch_shape).astype(u.dtype))


def ks_control_period_fused(
    ops: KSOperators,
    u: Array,
    phi: Array,
    dt: float,
    cfg_steps: int,
    objective: str = L2CONTROL,
) -> Tuple[Array, Array]:
    """One control period: the Triton kernel on CUDA, the plain path
    elsewhere.  Float64 fields (golden tests) always take the plain path."""
    phi = jnp.broadcast_to(phi, u.shape).astype(u.dtype)

    def plain(u, phi):
        return ks_control_period(ops, u, phi, dt, cfg_steps, objective)

    if u.dtype != jnp.float32:
        return plain(u, phi)

    def kernel(u, phi):
        return ks_control_period_triton(ops, u, phi, dt, cfg_steps, objective)

    return jax.lax.platform_dependent(u, phi, cuda=kernel, default=plain)


def _time_against_plain() -> None:
    """The measurement behind PERF.md's table: a jitted step (action to
    forcing, one control period) with the plain path and with the kernel at
    several row blocks and warp counts; median of 5 runs of ``iters``
    steps."""
    import subprocess
    import time

    from pdecontrol_tpu.envs.kuramoto import EnvState, KuramotoSivashinsky

    def smi():
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()

    print(smi(), jax.devices()[0].device_kind, flush=True)
    env = KuramotoSivashinsky.create(objective=DISSIPATION,
                                     legacy_objective=False)

    def plain_step(state, a):
        u, r = ks_control_period(env.ops, state.u, env.action_to_phi(a),
                                 env.dt, env.cfg_steps,
                                 env.effective_objective)
        return state.replace(u=u, step=state.step + 1), r

    def kernel_step(rows, warps):
        def f(state, a):
            u, r = ks_control_period_triton(
                env.ops, state.u, env.action_to_phi(a), env.dt,
                env.cfg_steps, env.effective_objective, max_rows=rows,
                num_warps=warps)
            return state.replace(u=u, step=state.step + 1), r
        return f

    def timeit(fn, state, a, iters):
        t0 = time.perf_counter()
        s, r = fn(state, a)
        jax.block_until_ready(r)
        compile_s = time.perf_counter() - t0
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            s2 = state
            for _ in range(iters):
                s2, r2 = fn(s2, a)
            jax.block_until_ready((s2.u, r2))
            ts.append((time.perf_counter() - t0) / iters)
        return compile_s, float(np.median(ts)), s, r

    def rel(a, b):
        return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))

    for batch, variants, iters in (
            (16384, [(16, 2), (16, 4), (32, 2), (32, 4), (32, 8), (64, 4),
                     (64, 8), (128, 8)], 10),
            (10, [(16, 1), (16, 2), (16, 4)], 50)):
        key = jax.random.PRNGKey(0)
        u = jax.random.uniform(key, (batch, env.n), minval=-1, maxval=1)
        state = EnvState(u=u, step=jnp.zeros((batch,), jnp.int32), key=key)
        a = jax.random.uniform(jax.random.PRNGKey(1),
                               (batch, 1, env.num_jets), minval=-1, maxval=1)
        c, t, s_ref, r_ref = timeit(jax.jit(plain_step), state, a, iters)
        print(f"B={batch} plain: compile {c:.2f} s, {t * 1e3:.4f} ms/step, "
              f"{batch / t:,.0f} agent-steps/s", flush=True)
        for rows, warps in variants:
            c, t, s_k, r_k = timeit(jax.jit(kernel_step(rows, warps)), state,
                                    a, iters)
            print(f"B={batch} triton R={rows} warps={warps}: compile "
                  f"{c:.2f} s, {t * 1e3:.4f} ms/step, {batch / t:,.0f} "
                  f"agent-steps/s; rel-L2 vs plain u "
                  f"{rel(s_k.u, s_ref.u):.3e}, reward {rel(r_k, r_ref):.3e}",
                  flush=True)
    print(smi(), flush=True)


if __name__ == "__main__":
    _time_against_plain()
