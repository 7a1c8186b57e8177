"""Checks that need a CUDA GPU (marker ``gpu``; they skip elsewhere).

Run on a machine with a GPU:
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py -m gpu``.
``chip_smoke.py`` runs the same comparisons at full size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pdecontrol_tpu.envs.kuramoto import EnvState, KuramotoSivashinsky
from pdecontrol_tpu.models import factories

pytestmark = pytest.mark.gpu


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_ks_step_on_gpu_matches_float64_cpu(gpu):
    """One fp32 control period on the GPU (HIGHEST-precision products)
    against the float64 CPU solver from the same state."""
    cpu = jax.devices("cpu")[0]
    env32 = KuramotoSivashinsky.create(dtype=jnp.float32)
    env64 = KuramotoSivashinsky.create(dtype=jnp.float64)
    u = np.random.default_rng(0).uniform(-1, 1, (64, env32.n))
    a = np.random.default_rng(1).uniform(-1, 1, (64, 1, env32.num_jets))

    def step(env, dtype, device):
        state = EnvState(u=jnp.asarray(u, dtype), step=jnp.zeros(64, jnp.int32),
                         key=jax.random.PRNGKey(0))
        state, action = jax.device_put((state, jnp.asarray(a, dtype)), device)
        return jax.jit(env.step)(state, action)[1]

    out_gpu = step(env32, jnp.float32, gpu)
    out_ref = step(env64, jnp.float64, cpu)
    assert _rel_l2(out_gpu.obs, out_ref.obs) < 1e-5
    assert _rel_l2(out_gpu.reward, out_ref.reward) < 1e-5


def test_surrogate_forward_on_gpu_matches_cpu(gpu):
    """Flagship conv-LSTM rollout on the GPU (TF32 convolutions at XLA's
    default precision) against the CPU at HIGHEST."""
    cpu = jax.devices("cpu")[0]
    model = factories.make("KSAutoRegConvolutionalLSTM", delta=0.25)
    key = jax.random.PRNGKey(0)
    states = jax.random.normal(key, (64, 5, 1, 64), jnp.float32)
    actions = jax.random.uniform(key, (64, 15, 1, 64), jnp.float32, -1, 1)
    params = model.init(key, states, actions)
    fn = jax.jit(lambda p, s, a: model.apply(p, s, a).outputs)
    out_gpu = fn(*jax.device_put((params, states, actions), gpu))
    with jax.default_matmul_precision("highest"):
        out_cpu = fn(*jax.device_put((params, states, actions), cpu))
    assert np.all(np.isfinite(np.asarray(out_gpu)))
    assert _rel_l2(out_gpu, out_cpu) < 2e-2
