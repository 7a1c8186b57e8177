#!/bin/bash
# ECC'24 MBRL experiment (reference README.md:33-46 configuration).
# The compile cache goes to JAX_COMPILATION_CACHE_DIR if set, else to
# .jax_cache/ in the checkout (pdecontrol_tpu/utils/runtime.py).
set -e
cd "$(dirname "$0")/.."

python -m pdecontrol_tpu.mbrl.script \
    --env_id KuramotoSivashinskyEnv-v0 \
    --factory KSAutoRegConvolutionalLSTM \
    --training '{"tau": 5, "initial": {"tbtt": 10, "patience": 10, "batch_size": 64}, "iterations": {"tbtt": 10, "patience": 5, "batch_size": 64}}' \
    --trainer '{"initial": {"min_steps": 250, "max_steps": 2000}, "iterations": {"min_steps": 50, "max_steps": 250}}' \
    --curriculum '{"scheduler": "LinearScheduler", "steptype": "iteration", "start": 0, "stop": 10, "vmin": 15, "vmax": 15}' \
    --loss MSELoss \
    --learning_starts 5000 \
    --total_timesteps 50000 \
    --rollout_length_schedule '{"scheduler": "LinearScheduler", "steptype": "iteration", "start": 0, "stop": 200, "vmin": 3, "vmax": 7}' \
    --policy_train_steps_per_sample 10 \
    --surrogate_train_freq 500 \
    --checkpoint_freq 200 \
    --run_dir runs/ks50k "$@"
