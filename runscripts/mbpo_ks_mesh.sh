#!/bin/bash
# ECC'24 MBRL experiment on several GPUs of one host (e.g. 4 x H100 as a
# 2 x 2 mesh: DATA_PARALLEL=2 MODEL_PARALLEL=2): the (data, model)
# mesh is a controller property — env collection, imagined rollouts and SAC
# batches shard over the `data` axis; ensemble-member training shards over
# `model` (shard_map; see parallel/sharded.py).  A 1x1 mesh reproduces the
# single-device run bit-for-bit, so this script only differs from mbpo_ks.sh
# in the mesh size and the (correspondingly scaled) batch knobs.
#
# Requirements: num_envs, model_rollouts_batch_size and policy_batch_size
# divisible by data_parallel; num_dynamics_models by model_parallel.
set -e
cd "$(dirname "$0")/.."

DATA_PARALLEL="${DATA_PARALLEL:-2}"
MODEL_PARALLEL="${MODEL_PARALLEL:-2}"

python -m pdecontrol_tpu.mbrl.script \
    --env_id KuramotoSivashinskyEnv-v0 \
    --factory KSAutoRegConvolutionalLSTM \
    --data_parallel "$DATA_PARALLEL" \
    --model_parallel "$MODEL_PARALLEL" \
    --num_envs $((10 * DATA_PARALLEL)) \
    --num_dynamics_models $((3 * MODEL_PARALLEL)) \
    --num_elite_models $((3 * MODEL_PARALLEL)) \
    --model_rollouts_batch_size $((100 * DATA_PARALLEL)) \
    --policy_batch_size $((256 * DATA_PARALLEL)) \
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
    --run_dir runs/ks50k_mesh "$@"
