#!/bin/bash
# Controlled intervention on the latent family's online gap.  Diagnosis
# (results/RESULTS.md §7): the encode->latent-step->decode round trip UNDERFITS in the low-data online
# regime (open-loop MSE ~100x the AutoReg flagship's).  The single most
# plausible lever is therefore the per-retrain optimization budget: the
# flagship config gives every family 50-250 steps with patience 5 per
# retrain (tuned for the AutoReg residual model, which only has to learn
# deltas).  This A/B triples the latent family's online budget
# (max_steps 250 -> 750, patience 5 -> 10) and leaves EVERYTHING else at
# the flagship configuration, so the comparison against
# results/ks50k_latent isolates "more fitting in the low-data regime".
# Reference: /root/reference/pdecontrol/architectures/latent.py:10-67.
set -e
cd "$(dirname "$0")/.."
exec bash runscripts/mbpo_ks.sh \
    --factory KSLatentConvolutionalLSTM \
    --trainer '{"initial": {"min_steps": 250, "max_steps": 2000}, "iterations": {"min_steps": 50, "max_steps": 750}}' \
    --training '{"tau": 5, "initial": {"tbtt": 10, "patience": 10, "batch_size": 64}, "iterations": {"tbtt": 10, "patience": 10, "batch_size": 64}}' \
    --run_dir runs/ks50k_latent_r4 "$@"
