#!/bin/bash
# Offline surrogate data-budget sweep (reference runscripts/offline.sh).
#
# Deviation from the reference protocol, on purpose: the training window is
# a CONSTANT target_length (the evaluate CLI default) instead of the
# reference's 25->50 epoch-growing curriculum — every distinct window
# length is a fresh XLA compile, so the constant window trains the whole
# sweep on ONE compiled program.  Pass --curriculum to restore the growing
# schedule.
set -e
cd "$(dirname "$0")/.."

ENV="KuramotoSivashinskyEnv-v0"
DATA="${DATA:-ks_attractor.npz}"
SPLITS=5
TOTALS=( 0.9 0.8 0.6 0.5 0.3 0.2 )
TARGET=30
FACTORY="KSAutoRegConvolutionalLSTM"
TRAINING='{"tbtt": 1000000, "tau": 10, "batch_size": 64, "patience": 50}'
TRAINER='{"max_epochs": 250, "gradient_clip_val": 0.5}'

[ -f "$DATA" ] || python -m pdecontrol_tpu.evaluation.generate \
    --env $ENV --episodes 100 --output "$DATA"

for total in "${TOTALS[@]}"; do
    python -m pdecontrol_tpu.evaluation.evaluate \
        --env_id $ENV --data "$DATA" --splits $SPLITS --total $total \
        --target_length $TARGET --factory $FACTORY \
        --training "$TRAINING" --trainer "$TRAINER" \
        --output "offline_eval_total${total}" "$@"
done
