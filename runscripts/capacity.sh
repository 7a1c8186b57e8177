#!/bin/bash
# Model-capacity sweep (reference runscripts/capacity.sh analogue).
set -e
cd "$(dirname "$0")/.."

ENV="KuramotoSivashinskyEnv-v0"
DATA="${DATA:-ks_attractor.npz}"
FACTORIES=( KSAutoRegConvolutionalLSTM KSAutoRegFullyConnectedLSTM KSLatentConvolutionalLSTM KSLatentLSTM KSDelayCNNSurrogateFactory )
TRAINING='{"tbtt": 1000000, "tau": 10, "batch_size": 64, "patience": 50}'
TRAINER='{"max_epochs": 150, "gradient_clip_val": 0.5}'

[ -f "$DATA" ] || python -m pdecontrol_tpu.evaluation.generate \
    --env $ENV --episodes 100 --output "$DATA"

for f in "${FACTORIES[@]}"; do
    python -m pdecontrol_tpu.evaluation.evaluate \
        --env_id $ENV --data "$DATA" --splits 5 --total 0.5 \
        --target_length 30 --factory "$f" \
        --training "$TRAINING" --trainer "$TRAINER" \
        --output "capacity_${f}" "$@"
done
