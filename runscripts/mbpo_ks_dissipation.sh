#!/bin/bash
# The paper's dissipation+power objective through the FULL online loop.
# The reference's objective quirk (kuramoto.py:72) makes the dissipation
# integrand reachable only via objective="" — preserved here (envs/kuramoto.py legacy_objective).  Everything else is
# the flagship ECC'24 configuration (mbpo_ks.sh).
#
# Model-free comparison arm:
#   python -m pdecontrol_tpu.sac.train --env_config '{"objective": ""}' \
#       --total_timesteps 50000 --learning_starts 5000 \
#       --run_dir runs/sac50k_dissipation
set -e
cd "$(dirname "$0")/.."
exec bash runscripts/mbpo_ks.sh \
    --env_config '{"objective": ""}' \
    --run_dir runs/ks50k_dissipation "$@"
