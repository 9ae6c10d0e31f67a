#!/bin/bash
# 8.56 Gsym deep-coverage build on the run-length tier, with the BWT's md5
cd "$(dirname "$0")/../../.." || exit 1
export SCALE_NREADS=83886080 SCALE_L=101 SCALE_MBATCH=$((1<<19)) SCALE_SO=1 SCALE_MD5=1
export SCALE_DATA=coverage SCALE_COV=150 SCALE_ERR=0.003 SCALE_SEED=777
export ROPEBWT2_TPU_RUNS=1 ROPEBWT2_TPU_RUNS_MARGIN=0.35
SCALE_JSON=smoke_out/scale8g_deep_runs.json timeout 10000 stdbuf -oL -eL python -m ropebwt2_tpu_torch.scripts.scale_run 2>&1 | grep -vi warning
