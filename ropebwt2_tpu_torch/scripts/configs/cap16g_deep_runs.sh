#!/bin/bash
# 16.9 Gsym deep-coverage capacity build on the run-length tier (no md5)
cd "$(dirname "$0")/../../.." || exit 1
export SCALE_NREADS=167772160 SCALE_L=101 SCALE_MBATCH=$((1<<19)) SCALE_SO=1 SCALE_MD5=0
export SCALE_DATA=coverage SCALE_COV=300 SCALE_ERR=0.001 SCALE_SEED=888
export ROPEBWT2_TPU_RUNS=1 ROPEBWT2_TPU_RUNS_MARGIN=0.3
SCALE_JSON=smoke_out/cap16g_deep_runs.json timeout 12000 stdbuf -oL -eL python -m ropebwt2_tpu_torch.scripts.scale_run 2>&1 | grep -vi warning
