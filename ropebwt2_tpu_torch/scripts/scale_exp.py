"""Gsym-scale sustained-throughput experiment of the port (no md5;
counterpart of scripts/scale_exp.py): prefill a coverage index, then time
steady batches, for sweeping M, the tier and the pending depth without
paying for a full record run each time.

    python -m ropebwt2_tpu_torch.scripts.scale_exp

Env: EXP_M (2^20), EXP_PREFILL (8), EXP_TIMED (2), EXP_L (101), EXP_K
(128), EXP_COV (47), EXP_ERR (0.01), and the index-tier variables
ROPEBWT2_TPU_PACK4 / _RUNS / _RUNS_MARGIN / _RUNS_RCAP / _DEFER_R that
cli.engine_options maps.  The reads come from ReadGen(seed=99); each batch
is drawn before its timed window.  Prints per-batch walls (host clock
around insert_multi, closed by a device synchronisation and counts()) and
a RESULT line.
"""

import json
import os
import time

from .common import (
    device_label, launch_counts, launches_since, power_limit,
)
from .readgen import ReadGen
from .scale_run import insert_batch
from ..cli import engine_options
from ..engine.bcr import TorchBwt
from ..index.flat import resolve_device


def main(device=None):
    """The experiment; returns its result."""
    env = os.environ.get
    M = int(env("EXP_M", 1 << 20))
    L = int(env("EXP_L", 101))
    prefill = int(env("EXP_PREFILL", 8))
    timed = int(env("EXP_TIMED", 2))
    dev = resolve_device(device, "scale_exp")
    nb = prefill + timed
    syms = M * (L + 1)
    print(f"[exp] {device_label(dev)} M={M} prefill={prefill} timed={timed} "
          f"total={nb * syms / 1e9:.3f}G "
          f"PACK4={env('ROPEBWT2_TPU_PACK4', 'auto')} "
          f"RUNS={env('ROPEBWT2_TPU_RUNS', '0')} "
          f"R={env('ROPEBWT2_TPU_DEFER_R', '-1')}", flush=True)
    gen = ReadGen(seed=99, nreads=M * nb, L=L, mode="coverage",
                  cov=float(env("EXP_COV", 47.0)),
                  err=float(env("EXP_ERR", 0.01)))
    eng = TorchBwt(so=1, K=int(env("EXP_K", 128)), device=dev,
                   **engine_options())
    eng.plan(nb * syms)
    print(f"[exp] capacity {eng.state.cap / 1e9:.3f}G "
          f"tier={type(eng.state).__name__}", flush=True)
    t0 = time.perf_counter()
    for i in range(prefill):
        wall, _ = insert_batch(eng, gen.batch(M).view("int8"), i * M, L)
        print(f"[exp] prefill {i}: {wall:.2f}s", flush=True)
    print(f"[exp] prefill total {time.perf_counter() - t0:.1f}s", flush=True)
    walls = []
    launches0 = launch_counts()
    for i in range(timed):
        wall, _ = insert_batch(eng, gen.batch(M).view("int8"),
                               (prefill + i) * M, L)
        walls.append(wall)
        print(f"[exp] timed {i}: {wall:.2f}s ({syms / wall / 1e6:.2f} "
              "Msym/s)", flush=True)
    out = {
        "M": M, "prefill_sym": prefill * syms,
        "steady_sym_s": round(syms / min(walls), 1) if walls else None,
        "walls": [round(w, 2) for w in walls],
        "pack4": env("ROPEBWT2_TPU_PACK4", "auto"),
        "runs": env("ROPEBWT2_TPU_RUNS", "0"),
        "defer": env("ROPEBWT2_TPU_DEFER_R", "-1"),
        "device": device_label(dev),
        "power_limit": power_limit(dev),
        "launches": launches_since(launches0),
    }
    print("[exp] RESULT " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
