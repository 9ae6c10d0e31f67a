"""Long-read (Moleculo-regime) build of the port on one card (counterpart
of scripts/longread_run.py).

    python -m ropebwt2_tpu_torch.scripts.longread_run

BCR pays one round per symbol column, so long reads mean many rounds over
a small active set, where the per-round fixed cost dominates.  The run
builds the RLO BWT of LR_NREADS reads with lengths uniform in [LR_MIN,
LR_MAX] (default 10-20 kbp) in one ragged batch (rounds = longest read +
1), hashes it in the reference's plain-text encoding, checks that md5
against `ropebwt2 -LRs` on the same reads when LR_REF names a reference
binary that exists, and writes its result to LR_JSON (default
smoke_out/longread_run.json).

Env: LR_NREADS (32768), LR_MIN (10000), LR_MAX (20000), LR_SO (1),
LR_JSON, LR_REF (no check without it), LR_DEFER (defer_r; default auto),
and the index-tier variables that cli.engine_options maps.
"""

import hashlib
import json
import os
import subprocess
import time

import numpy as np

from .common import (
    device_label, launch_counts, launches_since, out_path,
    power_limit, timed_insert,
)
from .scale_run import LUT, text_md5
from ..cli import engine_options
from ..engine import query
from ..engine.bcr import TorchBwt
from ..index.flat import resolve_device


SEED = 4242  # the JAX script's


def draw(nreads, lo, hi):
    """(lengths, reads) of the JAX script's stream: lengths uniform in
    [lo, hi], then each read's uniform ACGT codes in turn."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(lo, hi + 1, size=nreads)
    reads = [rng.integers(1, 5, size=int(ln), dtype=np.uint8).view(np.int8)
             for ln in lens]
    return lens, reads


def build(reads, device, opts, so=1, K=128):
    """One ragged batch into an index planned for it: returns (engine,
    wall s, counts) (common.timed_insert); raises if the counts are not
    the reads'."""
    total = sum(len(r) for r in reads) + len(reads)
    eng = TorchBwt(so=so, K=K, device=device, **opts)
    eng.plan(total)
    wall, cnt = timed_insert(eng, reads)
    if int(cnt[0]) != len(reads) or int(cnt.sum()) != total:
        raise RuntimeError(f"self-check failed: counts {cnt.tolist()}")
    return eng, wall, cnt


def reference_md5(ref, reads, so):
    """md5 of the reference binary's BWT of ``reads`` (`ropebwt2 -LRs`)."""
    lines = bytearray()
    for r in reads:
        lines += LUT[r].tobytes() + b"\n"
    p = subprocess.run([ref, "-LRs" if so == 1 else "-LR", "-"],
                       input=bytes(lines), stdout=subprocess.PIPE,
                       check=True)
    return hashlib.md5(p.stdout).hexdigest()


def main(device=None):
    """The run; returns its result (also written to LR_JSON)."""
    env = os.environ.get
    nreads = int(env("LR_NREADS", 32768))
    lo, hi = int(env("LR_MIN", 10000)), int(env("LR_MAX", 20000))
    so = int(env("LR_SO", 1))
    ref = env("LR_REF")
    out = out_path("LR_JSON", "longread_run.json")
    dev = resolve_device(device, "longread_run")
    opts = engine_options()
    if env("LR_DEFER"):
        opts["defer_r"] = int(env("LR_DEFER"))

    lens, reads = draw(nreads, lo, hi)
    total = int(lens.sum()) + nreads
    rounds = int(lens.max()) + 1
    print(f"[longread] {nreads} reads x [{lo},{hi}] bp = {total / 1e9:.3f} "
          f"Gsym on {device_label(dev)}", flush=True)
    launches0 = launch_counts()
    eng, wall, _ = build(reads, dev, opts, so=so)
    launches = launches_since(launches0)
    print(f"[longread] built in {wall:.1f}s = {total / wall / 1e6:.2f} "
          f"Msym/s ({rounds} rounds)", flush=True)

    got = text_md5(eng)
    want = None
    if ref and os.path.exists(ref):
        t1 = time.perf_counter()
        want = reference_md5(ref, reads, so)
        print(f"[longread] reference wall {time.perf_counter() - t1:.1f}s",
              flush=True)
        if got != want:
            raise RuntimeError(f"md5 {got} != the reference's {want}")
        print("[longread] md5 parity OK", flush=True)

    result = {
        "metric": "longread_build",
        "reads": nreads,
        "len_range": [lo, hi],
        "symbols": total,
        "sorting_order": so,
        "wall_s": round(wall, 1),
        "throughput_sym_s": round(total / wall, 1),
        "rounds": rounds,
        "device": device_label(dev),
        "power_limit": power_limit(dev),
        "bwt_md5": got,
        "md5_matches_reference": (want == got) if want else None,
        "index_tier": query._tier(eng.state),
        "launches": launches,
    }
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print("[longread] RESULT " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
