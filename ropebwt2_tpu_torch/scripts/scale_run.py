"""Gsym-scale run of the port on one card (counterpart of
scripts/scale_run.py).

    python -m ropebwt2_tpu_torch.scripts.scale_run

Builds the BWT of SCALE_NREADS x SCALE_L reads (default 10.4M x 101 bp =
1.06 Gsym with sentinels) in SCALE_MBATCH-read batches, planned once for
the total, printing per-batch wall times and cumulative throughput, and
writes the result JSON to SCALE_JSON (default smoke_out/scale_run.json).

Self-checks: the symbol counts after every batch (sentinels == reads so
far, total == symbols so far), and an FM-query spot check (backward_search
of planted probes must find each at least once).  With SCALE_MD5=1 the BWT
is hashed in the reference's plain-text encoding, one chunk at a time on
its way from the card; compare it with `ropebwt2 -LRs -m10g` on the same
reads (gen_scale_input.py writes them: the same stream).  RLO output is
insertion-order invariant, so batching does not change the hash.  When the
reads' text is an exact multiple of kseq's 16384-byte buffer, the
reference parses one phantom empty read; the run inserts it too.

Env: SCALE_NREADS (10_485_760), SCALE_L (101), SCALE_MBATCH (2^21),
SCALE_SO (1 = RLO), SCALE_JSON, SCALE_MD5=1.  Read-set shape (readgen.py):
SCALE_DATA=uniform|coverage, SCALE_COV (47), SCALE_ERR (0.01), SCALE_SEED
(12345).  Index tier: ROPEBWT2_TPU_RUNS, _RUNS_MARGIN, _RUNS_RCAP, _PACK4
and _DEFER_R, as the CLI maps them (cli.engine_options).
"""

import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import readgen
from .common import (
    device_label, launch_counts, launches_since, out_path,
    power_limit, timed_insert,
)
from ..cli import engine_options
from ..engine import query
from ..engine.bcr import RUN_CHUNK, TorchBwt
from ..index.flat import resolve_device
from ..index.runs import RunBwt

LUT = np.frombuffer(b"$ACGTN", dtype=np.uint8)


def text_md5(src, chunk=RUN_CHUNK):
    """md5 of a BWT in the reference's plain-text encoding ("$ACGTN"
    characters and one trailing newline).  ``src`` is an int8 array or an
    engine, which is hashed ``chunk`` symbols at a time from its device
    (a packed or run-tier index expands one chunk at a time), so no host
    copy of the whole BWT exists."""
    h = hashlib.md5()
    if isinstance(src, np.ndarray):
        pieces = (src[lo: lo + chunk] for lo in range(0, src.shape[0], chunk))
    else:
        src._check_runs()
        pieces = (src._symbols(lo, min(src.n, lo + chunk)).cpu().numpy()
                  for lo in range(0, src.n, chunk))
    for p in pieces:
        h.update(LUT[p].tobytes())
    h.update(b"\n")
    return h.hexdigest()


def batches(gen, nreads, mbatch):
    """Yield (reads int8[m, L], seconds drawing them) for every batch of
    the stream, the next drawn on a host thread while the caller builds
    this one (the stream's order is the generator's)."""
    sizes = [min(mbatch, nreads - d) for d in range(0, nreads, mbatch)]

    def draw(m):
        t0 = time.perf_counter()
        return gen.batch(m).view(np.int8), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(draw, sizes[0]) if sizes else None
        for i in range(len(sizes)):
            cur = nxt.result()
            if i + 1 < len(sizes):
                nxt = pool.submit(draw, sizes[i + 1])
            yield cur


def insert_batch(eng, reads, done, L):
    """Insert one batch into an index that held ``done`` reads of length
    L; returns (wall s, counts) of common.timed_insert, and raises if the
    counts are not the reads' so far."""
    wall, cnt = timed_insert(eng, reads)
    done += len(reads)
    if int(cnt[0]) != done or int(cnt.sum()) != done * (L + 1):
        raise RuntimeError(f"self-check failed after {done} reads: counts "
                           f"{cnt.tolist()}")
    return wall, cnt


def spot_check(eng, gen):
    """Plant 4 probes of 12 symbols drawn from the stream's generator in a
    batch of their own and find each by backward_search; returns their
    occurrence counts, and raises if one is not found."""
    probe = gen.rng.integers(1, 5, size=(4, 12)).astype(np.int8)
    eng.insert_multi(list(probe))
    lo, hi = query.backward_search(
        eng.state, probe.astype(np.int64),
        np.full(probe.shape[0], probe.shape[1], dtype=np.int64))
    found = (hi - lo).cpu().numpy()
    if not (found >= 1).all():
        raise RuntimeError(f"FM spot check failed: occurrences {found}")
    return found.tolist()


def main(device=None):
    """The run; returns its result (also written to SCALE_JSON)."""
    env = os.environ.get
    nreads = int(env("SCALE_NREADS", 10_485_760))
    L = int(env("SCALE_L", 101))
    mbatch = int(env("SCALE_MBATCH", 1 << 21))
    so = int(env("SCALE_SO", 1))
    out = out_path("SCALE_JSON", "scale_run.json")
    dev = resolve_device(device, "scale_run")
    total = nreads * (L + 1)
    print(f"[scale] {nreads} reads x {L} bp = {total / 1e9:.3f} Gsym on "
          f"{device_label(dev)}, batches of {mbatch}", flush=True)

    eng = TorchBwt(so=so, device=dev, **engine_options())
    eng.plan(total)
    print(f"[scale] {type(eng.state).__name__}, capacity "
          f"{eng.state.cap / 1e9:.3f} Gsym", flush=True)
    gen = readgen.from_env(None, nreads, L, mbatch)
    launches0 = launch_counts()
    t0 = time.perf_counter()
    walls, done = [], 0
    for reads, _ in batches(gen, nreads, mbatch):
        wall, cnt = insert_batch(eng, reads, done, L)
        done += len(reads)
        walls.append(wall)
        thr = done * (L + 1) / (time.perf_counter() - t0)
        print(f"[scale] batch {len(walls)}: {len(reads)} reads in "
              f"{wall:.3f}s | n={int(cnt.sum()) / 1e9:.3f} Gsym | cum "
              f"{thr / 1e6:.2f} Msym/s", flush=True)
    wall_total = time.perf_counter() - t0
    launches = launches_since(launches0)

    # parity with `ropebwt2 -L` on the same reads as a text file: when the
    # text is an exact multiple of kseq's 16384-byte buffer, the reference
    # parses one phantom empty read after it
    if total % 16384 == 0:
        eng.insert_multi([np.zeros(0, np.int8)])
        print("[scale] inserted phantom empty read (kseq boundary quirk)",
              flush=True)

    bwt_md5 = None
    if env("SCALE_MD5") == "1":  # before the probe batch changes the index
        tm = time.perf_counter()
        bwt_md5 = text_md5(eng)
        print(f"[scale] bwt md5 {bwt_md5} ({time.perf_counter() - tm:.1f}s "
              "incl. transfer)", flush=True)

    found = spot_check(eng, gen)
    print(f"[scale] FM spot check ok: occurrences {found}", flush=True)

    # the first batch carries the process's lazy set-up and, on a fresh
    # checkout, the kernels' build: reported apart from the steady rate
    warm = walls[0] if walls else 0.0
    steady_syms = total - total // max(len(walls), 1)
    steady_wall = max(wall_total - warm, 1e-9)
    result = {
        "metric": "bcr_scale_run",
        "symbols": total,
        "reads": nreads,
        "read_len": L,
        "sorting_order": so,
        "wall_s": round(wall_total, 1),
        "throughput_sym_s": round(total / wall_total, 1),
        "warmup_s": round(warm, 1),
        "steady_throughput_sym_s": round(steady_syms / steady_wall, 1),
        "device": device_label(dev),
        "power_limit": power_limit(dev),
        "batch_walls_s": [round(w, 2) for w in walls],
        "capacity": eng.state.cap,
        "data": {
            "mode": env("SCALE_DATA", "uniform"),
            "cov": float(env("SCALE_COV", 47.0)),
            "err": float(env("SCALE_ERR", 0.01)),
        },
        "index_tier": query._tier(eng.state),
        "counts": eng.counts().tolist(),
        "spot_check": found,
        "launches": launches,
    }
    st = eng.state
    if isinstance(st, RunBwt):
        ns = int(st.nslot)
        slot_bytes = st.rsym.element_size() + st.rend.element_size()
        result["run_slots"] = ns
        result["sym_per_run"] = round(total / max(ns, 1), 2)
        result["index_bytes_per_sym"] = round(slot_bytes * ns / total, 4)
    if bwt_md5 is not None:
        result["bwt_md5"] = bwt_md5
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print("[scale] RESULT " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
