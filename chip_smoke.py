#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ropebwt2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: the card's name and power limit; build both kernels from
   ropebwt2_tpu_torch/csrc and time the build;
2. kernel A (merge) against its plain version on the card, at the batch
   shape (cap 2^24, 2^17 insertions), at the flush shape (cap 147,062,784,
   2^20 insertions) and on a dense case;
3. kernel B (pending merge) against its plain version, pcap 2^20 with
   2^17 rows per round, the pending set 0%, 30% and 90% full;
4. small builds (4096 reads x 101 in 3 batches, so 0/1/2, defer_r 0/8):
   the card's BWT equals the CPU's byte for byte, and an LF walk from
   every sentinel spells back the multiset of the reads;
5. the main path at the benchmark shape (2^17 coverage reads x 101, RLO,
   K = 128): one batch into an empty index, then a fresh index planned
   for 11 batches with 8 prefill and 2 timed batches; both kernels must
   launch.

Every comparison is exact (integer data: max_abs_err must be 0).  The
script fails with a nonzero exit, and prints no result line, when there
is no card, when the package is not beside it, or when any phase fails.
The last two lines are the kernel table as JSON and then
{"ok": true, "device": {...}}; the card's name and power limit come
just before them.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"
M_BENCH, L_BENCH = 1 << 17, 101  # bench.py's batch: 2^17 reads x 101
PREFILL, SUSTAIN = 8, 2  # bench.py's sustained regime
CAP_FLUSH = 147_062_784  # the capacity that bench.py's sustained plan gives
MERGE_CASES = (  # name, cap, insertions, live n, dense
    ("batch", 1 << 24, 1 << 17, (1 << 24) - (1 << 17) - 4097, False),
    ("flush", CAP_FLUSH, 1 << 20, CAP_FLUSH - (1 << 20) - 12345, False),
    ("dense", 1 << 24, 1 << 17, 5_000_000, True),
)
PEND_SHAPE = (1 << 20, 1 << 17, CAP_FLUSH)  # pcap, rows per round, max vp
SMALL = (4096, (1366, 1365, 1365))  # reads, batch sizes


def say(*a):
    print(*a, flush=True)


def time_ms(fn, iters=5):
    """Mean device time of fn() in ms over ``iters`` calls, after one
    warm-up call (CUDA events)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile(fn):
    """Run fn() under torch.profiler; returns (wall s, [(kernel name, device
    us, calls)] sorted by device time).  An empty list means the profiler
    saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us > 0 and ev.device_type != torch.autograd.DeviceType.CPU:
            rows.append((ev.key, us, ev.count))
    return wall, sorted(rows, key=lambda r: -r[1])


def kernel_ms(fn, name, iters=3):
    """Device time per call of the kernels whose name contains ``name``,
    from the profiler over ``iters`` calls of fn (None if not seen)."""
    _, rows = profile(lambda: [fn() for _ in range(iters)])
    us = sum(r[1] for r in rows if name in r[0])
    return us / 1e3 / iters if us else None


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def max_abs_diff(a, b):
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


# ---------------------------------------------------------------- phase 2

def merge_case(gen, cap, m, n, dense, K=128):
    """Random live prefix of n symbols (garbage past it), m sorted
    insertions; returns the kernel's and the plain version's results on
    the live prefix and its table rows, and both times."""
    import torch
    from ropebwt2_tpu_torch.index import merge_cuda
    from ropebwt2_tpu_torch.index.flat import PAD_TAIL, table_dtype
    from ropebwt2_tpu_torch.index.merge import apply_insertions
    from ropebwt2_tpu_torch.index.rank import build_block_tables

    dev = DEV
    alloc = cap + PAD_TAIL
    bwt = torch.randint(-128, 128, (alloc,), generator=gen, device=dev,
                        dtype=torch.int8)
    bwt[:n] = torch.randint(0, 6, (n,), generator=gen, device=dev,
                            dtype=torch.int8)
    if dense:
        # most insertions at one position, a tail of inactive lanes
        a = m - 1000
        pos = torch.randint(0, n + 1, (m,), generator=gen, device=dev)
        pos[: a // 2] = n // 3
        pos[a:] = 0
        pos[:a] = torch.sort(pos[:a]).values
    else:
        a = m
        pos = torch.sort(torch.randint(0, n + 1, (m,), generator=gen,
                                       device=dev)).values
    valid = torch.arange(m, device=dev) < a
    stream = torch.where(valid, torch.arange(m, device=dev), 0)
    sym = torch.randint(0, 6, (m,), generator=gen, device=dev)
    nt = torch.tensor(n, dtype=torch.int64, device=dev)

    got, got_blk = merge_cuda.merge(bwt, pos, sym, stream, valid, nt, K)
    torch.cuda.synchronize()

    def plain():
        new = apply_insertions(bwt, nt, pos, sym, stream, valid)
        return new, build_block_tables(new, K, dtype=table_dtype(cap))

    ref, ref_blk = plain()
    live = n + a
    err = max(max_abs_diff(got[:live], ref[:live]),
              max_abs_diff(got_blk[: live // K + 1], ref_blk[: live // K + 1]))
    def kern():
        return merge_cuda.merge(bwt, pos, sym, stream, valid, nt, K)

    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    return err, ms, plain_ms, kernel_ms(kern, "merge_kernel")


def phase_merge(torch):
    gen = torch.Generator(device=DEV).manual_seed(2)
    out = []
    for name, cap, m, n, dense in MERGE_CASES:
        err, ms, plain_ms, kms = merge_case(gen, cap, m, n, dense)
        say(f"[2] merge {name}: cap {cap} M {m} n {n} max_abs_err {err} "
            f"(tolerance 0) wrapper {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"kernel alone {fmt_ms(kms)}")
        if err != 0:
            raise AssertionError(f"merge kernel disagrees ({name})")
        out.append((name, err, ms, plain_ms))
    return out


# ---------------------------------------------------------------- phase 3

def phase_pending(torch):
    from ropebwt2_tpu_torch.index import pending_cuda
    from ropebwt2_tpu_torch.index.pending import (
        INF, KP, PendingIndex, merge_rows, new_rows,
    )
    from ropebwt2_tpu_torch.index.rank import build_block_tables

    dev = DEV
    gen = torch.Generator(device=dev).manual_seed(3)
    pcap, m, nmax = PEND_SHAPE
    out = []
    for frac in (0.0, 0.3, 0.9):
        pfill = int(pcap * frac)
        vp = torch.full((pcap,), INF, dtype=torch.int64, device=dev)
        vp[:pfill] = torch.sort(torch.randint(
            0, nmax - pfill, (pfill,), generator=gen, device=dev
        )).values + torch.arange(pfill, device=dev)
        psym = torch.full((pcap,), 6, dtype=torch.int8, device=dev)
        psym[:pfill] = torch.randint(0, 6, (pfill,), generator=gen,
                                     device=dev, dtype=torch.int8)
        pend = PendingIndex(
            vp=vp, psym=psym,
            blk_prefix=build_block_tables(psym, KP, dtype=torch.int32),
            p=torch.tensor(pfill, dtype=torch.int64, device=dev),
        )
        a = min(m, pcap - pfill)
        active = torch.arange(m, device=dev) < a
        gX = torch.sort(torch.randint(0, nmax, (m,), generator=gen,
                                      device=dev)).values
        stream = torch.where(active, torch.arange(m, device=dev), 0)
        sym = torch.randint(0, 6, (m,), generator=gen, device=dev)
        varr, sarr, start_new, p_after = new_rows(pend, gX, sym, stream,
                                                  active)
        args = (pend.vp, pend.psym, varr, sarr, start_new, p_after)
        got = pending_cuda.merge(*args)
        torch.cuda.synchronize()
        ref = merge_rows(*args)
        err = max(max_abs_diff(g, r) for g, r in zip(got, ref))
        ms = time_ms(lambda: pending_cuda.merge(*args))
        plain_ms = time_ms(lambda: merge_rows(*args))
        kms = kernel_ms(lambda: pending_cuda.merge(*args), "pending_kernel")
        say(f"[3] pending {int(frac * 100)}% full: pcap {pcap} M {m} "
            f"active {a} max_abs_err {err} (tolerance 0) wrapper {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms kernel alone {fmt_ms(kms)}")
        if err != 0:
            raise AssertionError(f"pending kernel disagrees ({frac})")
        out.append((frac, err, ms, plain_ms))
    return out


# ---------------------------------------------------------------- phase 4

def lf_strings(bwt, m):
    """Spell every string back from the multi-string BWT by LF walks from
    its m sentinel rows (numpy only).  A walk reads its string from the
    last symbol to the first; returns the sorted list of those as bytes."""
    b = bwt.astype(np.int64)
    n = b.shape[0]
    occ = np.zeros((n + 1, 6), dtype=np.int64)
    np.add.at(occ, (np.arange(1, n + 1), b), 1)
    occ = np.cumsum(occ, axis=0)
    C = np.concatenate([[0], np.cumsum(occ[-1])[:-1]])
    rows = np.arange(m)
    live = np.ones(m, dtype=bool)
    spelled = []
    while live.any():
        s = b[rows]
        live &= s != 0
        spelled.append(np.where(live, s, 0))
        rows = np.where(live, C[s] + occ[rows, s], rows)
    mat = np.stack(spelled, axis=1).astype(np.int8)
    return sorted(r[r != 0].tobytes() for r in mat)


def phase_small(torch, ReadGen):
    from ropebwt2_tpu_torch.engine import TorchBwt

    nreads, sizes = SMALL
    gen = ReadGen(seed=4, nreads=nreads, L=L_BENCH, mode="coverage",
                  cov=47.0, err=0.01)
    batches = [gen.batch(n).view(np.int8) for n in sizes]
    want = sorted(r[::-1].tobytes() for bt in batches for r in bt)
    for so in (0, 1, 2):
        for defer_r in (0, 8):
            arrs = []
            for device in (DEV, "cpu"):
                eng = TorchBwt(so=so, defer_r=defer_r, device=device)
                for bt in batches:
                    eng.insert_multi(bt)
                arrs.append(eng.bwt_array())
            same = np.array_equal(arrs[0], arrs[1])
            walk = lf_strings(arrs[0], nreads) == want
            say(f"[4] so {so} defer_r {defer_r}: cuda == cpu {same}, "
                f"LF walk spells the reads {walk}")
            if not (same and walk):
                raise AssertionError(f"small build failed (so {so}, "
                                     f"defer_r {defer_r})")


# ---------------------------------------------------------------- phase 5

def report_profile(label, wall, rows, top=12):
    """Print a profiled batch's device busy time, idle share and top
    kernels; the whole table goes to smoke_out/."""
    busy = sum(r[1] for r in rows) / 1e6
    say(f"[5] profile {label}: wall {wall:.4f} s (profiled), device busy "
        f"{busy:.4f} s, idle share {1 - busy / wall:.3f}")
    for name, us, calls in rows[:top]:
        say(f"[5]   {us / 1e3:10.3f} ms {100 * us / 1e6 / busy:5.1f}% "
            f"{calls:7d}x {name[:90]}")
    out = os.path.join(HERE, "smoke_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"profile_{label.split()[0]}.txt"), "w") as f:
        for name, us, calls in rows:
            f.write(f"{us:.1f}\t{calls}\t{name}\n")


def phase_main(torch, ReadGen):
    from ropebwt2_tpu_torch.engine import TorchBwt
    from ropebwt2_tpu_torch.index import merge_cuda, pending_cuda

    gen = ReadGen(seed=0, nreads=M_BENCH * (1 + PREFILL + SUSTAIN),
                  L=L_BENCH, mode="coverage", cov=47.0, err=0.01)
    reads = gen.batch(M_BENCH).view(np.int8)
    syms = M_BENCH * (L_BENCH + 1)
    sustained_batches = [gen.batch(M_BENCH).view(np.int8)
                         for _ in range(PREFILL + SUSTAIN)]

    def check(eng, nbatches):
        cnt = eng.counts()
        if int(cnt[0]) != M_BENCH * nbatches or \
                int(cnt.sum()) != syms * nbatches:
            raise AssertionError(f"self-check failed: counts {cnt}")

    torch.cuda.reset_peak_memory_stats()
    merge_cuda.LAUNCHES = 0
    pending_cuda.LAUNCHES = 0
    batch_walls = []
    for _ in range(2):  # the first run includes PyTorch's lazy set-up
        eng = TorchBwt(so=1, K=128, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.insert_multi(reads)
        torch.cuda.synchronize()
        batch_walls.append(time.perf_counter() - t0)
        check(eng, 1)
        del eng
    batch_launches = (merge_cuda.LAUNCHES, pending_cuda.LAUNCHES)
    wall, rows = profile(
        lambda: TorchBwt(so=1, K=128, device=DEV).insert_multi(reads))
    report_profile("batch", wall, rows)

    eng = TorchBwt(so=1, K=128, device=DEV)
    eng._plan((PREFILL + SUSTAIN + 1) * syms)
    defer_r, pcap = eng._choose_defer(M_BENCH)
    t0 = time.perf_counter()
    for bt in sustained_batches[:PREFILL - 1]:
        eng.insert_multi(bt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    # the last prefill batch runs under the profiler: where the time goes
    wall, rows = profile(lambda: eng.insert_multi(
        sustained_batches[PREFILL - 1]))
    report_profile("sustained (prefill batch 8)", wall, rows)
    walls = []
    for bt in sustained_batches[PREFILL:]:
        t0 = time.perf_counter()
        eng.insert_multi(bt)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(eng, PREFILL + SUSTAIN)
    launches = {"merge": merge_cuda.LAUNCHES, "pending": pending_cuda.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()

    say(f"[5] batch regime: {syms} symbols into an empty index, walls "
        f"{[round(w, 4) for w in batch_walls]} s, "
        f"{syms / min(batch_walls) / 1e6:.3f} Msym/s (best), launches "
        f"merge {batch_launches[0]} pending {batch_launches[1]}")
    say(f"[5] sustained regime: cap {eng.state.cap} R {defer_r} pcap {pcap}, "
        f"prefill {PREFILL - 1} batches {prefill_s:.3f} s (+1 profiled), "
        f"timed walls "
        f"{[round(w, 4) for w in walls]} s, "
        f"{syms / min(walls) / 1e6:.3f} Msym/s (best), n {eng.n}")
    say(f"[5] launches on the main path: merge {launches['merge']} "
        f"pending {launches['pending']}; peak device memory "
        f"{peak} B ({peak / 2**30:.3f} GiB)")
    if launches["merge"] == 0 or launches["pending"] == 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; refusing to run on the CPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from readgen import ReadGen
    from ropebwt2_tpu_torch import _build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True,
    ).stdout.strip()
    say(f"[1] device: {name}; {torch.cuda.device_count()} visible; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    say(f"[1] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    _build.lib()
    built = _build.BUILD_SECONDS
    say(f"[1] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {'%.2f s' % built if built is not None else 'cached'}): "
        f"{_build.library_path().name}")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"[1] ptxas: {line.strip()}")

    merge_res = phase_merge(torch)
    pend_res = phase_pending(torch)
    phase_small(torch, ReadGen)
    launches = phase_main(torch, ReadGen)

    # ms / plain_ms: merge at the batch shape, pending merge 30% full
    kernels = [{
        "name": "merge", "route": "cuda",
        "source": "ropebwt2_tpu_torch/csrc/merge.cu",
        "replaces": "ropebwt2_tpu/index/merge_pallas.py:582",
        "launches": launches["merge"],
        "max_abs_err": max(r[1] for r in merge_res),
        "ms": merge_res[0][2], "plain_ms": merge_res[0][3],
    }, {
        "name": "pending_merge", "route": "cuda",
        "source": "ropebwt2_tpu_torch/csrc/pending.cu",
        "replaces": "ropebwt2_tpu/index/pending_pallas.py:279",
        "launches": launches["pending"],
        "max_abs_err": max(r[1] for r in pend_res),
        "ms": pend_res[1][2], "plain_ms": pend_res[1][3],
    }]
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
