#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ropebwt2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: the card's name and power limit; build the three kernels from
   ropebwt2_tpu_torch/csrc, and the probe and toy libraries from
   csrc/probes (one nvcc per source, all started together), and time it;
2. kernel A (merge) against its plain version on the card, at the batch
   shape (cap 2^24, 2^17 insertions), at the flush shape (cap 147,062,784,
   2^20 insertions) and on a dense case; the kernel alone beside the
   wrapper, and its bound;
2b. kernel C (packed merge) against its plain version at the every-round
   shape (cap 2^24, 2^17 insertions), on a dense case with a ragged last
   block, at cap 2^28 + 2^20 with 2^24 insertions (17 anchor chunks) and
   at the packed sustained regime's flush (cap 147,849,216, 2^20);
   then at the capacity phase's flush shape (cap 2,246,049,792, 2^24
   lanes of which 6 * 2^20 active, n past 2^31), where the plain version
   would need ~72 GB,
   against kernel A on the unpacked int8 copy with int64 tables;
3. kernel B (pending merge) against its plain version, pcap 2^20 with
   2^17 rows per round, the pending set 0%, 30% and 90% full, and at the
   capacity path's shape (pcap 2^24, 2^20 rows, half full);
4. small builds (4096 reads x 101 in 3 batches, so 0/1/2, defer_r 0/8):
   the card's BWT equals the CPU's byte for byte, and an LF walk from
   every sentinel spells back the multiset of the reads; the same builds
   on the packed tier (pack4=1) equal the CPU's packed builds and the
   card's flat builds;
5. the main path at the benchmark shape (2^17 coverage reads x 101, RLO,
   K = 128): one batch into an empty index, then a fresh index planned
   for 11 batches with 8 prefill and 2 timed batches; kernels A and B
   must launch.  The sustained regime runs again on the packed tier
   (pack4=1), and its BWT must equal the flat run's (by md5);
6. the capacity tier at the size of scripts/scale_run.py's runs:
   coverage reads (seed 0, 47x, 1% errors) x 101, RLO, batches of 2^20
   reads, pack4="auto", planned upfront for 21 batches (2,246,049,792
   symbols, n past 2^31): packed from the first batch, R = 16, pcap 2^24.
   counts() after every batch; packed rank equal to the int8 rank with
   int64 tables at 2^20+ positions (every anchor boundary +-1, positions
   past 2^31); an LF walk from 4096 sentinel rows spells reads of the
   input; the md5 of the BWT in scale_run.py's text encoding.  Kernels B
   and C must launch;
7. the probe suite (ropebwt2_tpu_torch/probes), the counterparts of the
   TPU probe scripts, in the order H (kernel A's cost per CTA against its
   bound), F (the merge wrapper's steps), E (kernel A's stages looped
   alone), D (a cold build and a fresh process's first kernel result), G
   (the Hopper feature probes).  Every probe kernel is first held against
   its plain version, and the feature kernels again at their timing
   shapes; a feature that does not compile is printed as FAIL and is no
   failure, one that compiles and disagrees is.

Launches are counted per path: each path (the batch and the sustained
regime of phase 5, flat and packed, the capacity build of phase 6, the
probe suite of phase 7) runs with every count set to 0 just before it
and is read just after.  A count is of eager launches: the probes time
short kernels in CUDA graphs, whose capture launches nothing and whose
replays do not call the wrappers.  Every kernel's entry in the kernels line has
its time, its plain version's, its bound (the bytes it must move over
the card's 3.35 TB/s, probes/_timing.py), the library call's where one
PyTorch call computes the same function, and its launches by path.

Every comparison is exact (integer data: max_abs_err must be 0).  The
script fails with a nonzero exit, and prints no result line, when there
is no card, when the package is not beside it, or when any phase fails.
The last three lines are the kernel table as JSON, the card's name and
power limit, and then
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# the capacity phase: scripts/scale_run.py's configuration (SCALE4G's
# batches of 2^20 reads), cut from 39,321,600 reads to 21 batches
SCALE_MBATCH, SCALE_BATCHES = 1 << 20, 21
CAP_SCALE = SCALE_BATCHES * SCALE_MBATCH * (L_BENCH + 1)  # 2,246,049,792
SCALE_WALKS = 4096  # sentinel rows walked back to their reads
CAP_PACKED = 147_849_216  # the packed sustained regime's capacity (phase 5)
# name, cap, insertion lanes, live n, dense, reference; the sustained case
# is a flush of the packed sustained regime (R = 8), the flush case
# leaves 10 of 16 rounds' lanes inactive, as the last flush of a phase 6
# batch (102 rounds, R = 16) does
PACKED_CASES = (
    ("round", 1 << 24, 1 << 17, (1 << 24) - (1 << 17) - 4097, False,
     "plain"),
    ("dense", (1 << 24) + 768, 1 << 17, 5_000_000, True, "plain"),
    ("chunks", (1 << 28) + (1 << 20), 1 << 24, (1 << 28) - (1 << 24) + 777,
     False, "plain"),
    ("sustained", CAP_PACKED, 1 << 20, CAP_PACKED - (1 << 20) - 12345, False,
     "plain"),
    ("flush", CAP_SCALE, 1 << 24, CAP_SCALE - (1 << 24) - 12345, False,
     "kernel A"),
)
FLUSH_ACTIVE = 6 << 20  # active lanes of the packed flush case
# kernel B at the capacity path's shape: pcap 2^24 (R = 16), 2^20 rows
# per round, the pending set half full (its mean over a flush cycle)
PEND_CAPACITY = (1 << 24, 1 << 20, CAP_SCALE, 0.5)


def say(*a):
    print(*a, flush=True)


def time_ms(fn, iters=5):
    """Mean device time of fn() in ms over ``iters`` calls, after one
    warm-up call (CUDA events)."""
    from ropebwt2_tpu_torch.probes._timing import event_ms

    return event_ms(fn, iters)


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


def _counters():
    """(module, kernel name, key) of every launch count: a module-level
    int (key None) or a dict entry."""
    from ropebwt2_tpu_torch.index import (
        merge_cuda, merge_packed_cuda, pending_cuda,
    )
    from ropebwt2_tpu_torch.probes import (
        kernel_features, kernel_stages, warmup_build,
    )

    out = [(merge_cuda, "merge", None), (pending_cuda, "pending_merge", None),
           (merge_packed_cuda, "merge_packed", None),
           (warmup_build, "toy", None)]
    out += [(kernel_stages, f"stage_{s}", s) for s in kernel_stages.STAGES]
    out += [(kernel_features, k, k) for k in kernel_features.KERNELS]
    return out


def reset_launches():
    """Set every kernel's launch count to 0."""
    for mod, _, key in _counters():
        if key is None:
            mod.LAUNCHES = 0
        else:
            mod.LAUNCHES[key] = 0


def read_launches():
    """{kernel name: launches since the last reset}."""
    return {name: mod.LAUNCHES if key is None else mod.LAUNCHES[key]
            for mod, name, key in _counters()}


def launched(counts):
    """The kernels of ``counts`` that launched, for printing."""
    return {k: v for k, v in counts.items() if v}


def text_md5(bwt):
    """md5 of a BWT in the reference's plain-text encoding ("$ACGTN"
    characters and one trailing newline), as scripts/scale_run.py hashes
    it."""
    import hashlib

    h = hashlib.md5()
    lut = np.frombuffer(b"$ACGTN", dtype=np.uint8)
    for lo in range(0, bwt.shape[0], 1 << 26):
        h.update(lut[bwt[lo: lo + (1 << 26)]].tobytes())
    h.update(b"\n")
    return h.hexdigest()


# ---------------------------------------------------------------- phase 2

def insertions(gen, m, n, dense, a=None):
    """m insertion lanes into a live prefix of n: (pos, sym, stream, valid,
    active count).  The first ``a`` lanes (all by default) are active, the
    rest inactive.  Dense: half of the active ones at one position, and a
    tail of 1000 inactive lanes."""
    import torch

    dev = DEV
    if a is None:
        a = m - 1000 if dense else m
    pos = torch.randint(0, n + 1, (m,), generator=gen, device=dev)
    if dense:
        pos[: a // 2] = n // 3
    pos[a:] = 0
    pos[:a] = torch.sort(pos[:a]).values
    valid = torch.arange(m, device=dev) < a
    stream = torch.where(valid, torch.arange(m, device=dev), 0)
    sym = torch.randint(0, 6, (m,), generator=gen, device=dev)
    return pos, sym, stream, valid, a


def merge_case(gen, cap, m, n, dense, K=128):
    """Random live prefix of n symbols (garbage past it), m sorted
    insertions; holds the kernel's result on the live prefix and its table
    rows against the plain version's.  Returns max_abs_err, the wrapper's,
    the plain version's and the kernel's own times (CUDA events on
    merge_cuda.run_kernel in a CUDA graph, and the profiler), and the
    kernel's bound."""
    import torch
    from ropebwt2_tpu_torch.index import merge_cuda
    from ropebwt2_tpu_torch.index.flat import PAD_TAIL, table_dtype
    from ropebwt2_tpu_torch.index.merge import apply_insertions
    from ropebwt2_tpu_torch.index.rank import build_block_tables
    from ropebwt2_tpu_torch.probes import _timing

    dev = DEV
    alloc = cap + PAD_TAIL
    bwt = torch.randint(-128, 128, (alloc,), generator=gen, device=dev,
                        dtype=torch.int8)
    bwt[:n] = torch.randint(0, 6, (n,), generator=gen, device=dev,
                            dtype=torch.int8)
    pos, sym, stream, valid, a = insertions(gen, m, n, dense)
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

    nb = -(-alloc // merge_cuda.BS)
    dest, insmap = merge_cuda.insertion_map(pos, sym, stream, valid, nb)
    start = merge_cuda.block_prefix(dest, nb)
    return {"err": err, "wrapper_ms": time_ms(kern),
            "plain_ms": time_ms(plain),
            "ms": _timing.graph_ms(lambda: merge_cuda.run_kernel(
                bwt, insmap, start, nt)),
            "profiled_ms": kernel_ms(kern, "merge_kernel"),
            "bound_ms": _timing.bound_ms(_timing.merge_bytes(n, a, alloc))}


def phase_merge(torch):
    gen = torch.Generator(device=DEV).manual_seed(2)
    out = {}
    for name, cap, m, n, dense in MERGE_CASES:
        r = merge_case(gen, cap, m, n, dense)
        say(f"[2] merge {name}: cap {cap} M {m} n {n} max_abs_err "
            f"{r['err']} (tolerance 0) wrapper {r['wrapper_ms']:.4f} ms "
            f"plain {r['plain_ms']:.4f} ms kernel alone {r['ms']:.4f} ms "
            f"(profiler {fmt_ms(r['profiled_ms'])}), bound "
            f"{r['bound_ms']:.4f} ms, share {r['bound_ms'] / r['ms']:.3f}")
        if r["err"] != 0:
            raise AssertionError(f"merge kernel disagrees ({name})")
        out[name] = r
    return out


# --------------------------------------------------------------- phase 2b

def absolute_rows(blkA, blkB, cap, nblk):
    """int64 per-symbol prefix at symbol rows 0..nblk-1 of two-level
    tables (anchor + anchor-relative row), and the raw rows it used."""
    import torch
    from ropebwt2_tpu_torch.index.packed import LANE, blkb_row

    blks = torch.arange(nblk, device=blkA.device)
    a, b = blkA[(blks * LANE) >> 24], blkB[blkb_row(blks, cap // 256)]
    return a + b, a, b


def packed_case(gen, cap, m, n, dense, ref):
    """Kernel C on a random packed buffer (live prefix of n symbols, any
    nibble past it) with m sorted insertions, against ``ref``: the plain
    version, or kernel A on the unpacked int8 copy with int64 tables.
    Returns max_abs_err, the wrapper's, the reference's and the kernel's
    own (profiler) times, the kernel's bound and the active lanes."""
    import torch
    from ropebwt2_tpu_torch.index import merge_cuda, merge_packed_cuda
    from ropebwt2_tpu_torch.probes import _timing
    from ropebwt2_tpu_torch.index.packed import (
        LANE, PPAD_ROWS, apply_insertions_packed, build_two_level_tables,
        pack_bwt, unpack_bwt,
    )

    dev = DEV
    syms = torch.randint(0, 16, (cap + 2 * LANE * PPAD_ROWS,), generator=gen,
                         device=dev, dtype=torch.int8)
    syms[:n] = torch.randint(0, 6, (n,), generator=gen, device=dev,
                             dtype=torch.int8)
    pb = pack_bwt(syms)
    if ref == "plain":
        del syms
    pos, sym, stream, valid, a = insertions(
        gen, m, n, dense, FLUSH_ACTIVE if ref != "plain" else None)
    nt = torch.tensor(n, dtype=torch.int64, device=dev)
    live = n + a
    nblk = live // LANE + 1

    def kern():
        return merge_packed_cuda.merge_packed(pb, pos, sym, stream, valid,
                                              nt, 128)

    got, gA, gB = kern()
    torch.cuda.synchronize()
    got_abs, got_a, got_b = absolute_rows(gA, gB, cap, nblk)
    if ref == "plain":
        def reference():
            new = apply_insertions_packed(pb, nt, pos, sym, stream, valid)
            return new, *build_two_level_tables(new, cap)

        want, wA, wB = reference()
        want_abs, want_a, want_b = absolute_rows(wA, wB, cap, nblk)
        err = max(max_abs_diff(got_a, want_a), max_abs_diff(got_b, want_b),
                  max_abs_diff(got_abs, want_abs))
        want = unpack_bwt(want[: -(-live // 256) * 128])[:live]
        del wA, wB, want_abs, want_a, want_b
    else:
        def reference():
            return merge_cuda.merge(syms, pos, sym, stream, valid, nt, 128)

        want, want_blk = reference()
        err = max_abs_diff(got_abs, want_blk[:nblk])
        want = want[:live]
        del want_blk
    err = max(err, max_abs_diff(unpack_bwt(got[: -(-live // 256) * 128])
                                [:live], want))
    del got, gA, gB, got_abs, got_a, got_b, want
    ms = time_ms(kern)
    ref_ms = time_ms(reference)
    kms = kernel_ms(kern, "merge_packed_kernel")
    if ref != "plain":  # where the wrapper's time goes, at this shape
        _, rows = profile(lambda: [kern() for _ in range(3)])
        for name, us, calls in rows[:8]:
            say(f"[2b]   wrapper profile: {us / 3e3:9.4f} ms/call "
                f"{calls // 3:4d}x {name[:80]}")
    bound = _timing.bound_ms(_timing.merge_packed_bytes(n, a, pb.shape[0]))
    torch.cuda.empty_cache()
    return {"err": err, "wrapper_ms": ms, "plain_ms": ref_ms,
            "ms": kms if kms is not None else ms,
            "ms_of": "kernel" if kms is not None else "wrapper",
            "bound_ms": bound, "active": a}


def phase_packed(torch):
    gen = torch.Generator(device=DEV).manual_seed(5)
    out = {}
    for name, cap, m, n, dense, ref in PACKED_CASES:
        r = packed_case(gen, cap, m, n, dense, ref)
        say(f"[2b] merge_packed {name}: cap {cap} M {m} active {r['active']}"
            f" n {n} reference {ref} max_abs_err {r['err']} (tolerance 0) "
            f"wrapper {r['wrapper_ms']:.4f} ms {ref} {r['plain_ms']:.4f} ms "
            f"kernel alone ({r['ms_of']}) {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms, share {r['bound_ms'] / r['ms']:.3f}")
        if r["err"] != 0:
            raise AssertionError(f"packed merge kernel disagrees ({name})")
        out[name] = r
    return out


# ---------------------------------------------------------------- phase 3

def phase_pending(torch):
    from ropebwt2_tpu_torch.index import pending_cuda
    from ropebwt2_tpu_torch.index.pending import (
        INF, KP, PendingIndex, merge_rows, new_rows,
    )
    from ropebwt2_tpu_torch.index.rank import build_block_tables
    from ropebwt2_tpu_torch.probes import _timing

    dev = DEV
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [(*PEND_SHAPE, frac) for frac in (0.0, 0.3, 0.9)]
    cases.append(PEND_CAPACITY)
    out = {}
    for pcap, m, nmax, frac in cases:
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
        bound = _timing.bound_ms(_timing.pending_bytes(pcap, pfill + a, a))
        kt = kms if kms is not None else ms
        say(f"[3] pending {int(frac * 100)}% full: pcap {pcap} M {m} "
            f"active {a} max_abs_err {err} (tolerance 0) wrapper {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms kernel alone {fmt_ms(kms)}, bound "
            f"{bound:.4f} ms, share {bound / kt:.3f}")
        if err != 0:
            raise AssertionError(f"pending kernel disagrees ({frac})")
        out[(pcap, frac)] = {
            "err": err, "wrapper_ms": ms, "plain_ms": plain_ms, "ms": kt,
            "ms_of": "kernel" if kms is not None else "wrapper",
            "bound_ms": bound}
        del pend, vp, psym, args, got, ref
        torch.cuda.empty_cache()
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
            arrs = {}
            for device in (DEV, "cpu"):
                for pack4 in (0, 1):
                    eng = TorchBwt(so=so, defer_r=defer_r, device=device,
                                   pack4=pack4)
                    for bt in batches:
                        eng.insert_multi(bt)
                    arrs[device, pack4] = eng.bwt_array()
            same = np.array_equal(arrs[DEV, 0], arrs["cpu", 0])
            walk = lf_strings(arrs[DEV, 0], nreads) == want
            psame = np.array_equal(arrs[DEV, 1], arrs["cpu", 1])
            pflat = np.array_equal(arrs[DEV, 1], arrs[DEV, 0])
            pwalk = lf_strings(arrs[DEV, 1], nreads) == want
            say(f"[4] so {so} defer_r {defer_r}: cuda == cpu {same}, "
                f"LF walk spells the reads {walk}; packed: cuda == cpu "
                f"{psame}, == flat on the card {pflat}, LF walk {pwalk}")
            if not (same and walk and psame and pflat and pwalk):
                raise AssertionError(f"small build failed (so {so}, "
                                     f"defer_r {defer_r})")


# ---------------------------------------------------------------- phase 5

def report_profile(label, wall, rows, top=12, tag="[5]"):
    """Print a profiled batch's device busy time, idle share and top
    kernels; the whole table goes to smoke_out/."""
    busy = sum(r[1] for r in rows) / 1e6
    say(f"{tag} profile {label}: wall {wall:.4f} s (profiled), device busy "
        f"{busy:.4f} s, idle share {1 - busy / wall:.3f}")
    for name, us, calls in rows[:top]:
        say(f"{tag}   {us / 1e3:10.3f} ms {100 * us / 1e6 / busy:5.1f}% "
            f"{calls:7d}x {name[:90]}")
    out = os.path.join(HERE, "smoke_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"profile_{label.split()[0]}.txt"), "w") as f:
        for name, us, calls in rows:
            f.write(f"{us:.1f}\t{calls}\t{name}\n")


def phase_main(torch, ReadGen):
    from ropebwt2_tpu_torch.engine import TorchBwt

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
    batch_walls = []
    for _ in range(2):  # the first run includes PyTorch's lazy set-up
        eng = TorchBwt(so=1, K=128, device=DEV)
        torch.cuda.synchronize()
        reset_launches()  # the batch path: the last run's launches
        t0 = time.perf_counter()
        eng.insert_multi(reads)
        torch.cuda.synchronize()
        batch_walls.append(time.perf_counter() - t0)
        check(eng, 1)
        del eng
    batch_launches = read_launches()
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
    reset_launches()  # the sustained path: the timed batches
    for bt in sustained_batches[PREFILL:]:
        t0 = time.perf_counter()
        eng.insert_multi(bt)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(eng, PREFILL + SUSTAIN)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    say(f"[5] batch regime: {syms} symbols into an empty index, walls "
        f"{[round(w, 4) for w in batch_walls]} s, "
        f"{syms / min(batch_walls) / 1e6:.3f} Msym/s (best), launches "
        f"{launched(batch_launches)}")
    say(f"[5] sustained regime: cap {eng.state.cap} R {defer_r} pcap {pcap}, "
        f"prefill {PREFILL - 1} batches {prefill_s:.3f} s (+1 profiled), "
        f"timed walls "
        f"{[round(w, 4) for w in walls]} s, "
        f"{syms / min(walls) / 1e6:.3f} Msym/s (best), n {eng.n}")
    say(f"[5] launches on the batch path (one batch): "
        f"{launched(batch_launches)}; on the sustained path ({SUSTAIN} timed "
        f"batches): {launched(launches)}; peak device memory {peak} B "
        f"({peak / 2**30:.3f} GiB)")
    if launches["merge"] == 0 or launches["pending_merge"] == 0:
        raise AssertionError(f"a kernel never launched: {launches}")

    # the sustained regime again on the packed tier: the same BWT
    flat_md5 = text_md5(eng.bwt_array())
    del eng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = TorchBwt(so=1, K=128, device=DEV, pack4=1)
    eng._plan((PREFILL + SUSTAIN + 1) * syms)
    p_defer, p_pcap = eng._choose_defer(M_BENCH)
    t0 = time.perf_counter()
    for bt in sustained_batches[:PREFILL]:
        eng.insert_multi(bt)
    torch.cuda.synchronize()
    p_prefill_s = time.perf_counter() - t0
    p_walls = []
    reset_launches()  # the packed sustained path: the timed batches
    for bt in sustained_batches[PREFILL:]:
        t0 = time.perf_counter()
        eng.insert_multi(bt)
        torch.cuda.synchronize()
        p_walls.append(time.perf_counter() - t0)
    check(eng, PREFILL + SUSTAIN)
    p_launches = read_launches()
    p_peak = torch.cuda.max_memory_allocated()
    packed_md5 = text_md5(eng.bwt_array())
    p_cap = eng.state.cap
    del eng
    torch.cuda.empty_cache()
    say(f"[5] sustained regime, packed tier (pack4=1): cap {p_cap} R "
        f"{p_defer} pcap {p_pcap}, prefill {PREFILL} batches "
        f"{p_prefill_s:.3f} s, timed walls {[round(w, 4) for w in p_walls]} "
        f"s, {syms / min(p_walls) / 1e6:.3f} Msym/s (best) against flat "
        f"{syms / min(walls) / 1e6:.3f} Msym/s; peak device memory {p_peak} "
        f"B ({p_peak / 2**30:.3f} GiB) against flat {peak} B "
        f"({peak / 2**30:.3f} GiB); launches {launched(p_launches)}")
    say(f"[5] packed BWT == flat BWT (compared by md5 of the text "
        f"encoding): {packed_md5 == flat_md5} ({packed_md5}, {flat_md5})")
    if packed_md5 != flat_md5:
        raise AssertionError("the packed tier's BWT differs from the flat's")
    if p_launches["merge_packed"] == 0 or p_launches["pending_merge"] == 0:
        raise AssertionError(f"a kernel never launched: {p_launches}")
    if batch_launches["merge"] == 0:
        raise AssertionError(f"a kernel never launched: {batch_launches}")
    return {"batch": (batch_launches, 1), "sustained": (launches, SUSTAIN),
            "sustained_packed": (p_launches, SUSTAIN)}


# ---------------------------------------------------------------- phase 6

def read_hashes(mat):
    """A 64-bit hash of every row of an (m, L) symbol matrix."""
    m, ln = mat.shape
    buf = np.zeros((m, -(-ln // 8) * 8), np.uint8)
    buf[:, :ln] = mat
    h = np.zeros(m, np.uint64)
    for w in buf.view(np.uint64).T:
        h = (h ^ w) * np.uint64(0x9E3779B97F4A7C15)
    return h


def lf_walk(torch, st, counts, rows, steps):
    """LF walks on the card from ``rows`` of a packed index, with its
    packed rank: the (W, steps) symbols read, 0 once a walk has reached
    its string's sentinel."""
    from ropebwt2_tpu_torch.index.packed import rank_global_packed

    C = torch.cumsum(counts, 0) - counts
    live = torch.ones_like(rows, dtype=torch.bool)
    out = []
    for _ in range(steps):
        r0 = rank_global_packed(st.pbwt, st.blkA, st.blkB, rows)
        s = (rank_global_packed(st.pbwt, st.blkA, st.blkB, rows + 1)
             - r0).argmax(dim=1)
        live &= s != 0
        out.append(torch.where(live, s, 0))
        rows = torch.where(live, C[s] + r0.gather(1, s[:, None])[:, 0], rows)
    return torch.stack(out, dim=1)


def phase_capacity(torch, ReadGen):
    from ropebwt2_tpu_torch.engine import TorchBwt
    from ropebwt2_tpu_torch.index.packed import (
        ACHUNK, PackedFlatBwt, rank_global_packed, unpack_bwt,
    )
    from ropebwt2_tpu_torch.index.rank import build_block_tables, rank_global

    mb, nbatch, L = SCALE_MBATCH, SCALE_BATCHES, L_BENCH
    nreads = mb * nbatch
    total = nreads * (L + 1)
    say(f"[6] cut: SCALE4G_r04.json's 39,321,600 reads x {L} "
        f"(4,010,803,200 symbols) cut to {nbatch} batches of {mb} reads: "
        f"{nreads} reads, {total} symbols, to stay inside the time limit")
    gen = ReadGen(seed=0, nreads=nreads, L=L, mode="coverage", cov=47.0,
                  err=0.01)

    def draw():  # the next batch and the hashes of its reads as walked
        t0 = time.perf_counter()
        bt = gen.batch(mb).view(np.int8)
        return bt, read_hashes(bt[:, ::-1]), time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = TorchBwt(so=1, K=128, device=DEV)  # pack4="auto"
    eng._plan(total)
    defer_r, pcap = eng._choose_defer(mb)
    say(f"[6] plan: {type(eng.state).__name__} cap {eng.state.cap} R "
        f"{defer_r} pcap {pcap}")
    if not isinstance(eng.state, PackedFlatBwt) or eng.state.cap != CAP_SCALE:
        raise AssertionError("the capacity plan is not packed at CAP_SCALE")
    hashes, walls, gen_s = [], [], 0.0
    reset_launches()
    t_all = time.perf_counter()
    # a host thread draws the next batch while the card builds this one
    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(draw)
        for i in range(nbatch):
            bt, h, g = nxt.result()
            gen_s += g
            hashes.append(h)
            if i + 1 < nbatch:
                nxt = pool.submit(draw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == nbatch - 1:  # the last batch: where the time goes
                wall, rows = profile(lambda: eng.insert_multi(bt))
                report_profile(f"capacity batch {i + 1}", wall, rows,
                               tag="[6]")
            else:
                eng.insert_multi(bt)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            cnt = eng.counts()
            done = (i + 1) * mb
            if int(cnt[0]) != done or int(cnt.sum()) != done * (L + 1):
                raise AssertionError(f"self-check failed after batch "
                                     f"{i + 1}: counts {cnt}")
            walls.append(wall)
            say(f"[6] batch {i + 1}: {wall:.4f} s"
                f"{' (profiled)' if i == nbatch - 1 else ''}, n {eng.n}, "
                f"{mb * (L + 1) / wall / 1e6:.3f} Msym/s")
    build_s = time.perf_counter() - t_all
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    st, n = eng.state, eng.n
    resident = st.pbwt.numel() + 8 * st.blkA.numel() + 4 * st.blkB.numel()
    steady = walls[1:-1]
    say(f"[6] built {n} symbols in {build_s:.3f} s (reads drawn on a host "
        f"thread meanwhile, {gen_s:.3f} s); first batch {walls[0]:.4f} s; "
        f"steady {mb * (L + 1) * len(steady) / sum(steady) / 1e6:.3f} "
        f"Msym/s over batches 2-{nbatch - 1} (walls "
        f"{min(steady):.4f}-{max(steady):.4f} s); all-in "
        f"{n / build_s / 1e6:.3f} Msym/s")
    say(f"[6] peak device memory {peak} B ({peak / 2**30:.3f} GiB, "
        f"{peak / n:.4f} B/sym); resident index {resident} B "
        f"({resident / n:.4f} B/sym: pbwt {st.pbwt.numel()} B, blkA "
        f"{8 * st.blkA.numel()} B, blkB {4 * st.blkB.numel()} B)")
    say(f"[6] launches on the capacity path: {launched(launches)}")

    # rank: packed two-level tables against the int8 rank, int64 tables
    g = torch.Generator(device=DEV).manual_seed(6)
    anchors = torch.arange(1, n // ACHUNK + 1, device=DEV) * ACHUNK
    pos = torch.cat([
        torch.randint(0, n + 1, (1 << 20,), generator=g, device=DEV),
        torch.randint(min(1 << 31, n), n + 1, (1 << 16,), generator=g,
                      device=DEV),
        anchors - 1, anchors, anchors + 1,
        torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, n - 1, n],
                     device=DEV),
    ]).clamp(0, n)
    flat_bwt = unpack_bwt(st.pbwt)
    want = rank_global(flat_bwt, build_block_tables(flat_bwt, 128), pos, 128)
    del flat_bwt
    rank_err = max_abs_diff(
        rank_global_packed(st.pbwt, st.blkA, st.blkB, pos), want)
    del want
    torch.cuda.empty_cache()
    say(f"[6] rank: packed == int8 with int64 tables at {pos.numel()} "
        f"positions ({anchors.numel()} anchor boundaries +-1, "
        f"{int((pos >= 1 << 31).sum())} at or past 2^31): max_abs_err "
        f"{rank_err} (tolerance 0)")

    # LF walks from sentinel rows spell reads of the input
    spelled = lf_walk(torch, st, torch.from_numpy(eng.counts()).to(DEV),
                      torch.arange(SCALE_WALKS, device=DEV), L + 1)
    spelled = spelled.cpu().numpy()
    shaped = bool((spelled[:, :L] != 0).all() and (spelled[:, L] == 0).all())
    table = np.sort(np.concatenate(hashes))
    h = read_hashes(spelled[:, :L].astype(np.uint8))
    found = int((table[np.searchsorted(table, h).clip(max=table.size - 1)]
                 == h).sum())
    say(f"[6] LF walk from {SCALE_WALKS} sentinel rows with the packed rank "
        f"on the card: {L} symbols then the sentinel {shaped}; {found} of "
        f"{SCALE_WALKS} spell a read of the input")

    tm = time.perf_counter()
    md5 = text_md5(eng.bwt_array())
    say(f"[6] bwt md5 {md5} (scale_run.py's text encoding, no phantom "
        f"read; {time.perf_counter() - tm:.3f} s incl. transfer)")
    del eng, st
    torch.cuda.empty_cache()
    if n <= 1 << 31 or rank_err != 0 or not shaped or found != SCALE_WALKS:
        raise AssertionError("the capacity phase failed its checks")
    if launches["merge_packed"] == 0 or launches["pending_merge"] == 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    return {"capacity": (launches, nbatch)}


# ---------------------------------------------------------------- phase 7

def phase_probes(torch):
    """The probe suite: every probe kernel against its plain version, then
    the probes' measurements in the order H, F, E, D, G with every launch
    count set to 0 before and read after.  Returns (results, launches)."""
    from ropebwt2_tpu_torch.probes import (
        _timing, kernel_features, kernel_scaling, kernel_stages, merge_phases,
        warmup_build,
    )

    def tag(line):
        say(f"[7] {line}")

    t0 = time.perf_counter()
    errs = {"H": kernel_scaling.check(tag, DEV),
            "F": merge_phases.check(tag, DEV)}
    errs.update(kernel_stages.check(tag, DEV))
    errs["toy"] = warmup_build.check(tag, DEV)
    feats = kernel_features.check(tag, DEV)
    errs.update({k: v for k, v in feats.items() if isinstance(v, int)})
    if any(errs.values()):
        raise AssertionError(f"a probe disagrees with its plain version: "
                             f"{errs}")
    reset_launches()  # the probe suite's path
    res = {"H": kernel_scaling.measure(tag, DEV),
           "F": merge_phases.measure(tag, DEV)}
    flush = next(r for r in res["H"] if r["label"] == "flush")
    res["E"] = kernel_stages.measure(tag, flush["cta_us"], DEV)
    x = torch.arange(8 * 128, dtype=torch.int32, device=DEV).view(8, 128)
    one = torch.ones((), dtype=torch.int32, device=DEV)
    res["toy"] = {
        "ms": _timing.graph_ms(lambda: warmup_build.toy(x), 20),
        "plain_ms": time_ms(lambda: warmup_build.toy_plain(x), 20),
        "library_ms": _timing.graph_ms(lambda: torch.add(one, x, alpha=2),
                                       20)}
    res["D"] = warmup_build.measure(tag)
    res["G"] = kernel_features.measure(tag, DEV)
    launches = read_launches()
    for k, r in res["G"].items():  # the same kernels at their timing shapes
        errs[k] = max(errs[k], r["err"])
    if any(errs.values()):
        raise AssertionError(f"a probe disagrees with its plain version at "
                             f"its timing shape: {errs}")
    res["errs"], res["failed"] = errs, {k: v for k, v in feats.items()
                                        if not isinstance(v, int)}
    tag(f"eager launches on the probe path (CUDA-graph replays not "
        f"counted): {launched(launches)}")
    tag(f"phase 7 took {time.perf_counter() - t0:.1f} s")
    probe_kernels = (["toy"] + [f"stage_{s}" for s in kernel_stages.STAGES]
                     + [k for k in kernel_features.KERNELS
                        if k not in res["failed"]])
    never = [k for k in probe_kernels if launches[k] == 0]
    if never:
        raise AssertionError(f"probe kernels never launched: {never}")
    return res, launches


def kernel_table(merge_res, packed_res, pend_res, paths, probes):
    """The kernels line: A, B, C with their launches per batch on every
    path, their time, plain time and bound at the shape of each path, and
    every probe kernel of phase 7."""
    from ropebwt2_tpu_torch.probes import _timing, kernel_stages

    def by_path(name):
        return {path: counts[name] / nbatch
                for path, (counts, nbatch) in paths.items()}

    def entry(name, source, replaces, launches, err, r, **extra):
        return {"name": name, "route": "cuda",
                "source": f"ropebwt2_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "library_ms": r.get("library_ms"), **extra}

    def shapes(res):
        return {k: {f: v[f] for f in ("ms", "wrapper_ms", "plain_ms",
                                      "bound_ms")}
                for k, v in res.items()}

    pend = {f"pcap {k[0]} {int(100 * k[1])}% full": v
            for k, v in pend_res.items()}
    # time and bound of A, B, C at the shape each path gives them
    at_path = {
        "merge": {"batch": merge_res["batch"],
                  "sustained": merge_res["flush"]},
        "pending_merge": {"sustained": pend_res[(PEND_SHAPE[0], 0.3)],
                          "sustained_packed": pend_res[(PEND_SHAPE[0], 0.3)],
                          "capacity": pend_res[(PEND_CAPACITY[0],
                                                PEND_CAPACITY[3])]},
        "merge_packed": {"sustained_packed": packed_res["sustained"],
                         "capacity": packed_res["flush"]},
    }
    main = []
    for name, source, replaces, res, first, headline in (
        ("merge", "merge.cu", "ropebwt2_tpu/index/merge_pallas.py:582",
         merge_res, merge_res["batch"], "sustained"),
        ("pending_merge", "pending.cu",
         "ropebwt2_tpu/index/pending_pallas.py:279", pend,
         pend_res[(PEND_SHAPE[0], 0.3)], "sustained"),
        ("merge_packed", "merge_packed.cu",
         "ropebwt2_tpu/index/merge_pallas_packed.py:353", packed_res,
         packed_res["round"], "capacity"),
    ):
        per_batch = by_path(name)
        path_rows = {
            p: {"launches_per_batch": per_batch[p], "ms": r["ms"],
                "bound_ms": r["bound_ms"],
                "rank_ms": per_batch[p] * (r["ms"] - r["bound_ms"])}
            for p, r in at_path[name].items() if per_batch.get(p)}
        main.append(entry(
            name, source, replaces,
            paths[headline][0][name], max(r["err"] for r in res.values()),
            first, shapes=shapes(res), by_path=path_rows))
    probes_out = []
    toy = dict(probes["toy"], bound_ms=_timing.bound_ms(2 * 4 * 8 * 128))
    probes_out.append(entry("toy", "probes/toy.cu",
                            "scripts/probe_warmup_aot.py:34",
                            probes["launches"]["toy"],
                            probes["errs"]["toy"], toy))
    for st, r in probes["E"].items():
        probes_out.append(entry(
            f"stage_{st}", "probes/stages.cu",
            "scripts/probe_kernel_stages.py:30",
            probes["launches"][f"stage_{st}"], probes["errs"][st],
            {"ms": r["pass_ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"]},
            ms_of=f"one pass of {r['grid']} CTAs (launch / "
                  f"{kernel_stages.ITERS})",
            bound_of="the pass's bytes through L1 and shared memory",
            hbm_in_a_ms=r["hbm_in_a_ms"], one_cta_us=r["one_cta_us"],
            share_of_a=r["of_a"]))
    for k, r in probes["G"].items():
        probes_out.append(entry(
            k, "probes/features.cu", "scripts/probe_kfeat_tpu.py:25",
            probes["launches"][k], probes["errs"][k], r))
    return main + probes_out


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
    # the main, the probe and the toy library, every nvcc started together
    with ThreadPoolExecutor(max_workers=3) as pool:
        for f in [pool.submit(_build.lib), pool.submit(_build.probe_lib),
                  pool.submit(_build.build, "toy")]:
            f.result()
    built = _build.BUILD_SECONDS
    say(f"[1] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(main nvcc {'%.2f s' % built if built is not None else 'cached'}):"
        f" {_build.library_path().name}, "
        f"{_build.library_path('probes').name}, "
        f"{_build.library_path('toy').name}")
    for lib in ("main", "probes"):
        log = _build.library_path(lib).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    say(f"[1] ptxas ({lib}): {line.strip()}")
    for unit, status in _build.unit_status("probes").items():
        if status != "ok":
            say(f"[1] probe unit {unit} did not compile (reported in phase "
                f"7): {status.strip().splitlines()[0][:200]}")

    merge_res = phase_merge(torch)
    packed_res = phase_packed(torch)
    pend_res = phase_pending(torch)
    phase_small(torch, ReadGen)
    paths = phase_main(torch, ReadGen)
    paths.update(phase_capacity(torch, ReadGen))
    probes, probe_launches = phase_probes(torch)
    probes["launches"] = probe_launches

    kernels = kernel_table(merge_res, packed_res, pend_res, paths, probes)
    say(json.dumps({"kernels": kernels,
                    "not_compiled": probes["failed"]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
