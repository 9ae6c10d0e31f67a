#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ropebwt2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: the card's name and power limit; build the three kernels from
   ropebwt2_tpu_torch/csrc, and the probe and toy libraries from
   csrc/probes (one nvcc per source, all started together), and time it;
2. kernel A (merge) against its plain version on the card, at the batch
   shape (cap 2^24, 2^17 insertions), at the flush shape (cap 147,062,784,
   2^20 insertions), on a dense case, and at phase 9's largest calls (the
   last round of its one-batch run, cap 213,909,504 with 2^21 insertions;
   of its -m 64m run the last round and the last flush, cap 2^28 with
   638,194 and 1,095,420 active lanes), and at one rank's flush of the
   sharded engine at 4 ranks (phase 13; cap 2^26 + 2^21, 2^21 lanes, 2^19
   active, n 2^26): the wrapper's buffer and K-block
   tables, and the kernel alone (run_kernel: buffer and 128-symbol rank
   prefix) with int32 and int64 rows; the kernel alone beside the whole
   wrapper (eager and on the device) and the earlier kernel's and
   wrapper's times, and its bound;
2b. kernel C (packed merge) against its plain version at the every-round
   shape (cap 2^24, 2^17 insertions), on a dense case with a ragged last
   block, on a mixed case (CTAs with no insertion, whose old runs start at
   symbol 0 and on packed-row boundaries; CTAs that are all insertions;
   sparse insertions after them, old runs across 17 packed rows), at cap
   2^28 + 2^20 with 2^24 insertions (17 anchor chunks), at the packed
   sustained regime's flush (cap 147,849,216, 2^20) and at phase 14
   scale_run's flush (cap 428,867,584, 4 x 2^20, all active);
   then at the capacity phase's flush shape (cap 2,246,049,792, 2^24
   lanes of which 6 * 2^20 active, n past 2^31), where the plain version
   would need ~72 GB,
   against kernel A on the unpacked int8 copy with int64 tables;
3. kernel B (pending merge) against its plain version through the
   ping-pong interface (planes given, the engine's bound of the live
   rows: every row of the capacity compared, the rows past the launched
   CTAs untouched), pcap 2^20 with 2^17 rows per round, the pending set
   0% (CTAs all new), 30% and 90% full (p_after = pcap), with no active
   lane (p_after = 0), and at the capacity path's shape (pcap 2^24, 2^20
   rows, half full), and at phase 9's fullest call (pcap 2^21, 2^18 rows,
   1,277,990 pending), and at the shapes phases 10-12 give it (half full:
   pcap 2^21 with 2^17 rows, 2^22 with 2^19, 2^16 and 2^18 with 2^12), and
   at one rank's of the sharded engine at 4 ranks (phase 13: pcap 2^21,
   2^17 lanes of which 2^15 routed to the rank, a quarter full), and at
   phase 14 scale_run's (pcap 2^22, 2^20 rows, half full);
   then pending_add chained over 4 rounds, a reset and 4 more, against the
   plain version round by round;
3r. the rank kernels (csrc/rank.cu) against their plain versions at 2^20
   queries, the bulk of a round's rank calls: flat over cap 147,062,784
   (int32 tables, sorted and uniform positions; int64 tables) and cap 2^24,
   the pending index at pcap 2^24 half full and 2^20 30% full, and the
   deferred flat path's virtual rank (one launch) over the sustained
   shapes; at phase 8's query shapes (flat, 2^18 sorted and 2^16 uniform
   positions); at phase 12's long-read shapes (4096 queries: flat cap
   2^24, pcap 2^16 half full, and the virtual rank over both); and at one
   rank's of the sharded engine at d = 4 (2^15 queries: flat lcap 2^26,
   pcap 2^21 a quarter full, and the virtual rank over both with g - p
   clamped to [0, lcap]); the pending index at the run tier's shape
   (phase 10: pcap 2^21 half full, 2^17 queries); the packed rank and the
   packed tier's virtual rank (one launch) over synthetic packed buffers
   (random symbols, PAD past n, two-level tables built on the card) at
   cap 2,246,049,792 (n past 2^31; pcap 2^24 half full) and 147,849,216
   (the packed sustained regime's; pcap 2^20 30% full), 2^20 sorted and
   uniform queries, and the packed rank at phase 8's query shapes; each
   timed alone as a CUDA graph of its launch, beside its plain version,
   its bound (bytes read once and written once over 3.35 TB/s: positions,
   answers, the distinct prefix rows and 32-byte sectors of the rows
   below each position; probes/_timing.py) and the earlier design's time
   (EARLIER_MS); the packed rank kernel is held and timed again in phase
   6 on that phase's index.
   ``python3 chip_smoke.py --rank-variants`` runs phase 1 and this phase
   alone, with the earlier design's launches (probes/rank_variants.py:
   the flat kernel as it was, with K a constant and without the count;
   the packed kernel as it was; the pending kernel; each deferred round's
   two launches) and this design's parts (the flat and the packed rank's
   loads without the count, the pending rank's search alone and its count
   alone) timed in the same call, each held to the plain version where it
   computes a rank, and each kernel's SASS count with its issue-slot
   floor; it prints them as JSON and no result line;
4. small builds (4096 reads x 101 in 2 batches, so 0/1/2, defer_r 0/8):
   the card's BWT equals the CPU's byte for byte, and an LF walk from
   every sentinel spells back the multiset of the reads; the same builds
   on the packed tier (pack4=1) equal the card's flat builds and spell the
   reads back too;
5. the main path at the benchmark shape (2^17 coverage reads x 101, RLO,
   K = 128), through the port's bench stage functions
   (ropebwt2_tpu_torch/bench.py): one batch into an empty index, then a
   fresh index planned for 11 batches with 8 prefill and 2 timed batches;
   kernels A and B and the flat rank kernel must launch on the batch path,
   and on the sustained (deferred) path the virtual rank kernel, one
   launch a rank, and neither the flat nor the pending rank kernel.
   The sustained regime runs again on the packed tier (pack4=1), and its
   BWT must equal the flat run's (by md5); kernels B and C and the packed
   virtual rank kernel must launch there, and neither the pending rank
   kernel nor the flat tier's virtual kernel;
6. the capacity tier at the size of scripts/scale_run.py's runs, built
   through the port's scripts/scale_run.py (TorchBwt.plan, batches,
   insert_batch, text_md5): coverage reads (seed 0, 47x, 1% errors) x 101,
   RLO, batches of 2^20 reads, pack4="auto", planned upfront for 21
   batches (2,246,049,792 symbols, n past 2^31): packed from the first
   batch, R = 16, pcap 2^24.
   counts() after every batch; the packed rank kernel and its plain
   version, and the flat rank kernel on the unpacked int8 copy with int64
   tables, equal to the plain int8 rank at 2^20+ positions (every anchor
   boundary +-1, positions past 2^31); the packed rank kernel timed at
   2^20 sorted positions; an LF walk from 4096 sentinel rows spells reads
   of the input; the md5 of the BWT in scale_run.py's text encoding.  Kernels B
   and C and the packed virtual rank kernel must launch, and the pending
   rank kernel must not;
7. the probe suite (ropebwt2_tpu_torch/probes), the counterparts of the
   TPU probe scripts, in the order H (kernel A's cost per CTA against its
   bound), F (the merge wrapper's steps), E (kernel A's stages looped
   alone), D (a cold build and a fresh process's first kernel result), G
   (the Hopper feature probes).  Every probe kernel is first held against
   its plain version, and the feature kernels again at their timing
   shapes; a feature that does not compile is printed as FAIL and is no
   failure, one that compiles and disagrees is.

8. the FM-index queries of bench.py:225-321 through the port's bench
   query stages (its inputs from default_rng(1) in the JAX bench's order,
   over engine/query.py) on the flat and the packed index that phase 5's
   sustained regime leaves (10 batches of 2^17 x 101): rank (2^18 sorted
   positions, 32 chained steps), extend (2^18 bi-intervals, 32 chained
   backward steps) and backward_search (2^16 patterns of 31 symbols), in
   Mq/s, M ext/s and M sym-steps/s; rank at 4096 sorted positions against
   numpy counts over the host copy of the BWT, backward_search of 4096
   substrings of the reads (each found, each equal to chained extends), and
   the two tiers' answers equal; each tier's timed stages are a path whose
   rank kernel (flat, packed) must launch;
9. the CLI end to end: 2^20 coverage reads x 101 (seed 0, 47x, 1% errors)
   as gzip FASTQ through ``python -m ropebwt2_tpu_torch.cli -s -d`` in a
   child process (both strands, the default -m: one batch of ~214 M
   symbols), which must build on the card with the native reader and
   writer; then ``-s -m 64m`` with text output in this process (several
   batches); the FMD decoded by FmdReader equals the text BWT byte for
   byte, an LF walk over it spells back 1000 strings of the input, and -b
   on 2^14 reads then -i with 2^14 more equals one build of both.  The
   shapes the two runs give kernels A and B must be phases 2 and 3's
   cases: the first run's as TorchBwt plans it, the second's as recorded
   from the engine's calls (engine_calls);
10. the run-length tier (index/runs.py) on phase 5's sustained reads:
   TorchBwt(so=1, runs=1), 8 prefill batches (the last profiled) and 2
   timed; its BWT equals phase 5's flat BWT (md5); R, pcap, live slots,
   symbols a slot, resident B/sym, peak memory;
11. the run tier at deep coverage, scripts/configs/scale4gdeep_runs.sh's
   configuration (150x, 0.3% errors, seed 777, batches of 2^19 reads, RLO,
   runs_margin 0.35, R = 8) cut to DEEP_BATCHES batches, built through the
   port's scale_run functions: Msym/s per batch,
   symbols a slot, resident B/sym, overflow 0, counts, md5, and an LF walk
   from 4096 sentinel rows with the run tier's rank that spells reads of
   the input;
12. long reads: 4096 uniform reads of 2,000-5,000 bp in one batch (5,001
   rounds), built through the port's longread_run.build, on the flat tier
   (defer_r=16) and on the run tier: equal md5s,
   LF walks from every sentinel row of the run-tier index spell the
   reads, rounds per second.
   Phases 10-12 must launch kernel B, at the largest (pcap, lanes) of
   phase 3's cases for them.
13. the multi-device engine (ropebwt2_tpu_torch/parallel/): (a) kernel A
   on one rank's stitched buffer at the per-rank shapes of a world of 4 on
   phase 5's plan (lcap 2^26 from ShardedTorchBwt._plan's formula, a tail
   of 2^17 rows with 2^15 routed insertions and s_lo 0, 5 and 98,304; the
   flush's shift, a tail of 2^23 and s_lo 2^20), the window and its
   rebased int32 K-rows against merge_blocks, and (R, pcap) from
   _choose_defer at d = 4 equal to phase 3's sharded case; (b)
   ShardedTorchBwt at a world of one over NCCL on phase 5's sustained
   reads (8 prefill batches, the last profiled, and 2 timed; R and pcap
   chosen at lcap 2^28): its BWT equals phase 5's flat BWT by md5; with
   defer_r = 0 on one batch into an empty index it equals TorchBwt's; grown
   with no plan through 3 batches of 2^20 uniform reads x 101 (lcap 2^27,
   2^28, 2^29: two re-shards, each one all_to_all of ranges), each
   re-shard's wall, n before it, bytes received (exactly the new window's
   live symbols and the (d, 6) totals) and peak, the growth's own time,
   and the BWT equal to TorchBwt's on the same reads by md5; the
   process group is destroyed after; (c) ``ROPEBWT2_TPU_SHARDED=1 python
   -m ropebwt2_tpu_torch.cli -s -d`` on phase 9's FASTQ in a fresh
   process: its FMD equals phase 9's run 1 byte for byte, and it logs
   "sharded engine over 1 devices".
14. the entry points as a user runs them, each in a fresh process:
   ``python -m ropebwt2_tpu_torch.bench`` with BENCH_RUNS=2 (its last line
   parses, has no ``degraded``, names this card and its power limit, and
   its launches show kernel A on the batch path and A and B on the
   sustained one), and ``python -m ropebwt2_tpu_torch.scripts.scale_run``
   at 4 batches of 2^20 reads on the packed tier with SCALE_MD5=1 (its
   index hashed, its FM spot check passed, kernels B and C launched at
   the capacity and R that phases 2b and 3 hold them at), and ``python -m
   ropebwt2_tpu_torch.scripts.scale_shards`` (the sharded engine on the
   card, worlds of the ranks this host's cards hold, each rank 0's BWT
   equal to TorchBwt's).

Launches are counted per path: each path (the batch and the sustained
regime of phase 5, flat and packed, the capacity build of phase 6, the
probe suite of phase 7, each tier's query stages in phase 8, the CLI's
run in this process of phase 9, the run
tier's timed batches of phase 10, the deep-coverage build of phase 11,
each long-read build of phase 12, the sharded engine's timed batches and
its batch merged every round in phase 13; phase 14's children count their
own from 0 and report them) runs
with every count set to 0 just before it and is read just after. A count
is of eager launches: the probes time short kernels in CUDA graphs,
whose capture launches nothing and whose replays do not call the
wrappers. Every kernel's entry in the kernels line has its time, its
plain version's, its bound (the bytes it must move over the card's 3.35
TB/s, probes/_timing.py), the library call's where one PyTorch call
computes the same function, and its launches by path.

Kernels A, B and C are timed alone as a CUDA graph of their bare launch
(A's with the reset of its look-back status words; the profiler's figure
beside it as a check); the times of the kernels that these designs
replaced are printed beside the new ones.

Every comparison is exact (integer data: max_abs_err must be 0).  The
script fails with a nonzero exit, and prints no result line, when there
is no card, when the package is not beside it, or when any phase fails.
The last three lines are the kernel table as JSON, the card's name and
power limit, and then
{"ok": true, "device": {...}}.
"""

import contextlib
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
# phase 9's reads: 2^20 x 101, both strands (213,909,504 symbols); its
# `-s -m 64m` run inserts batches of 638,194 strings (2^20 lanes) and a
# 4th of 182,570 (2^18 lanes, R = 8, pcap 2^21)
CLI_TOTAL, CLI_BATCH, CLI_LAST = 213_909_504, 638_194, 182_570
MERGE_CASES = (  # name, cap, insertion lanes, live n, dense, active lanes
    ("batch", 1 << 24, 1 << 17, (1 << 24) - (1 << 17) - 4097, False, None),
    ("flush", CAP_FLUSH, 1 << 20, CAP_FLUSH - (1 << 20) - 12345, False,
     None),
    ("dense", 1 << 24, 1 << 17, 5_000_000, True, None),
    # the CLI's largest calls of kernel A (phase 9 holds them to what its
    # run gives): the last round of `-s -d`'s one batch of 2^21 strings,
    # and of `-s -m 64m` the last round of its 3rd batch and the last
    # flush of its 4th
    ("cli", CLI_TOTAL, 1 << 21, CLI_TOTAL - (1 << 21), False, None),
    ("cli 64m round", 1 << 28, 1 << 20, 2 * 102 * CLI_BATCH + 101 * CLI_BATCH,
     False, CLI_BATCH),
    ("cli 64m flush", 1 << 28, 1 << 21, 3 * 102 * CLI_BATCH + 96 * CLI_LAST,
     False, 6 * CLI_LAST),
    # a flush of phase 12's long reads on the flat tier (cap 2^24, pcap
    # 2^16 lanes of which 16 rounds of 4096 reads at most)
    ("long flush", 1 << 24, 1 << 16, 14_000_000, False, None),
    # the sharded flush's merge of one rank at d = 4 (phase 13): its window
    # and pcap of scratch, pcap lanes, 16 rounds of M / 4 routed rows active
    ("sharded flush", (1 << 26) + (1 << 21), 1 << 21, 1 << 26, False,
     16 * (1 << 17) // 4),
)
PEND_SHAPE = (1 << 20, 1 << 17, CAP_FLUSH)  # pcap, rows per round, max vp
# kernel B in the CLI's 4th batch at its fullest: pcap 2^21, 2^18 lanes,
# 7 of R = 8 rounds pending, one round's strings active
PEND_CLI = (1 << 21, 1 << 18, CLI_TOTAL, 7 * CLI_LAST / (1 << 21), CLI_LAST)
SMALL = (4096, (2048, 2048))  # reads, batch sizes
# the capacity phase: scripts/scale_run.py's configuration (SCALE4G's
# batches of 2^20 reads), cut from 39,321,600 reads to 21 batches
SCALE_MBATCH, SCALE_BATCHES = 1 << 20, 21
CAP_SCALE = SCALE_BATCHES * SCALE_MBATCH * (L_BENCH + 1)  # 2,246,049,792
SCALE_WALKS = 4096  # sentinel rows walked back to their reads
# phase 8: bench.py's query workloads (positions x chained steps; patterns
# x length), and the sampled checks
QUERY_RANK, QUERY_SEARCH, QUERY_CHECKS = (1 << 18, 32), (1 << 16, 31), 4096
# phase 9: reads of the CLI's input, LF walks over its FMD, and the reads
# of each file of the -b / -i check
CLI_READS, CLI_WALKS, CLI_RESTORE = 1 << 20, 1000, 1 << 14
CLI_M = "64m"  # -m of the second run, which gives several batches
CAP_PACKED = 147_849_216  # the packed sustained regime's capacity (phase 5)
# phase 14's scale_run (4 batches of 2^20 reads x 101 on the packed tier,
# planned for 427,819,008 symbols and the phantom read: capacity 409 x
# 2^20): R 4 and pcap 2^22 from _choose_defer, so kernel B merges 2^20 rows
# a round into a pending set half full at its mean, and kernel C flushes 4
# x 2^20 pending rows, all active (uniform reads keep every lane live)
CAP_SCALE14 = 428_867_584
PEND_SCALE14 = (1 << 22, 1 << 20, CAP_SCALE14, 0.5)
# name, cap, insertion lanes, live n, dense, reference; the sustained case
# is a flush of the packed sustained regime (R = 8), the flush case
# leaves 10 of 16 rounds' lanes inactive, as the last flush of a phase 6
# batch (102 rounds, R = 16) does
PACKED_CASES = (
    ("round", 1 << 24, 1 << 17, (1 << 24) - (1 << 17) - 4097, False,
     "plain"),
    ("dense", (1 << 24) + 768, 1 << 17, 5_000_000, True, "plain"),
    ("mixed", 1 << 24, 1 << 17, (1 << 24) - (1 << 17) - 4097, "mixed",
     "plain"),
    ("chunks", (1 << 28) + (1 << 20), 1 << 24, (1 << 28) - (1 << 24) + 777,
     False, "plain"),
    ("sustained", CAP_PACKED, 1 << 20, CAP_PACKED - (1 << 20) - 12345, False,
     "plain"),
    ("flush", CAP_SCALE, 1 << 24, CAP_SCALE - (1 << 24) - 12345, False,
     "kernel A"),
    ("scale_run flush", CAP_SCALE14, 4 << 20,
     CAP_SCALE14 - (4 << 20) - 12345, False, "plain"),
)
FLUSH_ACTIVE = 6 << 20  # active lanes of the packed flush case
# kernel B at the capacity path's shape: pcap 2^24 (R = 16), 2^20 rows
# per round, the pending set half full (its mean over a flush cycle)
PEND_CAPACITY = (1 << 24, 1 << 20, CAP_SCALE, 0.5)
PEND_CHAIN = 4  # chained rounds of kernel B before and after a reset
# phase 10: the run tier on phase 5's sustained reads; R = 16 and pcap 2^21
# from _choose_defer with 5 * rcap standing for the capacity (rcap 30.5 M
# to 122 M slots), the pending set half full at its mean
PEND_RUNS = (1 << 21, 1 << 17, CAP_FLUSH, 0.5)
# phase 11: scripts/configs/scale4gdeep_runs.sh (coverage 150x, 0.3% errors,
# L 101, seed 777, batches of 2^19 reads, RLO, runs=1, margin 0.35, R 8),
# cut from its 44,040,192 reads to DEEP_BATCHES batches (the coverage of the
# drawn reads stays 150x: the genome is cut with them)
DEEP_READS, DEEP_MBATCH, DEEP_BATCHES = 44_040_192, 1 << 19, 29
DEEP_TOTAL = DEEP_BATCHES * DEEP_MBATCH * (L_BENCH + 1)
PEND_DEEP = (1 << 22, 1 << 19, DEEP_TOTAL, 0.5)
# the JAX package's record of this configuration at 29 batches (a TPU's
# build, SCALERUNS15_r05.json): its md5 and symbols a slot, printed beside
# this card's
DEEP_RECORD = ("8c27991cdea3ff556ac0144b0eff8fb5", 9.47)
# phase 12: long reads, tests/test_longreads.py's kbp case at card scale:
# 4096 uniform reads of 2,000-5,000 bp (~14.4 M symbols, 5,001 rounds in one
# batch) on the flat tier (R = 16: pcap 2^16) and on the run tier (R = 64
# from 5 * rcap: pcap 2^18)
LONG_READS, LONG_LEN, LONG_SEED = 4096, (2000, 5000), 12
LONG_N = 14_400_000  # about its symbols
PEND_LONG = (1 << 16, 1 << 12, LONG_N, 0.5)
PEND_LONG_RUNS = (1 << 18, 1 << 12, LONG_N, 0.5)
# phase 13: the sharded engine.  13a holds kernels A and B at the per-rank
# shapes of a world of SHARD_D ranks on phase 5's sustained plan (the shapes
# are computed in one process; no world of 4 is started): lcap from
# ShardedTorchBwt._plan's formula (2^26), a round's tail of M_BENCH global
# rows with SHARD_ROUTED insertions routed to the rank and s_lo phantom
# marks, and the flush's shift (a tail of d * pcap = 2^23, no insertions,
# s_lo = the pending rows of two ranks below); the flush's merge is phase
# 2's "sharded flush" row (lcap + pcap, pcap lanes, 16 rounds of
# SHARD_ROUTED active) and kernel B phase 3's PEND_SHARDED case (R 16, pcap
# 2^21 from _choose_defer at d = 4; d * ml = 2^17 lanes, SHARD_ROUTED of them
# routed to the rank; the pending set a quarter full, as at a flush)
# phase 14: the entry points in fresh processes: the bench with
# BENCH_RUNS=2 (its default sizes otherwise), and scale_run at 4 batches of
# 2^20 uniform reads x 101 on the packed tier (427,819,008 symbols)
BENCH14_RUNS, SCALE14_BATCHES = 2, 4
SHARD_D, SHARD_LCAP, SHARD_PCAP = 4, 1 << 26, 1 << 21
# 13b's growth: reshard_run.BATCHES (3) batches of GROW_MBATCH uniform reads
# x L_BENCH with no plan (scripts/reshard_run.py): lcap 2^27, 2^28, 2^29, two
# re-shards
GROW_MBATCH = 1 << 20
SHARD_ROUTED = M_BENCH // SHARD_D
SHARD_SLO = (0, 5, 3 * M_BENCH // 4)
SHARD_SHIFT = (SHARD_D * SHARD_PCAP, 2 * 16 * SHARD_ROUTED)  # tail, s_lo
PEND_SHARDED = (SHARD_PCAP, M_BENCH, SHARD_LCAP + SHARD_PCAP, 0.25,
                SHARD_ROUTED)
# phase 3r: the rank kernels (csrc/rank.cu) at the shapes the build gives
# them: 2^20 queries a call (plan_round ranks twice a round at M = 2^20);
# flat over the sustained plan's capacity (int32 tables, as the engine keeps
# them below 2^31; int64 as past it) and over 2^24, the positions sorted as
# the plan's are (one case uniform); the pending index at the capacity
# path's pcap 2^24 half full and the sustained path's pcap 2^20 30% full;
# the deferred flat path's virtual rank (one launch) over the sustained
# base and pending index; phase 8's queries (rlo101.queries) over the
# sustained plan's capacity: 2^18 sorted positions (the rank and extend
# stages), 2^16 uniform ones (the backward search's steps); phase 12's long
# reads on the flat tier (4096 queries a call, cap 2^24, pcap 2^16 half
# full); one rank of the sharded engine at d = 4 (phase 13: 2^15 routed
# queries, lcap 2^26, pcap 2^21 a quarter full), whose deferred rank clamps
# the base position to [0, lcap]; the run tier's pending rank on phase 10's
# sustained reads (pcap 2^21 half full, M_BENCH queries); the packed rank
# and the packed tier's deferred rank (one launch) over synthetic packed
# buffers at the capacity path's cap (n past 2^31, pcap 2^24 half full)
# and the packed sustained regime's (pcap 2^20 30% full), and the packed
# rank at phase 8's query shapes; the packed rank again on phase 6's index
RANK_Q = 1 << 20
LONG_Q = 1 << 12  # phase 12's lanes: a long-read round ranks 4096 queries
RANK_FLAT = (  # name, cap, int64 tables, sorted positions, queries
    ("sustained", CAP_FLUSH, False, True, RANK_Q),
    ("sustained uniform", CAP_FLUSH, False, False, RANK_Q),
    ("sustained int64", CAP_FLUSH, True, True, RANK_Q),
    ("batch", 1 << 24, False, True, RANK_Q),
    ("queries rank", CAP_FLUSH, False, True, 1 << 18),
    ("queries search", CAP_FLUSH, False, False, 1 << 16),
    ("long", 1 << 24, False, True, LONG_Q),
    ("sharded", SHARD_LCAP, False, True, SHARD_ROUTED),
)
RANK_PEND = (  # name, pcap, max vp, share full, queries
    ("capacity", 1 << 24, CAP_SCALE, 0.5, RANK_Q),
    ("sustained", 1 << 20, CAP_FLUSH, 0.3, RANK_Q),
    ("long", 1 << 16, LONG_N, 0.5, LONG_Q),
    ("sharded", SHARD_PCAP, SHARD_LCAP + SHARD_PCAP, 0.25, SHARD_ROUTED),
    ("runs", PEND_RUNS[0], PEND_RUNS[2], PEND_RUNS[3], M_BENCH),
)
RANK_VIRTUAL = (  # name, flat base (RANK_FLAT), pending index (RANK_PEND),
    # the clamp of g - p (None: none; the queries in [0, n + pending])
    ("sustained", "sustained", "sustained", None),
    ("long", "long", "long", None),
    ("sharded", "sharded", "sharded", (0, SHARD_LCAP)),
)
RANK_PACKED = (  # name, cap, sorted positions, queries
    ("capacity", CAP_SCALE, True, RANK_Q),
    ("capacity uniform", CAP_SCALE, False, RANK_Q),
    ("sustained", CAP_PACKED, True, RANK_Q),
    ("sustained uniform", CAP_PACKED, False, RANK_Q),
    ("queries rank", CAP_PACKED, True, 1 << 18),
    ("queries search", CAP_PACKED, False, 1 << 16),
)
RANK_VIRTUAL_PACKED = (  # name, packed cap, pending index (RANK_PEND),
    # sorted queries (in [0, n + pending])
    ("capacity", CAP_SCALE, "capacity", True),
    ("capacity uniform", CAP_SCALE, "capacity", False),
    ("sustained", CAP_PACKED, "sustained", True),
    ("sustained uniform", CAP_PACKED, "sustained", False),
)
# kernel ms of the kernels that the present designs replaced, from this
# script (the merge wrapper's: probe F, whole wrapper on the device; the
# rank kernels': `chip_smoke.py --rank-variants`, the earlier design's
# launches at phase 3r's shapes) on an NVIDIA H100 80GB HBM3 at 700 W,
# printed beside the new times: B by (pcap, share full), C by case, A and
# its wrapper by (kernel, case), the rank kernels by (kernel, case)
EARLIER_MS = {
    (1 << 20, 0.0): 0.0248, (1 << 20, 0.3): 0.0233, (1 << 20, 0.9): 0.0311,
    (1 << 24, 0.5): 0.4612,
    "round": 0.0482, "dense": 0.0177, "chunks": 0.7225, "sustained": 0.3989,
    "flush": 5.9672,
    ("merge", "batch"): 0.0351, ("merge", "flush"): 0.2630,
    ("merge", "dense"): 0.0125,
    ("wrapper", "batch"): 0.2626, ("wrapper", "flush"): 2.2789,
    ("rank_flat", "sustained"): 0.1194,
    ("rank_flat", "sustained uniform"): 0.1239,
    ("rank_flat", "sustained int64"): 0.1278,
    ("rank_flat", "batch"): 0.1102, ("rank_flat", "queries rank"): 0.0322,
    ("rank_flat", "queries search"): 0.0089, ("rank_flat", "long"): 0.0031,
    ("rank_flat", "sharded"): 0.0055,
    ("rank_pend", "capacity"): 0.1063, ("rank_pend", "sustained"): 0.0935,
    ("rank_pend", "long"): 0.0088, ("rank_pend", "sharded"): 0.0107,
    # the deferred rank's earlier launches: the pending kernel, then the
    # flat kernel at g - p (clamped in torch between them on the sharded
    # engine)
    ("rank_virtual", "sustained"): 0.2167, ("rank_virtual", "long"): 0.0112,
    ("rank_virtual", "sharded"): 0.0183,
    ("rank_pend", "runs"): 0.0162,
    # the packed rank as PR 11 wrote it (8 threads a query), and the packed
    # tier's earlier deferred rank: the pending kernel, then that kernel at
    # g - p plus the pending counts; phase 6's from the full run before
    # the redesign
    ("rank_packed", "capacity"): 0.1202,
    ("rank_packed", "capacity uniform"): 0.1329,
    ("rank_packed", "sustained"): 0.1089,
    ("rank_packed", "sustained uniform"): 0.1199,
    ("rank_packed", "queries rank"): 0.0312,
    ("rank_packed", "queries search"): 0.0088,
    ("rank_packed", "phase 6"): 0.1154,
    ("rank_virtual_packed", "capacity"): 0.2069,
    ("rank_virtual_packed", "capacity uniform"): 0.4012,
    ("rank_virtual_packed", "sustained"): 0.1652,
    ("rank_virtual_packed", "sustained uniform"): 0.2860,
}


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
        merge_cuda, merge_packed_cuda, pending_cuda, rank_cuda,
    )
    from ropebwt2_tpu_torch.probes import (
        kernel_features, kernel_stages, warmup_build,
    )

    out = [(merge_cuda, "merge", None), (pending_cuda, "pending_merge", None),
           (merge_packed_cuda, "merge_packed", None),
           (warmup_build, "toy", None)]
    out += [(rank_cuda, k, k) for k in rank_cuda.LAUNCHES]
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


def gib(b):
    """A byte count as "<B> B (<GiB> GiB)", or "not measured" (None)."""
    return "not measured" if b is None else f"{b} B ({b / 2**30:.3f} GiB)"


def launched(counts):
    """The kernels of ``counts`` that launched, for printing."""
    return {k: v for k, v in counts.items() if v}


def deferred_flat(tag, counts):
    """A deferred path on the flat tier ranks through the virtual rank
    kernel, one launch a rank: it must launch, and the pending rank kernel
    (the first of the earlier two launches) must not."""
    if counts["rank_virtual"] == 0 or counts["rank_pend"] != 0:
        raise AssertionError(f"{tag} the deferred flat rank did not go "
                             f"through rank_virtual alone: {counts}")


def deferred_packed(tag, counts):
    """A deferred path on the packed tier ranks through the packed virtual
    rank kernel, one launch a rank: it must launch, and neither the
    pending rank kernel (the first of the earlier two launches) nor the
    flat tier's virtual kernel may."""
    if counts["rank_virtual_packed"] == 0 or counts["rank_pend"] != 0 \
            or counts["rank_virtual"] != 0:
        raise AssertionError(f"{tag} the deferred packed rank did not go "
                             f"through rank_virtual_packed alone: {counts}")


# ---------------------------------------------------------------- phase 2

def insertions(gen, m, n, dense, a=None):
    """m insertion lanes into a live prefix of n: (pos, sym, stream, valid,
    active count).  The first ``a`` lanes (all by default) are active, the
    rest inactive.  Dense: half of the active ones at one position, and a
    tail of 1000 inactive lanes.  "mixed": none below n // 2, a quarter at
    n // 2, the rest spread above it."""
    import torch

    dev = DEV
    if a is None:
        a = m - 1000 if dense is True else m
    pos = torch.randint(0, n + 1, (m,), generator=gen, device=dev)
    if dense == "mixed":
        pos = (n // 2 + 1 + pos // 2).clamp(max=n)
        pos[: a // 4] = n // 2
    elif dense:
        pos[: a // 2] = n // 3
    pos[a:] = 0
    pos[:a] = torch.sort(pos[:a]).values
    valid = torch.arange(m, device=dev) < a
    stream = torch.where(valid, torch.arange(m, device=dev), 0)
    sym = torch.randint(0, 6, (m,), generator=gen, device=dev)
    return pos, sym, stream, valid, a


def merge_case(gen, cap, m, n, dense, a=None, K=128):
    """Random live prefix of n symbols (garbage past it), m sorted
    insertion lanes of which the first ``a`` (all if None) are active;
    holds the wrapper's result on the live prefix and its
    table rows against the plain version's, and the kernel alone
    (run_kernel) against its plain version merge_blocks with int32 and
    with int64 prefix rows.  Returns max_abs_err, the wrapper's times
    (eager, and on the device as a CUDA graph), the plain version's, the
    kernel's own (a CUDA graph of merge_cuda.run_kernel, which holds the
    reset of the look-back's status words, and the profiler's figure of
    the kernel alone), and the kernel's bound."""
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
    pos, sym, stream, valid, a = insertions(gen, m, n, dense, a)
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
    del ref, ref_blk, got, got_blk

    def kern():
        return merge_cuda.merge(bwt, pos, sym, stream, valid, nt, K)

    nb = -(-alloc // merge_cuda.BS)
    dest, insmap = merge_cuda.insertion_map(pos, sym, stream, valid, nb)
    start = merge_cuda.block_prefix(dest, nb)
    rows = live // merge_cuda.LANE + 1
    errs = {}
    for dt in (torch.int32, torch.int64):
        k_out, k_pre = merge_cuda.run_kernel(bwt, insmap, start, nt, dt)
        p_out, p_pre = merge_cuda.merge_blocks(bwt, insmap, start, nt, dt)
        errs[str(dt)[6:]] = max(max_abs_diff(k_out[:live], p_out[:live]),
                                max_abs_diff(k_pre[:rows], p_pre[:rows]))
        del k_out, k_pre, p_out, p_pre
    torch.cuda.empty_cache()
    tdt = table_dtype(cap)
    return {"err": max(err, *errs.values()), "kernel_err": errs,
            "wrapper_ms": time_ms(kern),
            "wrapper_device_ms": _timing.graph_ms(kern),
            "plain_ms": time_ms(plain),
            "ms": _timing.graph_ms(lambda: merge_cuda.run_kernel(
                bwt, insmap, start, nt, tdt)),
            "profiled_ms": kernel_ms(kern, "merge_kernel"),
            "bound_ms": _timing.bound_ms(_timing.merge_bytes(
                n, a, alloc, tile=merge_cuda.tile_blocks(nb)))}


def phase_merge(torch):
    gen = torch.Generator(device=DEV).manual_seed(2)
    out = {}
    for name, cap, m, n, dense, a in MERGE_CASES:
        r = merge_case(gen, cap, m, n, dense, a)
        say(f"[2] merge {name}: cap {cap} M {m} active "
            f"{m if a is None else a} n {n} max_abs_err "
            f"{r['err']} (tolerance 0; the kernel alone against "
            f"merge_blocks with int32 / int64 rows: "
            f"{r['kernel_err']['int32']} / {r['kernel_err']['int64']}) "
            f"wrapper {r['wrapper_ms']:.4f} ms eager, "
            f"{r['wrapper_device_ms']:.4f} ms on the device (the earlier "
            f"wrapper {fmt_ms(EARLIER_MS.get(('wrapper', name)))}), plain "
            f"{r['plain_ms']:.4f} ms, kernel alone {r['ms']:.4f} ms with "
            f"its status reset (profiler, kernel only: "
            f"{fmt_ms(r['profiled_ms'])}; the earlier kernel "
            f"{fmt_ms(EARLIER_MS.get(('merge', name)))} and its tables "
            f"apart), bound {r['bound_ms']:.4f} ms, share "
            f"{r['bound_ms'] / r['ms']:.3f}")
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
    own times (a CUDA graph of merge_packed_cuda.run_kernel, and the
    profiler), the kernel's bound and the active lanes."""
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
    nb = -(-2 * pb.shape[0] // merge_packed_cuda.BS)
    insmap, start = merge_packed_cuda.insertion_map(pos, sym, stream, valid,
                                                    nb)
    kms = _timing.graph_ms(lambda: merge_packed_cuda.run_kernel(
        pb, insmap, start, nt), 5)
    del insmap, start
    profiled = kernel_ms(kern, "merge_packed_kernel")
    if ref != "plain":  # where the wrapper's time goes, at this shape
        _, rows = profile(lambda: [kern() for _ in range(3)])
        for name, us, calls in rows[:8]:
            say(f"[2b]   wrapper profile: {us / 3e3:9.4f} ms/call "
                f"{calls // 3:4d}x {name[:80]}")
    bound = _timing.bound_ms(_timing.merge_packed_bytes(n, a, pb.shape[0]))
    torch.cuda.empty_cache()
    return {"err": err, "wrapper_ms": ms, "plain_ms": ref_ms, "ms": kms,
            "ms_of": "kernel", "profiled_ms": profiled, "bound_ms": bound,
            "active": a}


def phase_packed(torch):
    gen = torch.Generator(device=DEV).manual_seed(5)
    out = {}
    for name, cap, m, n, dense, ref in PACKED_CASES:
        r = packed_case(gen, cap, m, n, dense, ref)
        say(f"[2b] merge_packed {name}: cap {cap} M {m} active {r['active']}"
            f" n {n} reference {ref} max_abs_err {r['err']} (tolerance 0) "
            f"wrapper {r['wrapper_ms']:.4f} ms {ref} {r['plain_ms']:.4f} ms "
            f"kernel alone ({r['ms_of']}) {r['ms']:.4f} ms (profiler "
            f"{fmt_ms(r['profiled_ms'])}; the scalar kernel "
            f"{fmt_ms(EARLIER_MS.get(name))}), bound "
            f"{r['bound_ms']:.4f} ms, share {r['bound_ms'] / r['ms']:.3f}")
        if r["err"] != 0:
            raise AssertionError(f"packed merge kernel disagrees ({name})")
        out[name] = r
    return out


# ---------------------------------------------------------------- phase 3

def pending_chain(torch, gen, pcap, m, nmax):
    """pending_add (kernel B, two plane pairs in turn) chained over
    PEND_CHAIN rounds, a reset and PEND_CHAIN more, against the same chain
    on the plain version (merge_rows) round by round: every row of both
    planes, the prefix table and p.  Returns (max_abs_err, CTAs launched
    per round)."""
    from ropebwt2_tpu_torch.index import pending_cuda
    from ropebwt2_tpu_torch.index.pending import (
        PendingIndex, empty_pending, merge_rows, new_rows, pending_add,
        reset_pending,
    )
    from ropebwt2_tpu_torch.index.rank import prefix_rows

    def plain_add(pend, *lanes):
        varr, sarr, start_new, p_after = new_rows(pend, *lanes)
        bound = min(pcap, pend.bound + m)
        vp, psym, rows = merge_rows(pend.vp, pend.psym, varr, sarr,
                                    start_new, p_after, pend.spare, bound)
        return PendingIndex(vp=vp, psym=psym,
                            blk_prefix=prefix_rows(rows, torch.int32),
                            p=p_after, spare=(pend.vp, pend.psym),
                            bound=bound)

    got, want = empty_pending(pcap, DEV), empty_pending(pcap, DEV)
    err, grids = 0, []
    for r in range(2 * PEND_CHAIN):
        if r == PEND_CHAIN:
            got, want = reset_pending(got), reset_pending(want)
        a = m - int(torch.randint(0, m // 4, (1,), generator=gen, device=DEV))
        active = torch.arange(m, device=DEV) < a
        lanes = (torch.sort(torch.randint(0, nmax, (m,), generator=gen,
                                          device=DEV)).values,
                 torch.randint(0, 6, (m,), generator=gen, device=DEV),
                 torch.where(active, torch.arange(m, device=DEV), 0), active)
        got, want = pending_add(got, *lanes), plain_add(want, *lanes)
        torch.cuda.synchronize()
        grids.append(pending_cuda.n_blocks(pcap, got.bound))
        err = max(err, max_abs_diff(got.vp, want.vp),
                  max_abs_diff(got.psym, want.psym),
                  max_abs_diff(got.blk_prefix, want.blk_prefix),
                  max_abs_diff(got.p, want.p), abs(got.bound - want.bound))
    return err, grids


def phase_pending(torch):
    from ropebwt2_tpu_torch.index import pending_cuda
    from ropebwt2_tpu_torch.index.pending import (
        INF, KP, PendingIndex, merge_rows, new_rows,
    )
    from ropebwt2_tpu_torch.index.rank import build_block_tables
    from ropebwt2_tpu_torch.probes import _timing

    dev = DEV
    gen = torch.Generator(device=dev).manual_seed(3)
    # pcap, lanes, max vp, share full, active lanes (None: all that fit)
    cases = [(*PEND_SHAPE, frac, None) for frac in (0.0, 0.3, 0.9)]
    cases.append((*PEND_CAPACITY, None))
    cases.append(PEND_CLI)
    # the shapes the run-tier and long-read phases (10-12) give kernel B
    cases += [(*c, None) for c in (PEND_RUNS, PEND_DEEP, PEND_LONG,
                                   PEND_LONG_RUNS)]
    cases.append(PEND_SHARDED)  # one rank of the sharded engine (phase 13)
    cases.append((*PEND_SCALE14, None))  # phase 14's scale_run
    cases.append((*PEND_SHAPE, 0.0, 0))  # no active lane: p_after = 0
    out = {}
    for pcap, m, nmax, frac, a in cases:
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
        idle = a == 0
        a = min(m, pcap - pfill) if a is None else a
        active = torch.arange(m, device=dev) < a
        gX = torch.sort(torch.randint(0, nmax, (m,), generator=gen,
                                      device=dev)).values
        stream = torch.where(active, torch.arange(m, device=dev), 0)
        sym = torch.randint(0, 6, (m,), generator=gen, device=dev)
        lanes = (gX, sym, stream, active)
        args = (pend.vp, pend.psym, *new_rows(pend, *lanes))
        # the engine's bound of the live rows, and what it launches
        bound = min(pcap, pfill + m)
        ncta = pending_cuda.n_blocks(pcap, bound)
        hi = min(pcap, ncta * pending_cuda.BS)
        # both versions write into planes of other values than INF/PAD:
        # whatever lies past the launched CTAs must come back untouched
        junk = (torch.randint(0, 1 << 40, (pcap,), generator=gen, device=dev),
                torch.randint(0, 6, (pcap,), generator=gen, device=dev,
                              dtype=torch.int8))
        planes = tuple(x.clone() for x in junk)
        got = pending_cuda.merge(*args, planes, bound)
        torch.cuda.synchronize()
        ref = merge_rows(*args, tuple(x.clone() for x in junk), bound)
        err = max(max_abs_diff(g, r) for g, r in zip(got, ref))
        err = max(err, max_abs_diff(got[0][hi:], junk[0][hi:]),
                  max_abs_diff(got[1][hi:], junk[1][hi:]),
                  int(got[2][hi // KP:].abs().max()) if hi < pcap else 0,
                  abs(int(args[-1]) - pfill - a))
        ms = time_ms(lambda: pending_cuda.merge(*args, planes, bound))
        plain_ms = time_ms(lambda: merge_rows(*args, planes, bound))
        rows_ms = time_ms(lambda: new_rows(pend, *lanes))
        rows = got[2].new_empty((-(-pcap // pending_cuda.BS) * 32, 6))
        kt = _timing.graph_ms(lambda: pending_cuda.run_kernel(
            *args, *planes, rows, ncta))
        profiled = kernel_ms(lambda: pending_cuda.merge(*args, planes, bound),
                             "pending_kernel")
        bound_ms = _timing.bound_ms(_timing.pending_bytes(pcap, pfill + a, a))
        label = "no active lane" if idle else f"{int(frac * 100)}% full"
        say(f"[3] pending {label}: pcap {pcap} M {m} active {a} p_after "
            f"{pfill + a} max_abs_err {err} (tolerance 0, all {pcap} rows; "
            f"rows past the launched CTAs untouched) CTAs launched {ncta} of "
            f"{-(-pcap // pending_cuda.BS)} wrapper {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms kernel alone (kernel) {kt:.4f} ms (profiler "
            f"{fmt_ms(profiled)}; the scalar kernel "
            f"{fmt_ms(EARLIER_MS.get((pcap, frac)) if not idle else None)}), "
            f"wrapper less kernel {ms - kt:.4f} ms, new_rows {rows_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms, share {bound_ms / kt:.3f}")
        if err != 0:
            raise AssertionError(f"pending kernel disagrees ({label})")
        if not idle:
            out[(pcap, m, frac)] = {
                "err": err, "wrapper_ms": ms, "plain_ms": plain_ms, "ms": kt,
                "ms_of": "kernel", "profiled_ms": profiled,
                "new_rows_ms": rows_ms, "bound_ms": bound_ms,
                "ctas_launched": ncta}
        del pend, vp, psym, args, got, ref, junk, planes, rows
        torch.cuda.empty_cache()
    pcap, m, nmax = PEND_SHAPE
    err, grids = pending_chain(torch, gen, pcap, m, nmax)
    say(f"[3] pending chained: pcap {pcap} M {m}, {PEND_CHAIN} rounds, a "
        f"reset, {PEND_CHAIN} more through pending_add against the plain "
        f"version round by round (every row, the prefix table, p): "
        f"max_abs_err {err} (tolerance 0); CTAs launched per round {grids} "
        f"of {-(-pcap // 4096)}")
    if err != 0:
        raise AssertionError("chained pending rounds disagree")
    out[(pcap, m, 0.3)]["err"] = max(out[(pcap, m, 0.3)]["err"], err)
    return out


# --------------------------------------------------------------- phase 3r

def rank_case(torch, label, kernel, plain, nbytes, extra=None, tag="[3r]",
              earlier_ms=None, variants=()):
    """Hold a rank kernel's call to its plain version (every output exact)
    and time both: the kernel's launch alone in a CUDA graph, the plain
    version with CUDA events; the bound is ``nbytes`` over the card's
    memory rate.  ``earlier_ms``: the earlier design's time (EARLIER_MS),
    printed beside where given.  ``variants``: (name, fn, holds) of launches timed in
    a CUDA graph beside the kernel (--rank-variants) and, where ``holds``,
    held to the plain version too.  Returns the case's record."""
    from ropebwt2_tpu_torch.probes import _timing

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max(max_abs_diff(g, w) for g, w in zip(got, want))
    times = {}
    for name, fn, holds in variants:
        if holds:
            out = fn()
            out = (out,) if isinstance(out, torch.Tensor) else out
            verr = max(max_abs_diff(g, w) for g, w in zip(out, want))
            if verr != 0:
                raise AssertionError(f"{name} disagrees ({label})")
        times[name] = _timing.graph_ms(fn)
    ms = _timing.graph_ms(kernel)
    plain_ms = time_ms(plain)
    bound_ms = _timing.bound_ms(nbytes)
    say(f"{tag} {label}: max_abs_err {err} (tolerance 0) kernel {ms:.4f} ms "
        + ("" if earlier_ms is None else
           f"(earlier design {earlier_ms:.4f} ms) ")
        + f"plain {plain_ms:.4f} ms "
        f"bound {bound_ms:.4f} ms ({nbytes} B read once and written once), "
        f"share {bound_ms / ms:.3f}"
        + "".join(f", {k} {v}" for k, v in (extra or {}).items())
        + "".join(f"; {k} {v:.4f} ms (share {bound_ms / v:.3f})"
                  for k, v in times.items()))
    if err != 0:
        raise AssertionError(f"rank kernel disagrees ({label})")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bytes": nbytes, "library_ms": None, "variants": times,
            **(extra or {})}


def rank_flat_input(torch, gen, cap, wide, ordered, q):
    """(bwt, tables, n, pos): a flat buffer of cap symbols (any byte past
    n), its K = 128 tables, and q positions in [0, n]."""
    from ropebwt2_tpu_torch.index.flat import PAD_TAIL
    from ropebwt2_tpu_torch.index.rank import build_block_tables

    n = cap - 12345
    bwt = torch.randint(-128, 128, (cap + PAD_TAIL,), generator=gen,
                        device=DEV, dtype=torch.int8)
    bwt[:n] = torch.randint(0, 6, (n,), generator=gen, device=DEV,
                            dtype=torch.int8)
    tab = build_block_tables(bwt, 128, torch.int64 if wide else torch.int32)
    pos = torch.randint(0, n + 1, (q,), generator=gen, device=DEV)
    if ordered:
        pos = torch.sort(pos).values
    return bwt, tab, n, pos


def rank_pend_input(torch, gen, pcap, nmax, frac, q):
    """(pending index, g): pcap rows, a share ``frac`` of them live below
    nmax + their count, and q sorted queries in that range."""
    from ropebwt2_tpu_torch.index.pending import INF, KP, PendingIndex
    from ropebwt2_tpu_torch.index.rank import build_block_tables

    pfill = int(pcap * frac)
    vp = torch.full((pcap,), INF, dtype=torch.int64, device=DEV)
    vp[:pfill] = torch.sort(torch.randint(
        0, nmax - pfill, (pfill,), generator=gen, device=DEV
    )).values + torch.arange(pfill, device=DEV)
    psym = torch.full((pcap,), 6, dtype=torch.int8, device=DEV)
    psym[:pfill] = torch.randint(0, 6, (pfill,), generator=gen,
                                 device=DEV, dtype=torch.int8)
    pi = PendingIndex(
        vp=vp, psym=psym,
        blk_prefix=build_block_tables(psym, KP, dtype=torch.int32),
        p=torch.tensor(pfill, dtype=torch.int64, device=DEV))
    g = torch.sort(torch.randint(0, nmax + pfill, (q,), generator=gen,
                                 device=DEV)).values
    return pi, g


def bound_label(ctas):
    """The name of a packed kernel variant under other launch bounds."""
    return ("this design under __launch_bounds__(64) alone" if ctas == 0
            else f"this design for {ctas} CTAs an SM")


def rank_packed_input(torch, gen, cap):
    """(pbwt, blkA, blkB, n): a packed buffer of cap symbols (random
    symbols below n, PAD past it and in the tail rows, as the engine keeps
    it) and its two-level tables, built on the card."""
    from ropebwt2_tpu_torch.index.flat import PAD
    from ropebwt2_tpu_torch.index.packed import (
        PPAD_ROWS, build_two_level_tables, pack_bwt,
    )

    n = cap - 12345
    sym = torch.full((cap + PPAD_ROWS * 256,), PAD, dtype=torch.int8,
                     device=DEV)
    for lo in range(0, n, 1 << 30):  # in chunks below 2^31 elements
        hi = min(n, lo + (1 << 30))
        sym[lo:hi] = torch.randint(0, 6, (hi - lo,), generator=gen,
                                   device=DEV, dtype=torch.int8)
    pb = pack_bwt(sym)
    del sym
    return (pb, *build_two_level_tables(pb, cap), n)


def phase_rank(torch, variants=False):
    """The rank kernels against their plain versions at RANK_FLAT's,
    RANK_PEND's, RANK_VIRTUAL's, RANK_PACKED's and RANK_VIRTUAL_PACKED's
    shapes, each beside the earlier design's time (EARLIER_MS).  With
    ``variants`` (--rank-variants), also the earlier design's launches
    (probes/rank_variants.py) timed in the same call: the flat rank as it
    was, with K a constant and without the count; the packed rank as it
    was; the pending rank; the deferred round's launches that each virtual
    rank replaces; this design's parts: the flat and the packed rank's
    loads without the count, the pending rank's search alone and its
    count alone; and the packed kernels under other launch bounds."""
    from ropebwt2_tpu_torch.index import rank_cuda
    from ropebwt2_tpu_torch.index.flat import PAD_TAIL
    from ropebwt2_tpu_torch.index.packed import rank_global_packed
    from ropebwt2_tpu_torch.index.pending import (
        pending_rank, rank_virtual, rank_virtual_packed,
    )
    from ropebwt2_tpu_torch.index.rank import rank_global
    from ropebwt2_tpu_torch.probes import _timing, rank_variants as var

    gen = torch.Generator(device=DEV).manual_seed(31)
    flat, pend, virt = {}, {}, {}
    bases = {}
    for name, cap, wide, ordered, q in RANK_FLAT:
        bwt, tab, n, pos = rank_flat_input(torch, gen, cap, wide, ordered, q)
        runs = []
        if variants:
            modes = (0, 1, 2) if name == "sustained" else (0,)
            runs = [(f"earlier mode {m}",
                     lambda m=m: var.flat(m, bwt, tab, pos, 128), m != 2)
                    for m in modes]
            if not wide:
                runs.append(("this design's loads without the count",
                             lambda: var.part_flat(bwt, tab, pos), False))
        flat[name] = rank_case(
            torch, f"flat {name}: cap {cap}, {q} "
                   f"{'sorted' if ordered else 'uniform'} positions, "
                   f"{str(tab.dtype)[6:]} tables",
            lambda: rank_cuda.rank_flat(bwt, tab, pos, 128),
            lambda: rank_global(bwt, tab, pos, 128),
            _timing.rank_flat_bytes(pos, 128, tab.element_size(),
                                    bwt.shape[0] // 128, tab.shape[0]),
            earlier_ms=EARLIER_MS.get(("rank_flat", name)), variants=runs)
        if any(name == b for _, b, _, _ in RANK_VIRTUAL):
            bases[name] = (bwt, tab, n)
        del bwt, tab, pos
        torch.cuda.empty_cache()
    pends = {}
    for name, pcap, nmax, frac, q in RANK_PEND:
        pi, g = rank_pend_input(torch, gen, pcap, nmax, frac, q)
        p, _ = pending_rank(pi, g)
        runs = [("earlier", lambda: var.pend(pi, g), True),
                ("this design's search alone",
                 lambda: var.part_pend(False, pi, g), False),
                ("this design's count alone (p given)",
                 lambda: var.part_pend(True, pi, g, p), True)]
        pend[name] = rank_case(
            torch, f"pending {name}: pcap {pcap}, {int(100 * frac)}% full, "
                   f"{q} sorted queries",
            lambda: rank_cuda.pending_rank(pi, g),
            lambda: pending_rank(pi, g), _timing.rank_pend_bytes(g, p),
            {"searchsorted_ms": time_ms(lambda: torch.searchsorted(pi.vp, g))},
            earlier_ms=EARLIER_MS.get(("rank_pend", name)),
            variants=runs if variants else ())
        if any(name == pn for _, _, pn, _ in RANK_VIRTUAL
               + RANK_VIRTUAL_PACKED):
            pends[name] = (pi, g, pcap, frac)
        del p
        torch.cuda.empty_cache()
    for name, bname, pname, clamp in RANK_VIRTUAL:
        bwt, tab, n = bases[bname]
        pi, g, pcap, frac = pends[pname]
        lo, hi = clamp or (None, None)
        # the engine's queries: [0, n + pending] unclamped; the sharded
        # engine's [0, lcap + pcap] in its window
        gv = g.clamp(0, hi + pcap) if clamp else g.clamp(
            max=n + int(pcap * frac))
        pv, _ = pending_rank(pi, gv)
        x = gv - pv if clamp is None else (gv - pv).clamp(lo, hi)
        nb = _timing.rank_virtual_bytes(gv, pv, x, 128, tab.element_size(),
                                        bwt.shape[0] // 128, tab.shape[0])

        def earlier_launches(gv=gv, lo=lo, hi=hi):
            # the earlier deferred rank: the pending kernel, then the flat
            # kernel at g - p plus the pending counts (the sharded engine
            # clamped g - p in torch between them)
            p0, e = var.pend(pi, gv)
            if lo is None:
                return var.flat(0, bwt, tab, gv, 128, p0, e)
            return var.flat(0, bwt, tab, (gv - p0).clamp(lo, hi), 128,
                            extra=e)

        clamped = {} if clamp is None else {
            "clamped": int(((gv - pv) != x).sum())}
        virt[name] = rank_case(
            torch, f"virtual {name} (one launch: the pending search and "
                   f"count and the flat count at g - p"
                   f"{'' if clamp is None else f' clamped to {list(clamp)}'}"
                   f"): cap {bwt.shape[0] - PAD_TAIL}, pcap {pcap} "
                   f"{int(100 * frac)}% full, {gv.shape[0]} sorted queries",
            lambda: rank_cuda.rank_virtual_flat(bwt, tab, pi, gv, 128,
                                                lo=lo, hi=hi),
            lambda: rank_virtual(bwt, tab, pi, gv, 128, lo, hi), nb,
            clamped, earlier_ms=EARLIER_MS.get(("rank_virtual", name)),
            variants=[("earlier launches", earlier_launches, True)]
            if variants else ())
        del pv, x
    del bases
    torch.cuda.empty_cache()

    pk, vpk = {}, {}
    pbases = {cap: rank_packed_input(torch, gen, cap)
              for cap in dict.fromkeys(c for _, c, _, _ in RANK_PACKED)}
    for name, cap, ordered, q in RANK_PACKED:
        pb, blkA, blkB, n = pbases[cap]
        pos = torch.randint(0, n + 1, (q,), generator=gen, device=DEV)
        if ordered:
            pos = torch.sort(pos).values
        runs = [("earlier", lambda: var.packed(pb, blkA, blkB, pos), True),
                ("this design's loads without the count",
                 lambda: var.part_packed(pb, blkA, blkB, pos), False)]
        if name in ("capacity", "sustained"):
            runs += [(bound_label(c),
                      lambda c=c: var.bound_packed(c, pb, blkA, blkB, pos),
                      True) for c in var.BOUND_CTAS]
        pk[name] = rank_case(
            torch, f"packed {name}: cap {cap}, n {n}, {q} "
                   f"{'sorted' if ordered else 'uniform'} positions",
            lambda: rank_cuda.rank_packed(pb, blkA, blkB, pos),
            lambda: rank_global_packed(pb, blkA, blkB, pos),
            _timing.rank_packed_bytes(pos, blkB.shape[0] // 2 - 1),
            earlier_ms=EARLIER_MS.get(("rank_packed", name)),
            variants=runs if variants else ())
        del pos
    for name, cap, pname, ordered in RANK_VIRTUAL_PACKED:
        pb, blkA, blkB, n = pbases[cap]
        pi, g, pcap, frac = pends[pname]
        # the engine's queries: [0, n + pending]
        gv = g.clamp(max=n + int(pcap * frac))
        if not ordered:
            gv = gv[torch.randperm(gv.shape[0], generator=gen, device=DEV)]
        pv, _ = pending_rank(pi, gv)
        nb = _timing.rank_virtual_packed_bytes(gv, pv, gv - pv,
                                               blkB.shape[0] // 2 - 1)

        def earlier_launches(gv=gv):
            # the earlier deferred rank: the pending kernel, then the
            # earlier packed kernel at g - p plus the pending counts
            p0, e = rank_cuda.pending_rank(pi, gv)
            return var.packed(pb, blkA, blkB, gv, p0, e)

        runs = [("earlier launches", earlier_launches, True)]
        if name in ("capacity", "sustained"):
            runs += [(bound_label(c), lambda c=c: var.bound_virtual_packed(
                c, pb, blkA, blkB, pi, gv), True) for c in var.BOUND_CTAS]
        vpk[name] = rank_case(
            torch, f"virtual packed {name} (one launch: the pending search "
                   f"and count and the packed count at g - p): cap {cap}, "
                   f"n {n}, pcap {pcap} {int(100 * frac)}% full, "
                   f"{gv.shape[0]} {'sorted' if ordered else 'uniform'} "
                   f"queries",
            lambda: rank_cuda.rank_virtual_packed(pb, blkA, blkB, pi, gv),
            lambda: rank_virtual_packed(pb, blkA, blkB, pi, gv), nb,
            earlier_ms=EARLIER_MS.get(("rank_virtual_packed", name)),
            variants=runs if variants else ())
        del pv, gv
    del pbases, pends
    torch.cuda.empty_cache()
    return {"rank_flat": flat, "rank_pend": pend, "rank_virtual": virt,
            "rank_packed": pk, "rank_virtual_packed": vpk}


def rank_issue(torch):
    """Each rank kernel's SASS instructions (cuobjdump) and the least time
    its warps take to issue them at RANK_Q queries, at the card's top SM
    clock: the issue-slot floor beside the bytes bound (--rank-variants)."""
    from ropebwt2_tpu_torch import _build
    from ropebwt2_tpu_torch.probes import rank_variants as var

    # the path's kernels from the main library, the earlier design's and
    # this design's parts from the probe library
    sass = {k: v for k, v in var.sass_counts(
        _build.library_path("main")).items() if k.startswith("rank_")}
    sass.update({k: v for k, v in var.sass_counts(
        _build.library_path("probes")).items() if k.startswith("rankvar_")})
    try:
        clock = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0])
    except (OSError, subprocess.CalledProcessError, ValueError, IndexError):
        return {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for kernel, qpw in (  # queries a warp
            ("rank_flat_kernelIiLi1E", 32), ("rank_flat_kernelIlLi1E", 32),
            ("rank_pend_kernel", 32), ("rank_virtual_kernelIiLi1E", 32),
            ("rank_packed_kernel", 32), ("rank_virtual_packed_kernel", 32),
            ("rankvar_flat_kernelIiLi0E", 4), ("rankvar_flat_kernelIiLi1E", 4),
            ("rankvar_flat_kernelIiLi2E", 4), ("rankvar_packed_kernel", 4),
            ("rankvar_pend_kernel", 32)):
        if kernel in sass:
            floor = var.issue_floor_ms(sass[kernel], RANK_Q // qpw, sms,
                                       clock)
            out[kernel] = {"sass": sass[kernel], "issue_floor_ms": floor}
            say(f"[3r] issue: {kernel}: {sass[kernel]} SASS instructions, "
                f"{qpw} queries a warp: at {RANK_Q} queries {floor:.4f} ms "
                f"to issue them on {sms} SMs x 4 schedulers at {clock} MHz")
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
            # the CPU reference is the flat build alone: the packed build
            # on the card is held against the flat one on the card
            for device, pack4 in ((DEV, 0), (DEV, 1), ("cpu", 0)):
                eng = TorchBwt(so=so, defer_r=defer_r, device=device,
                               pack4=pack4)
                for bt in batches:
                    eng.insert_multi(bt)
                arrs[device, pack4] = eng.bwt_array()
            same = np.array_equal(arrs[DEV, 0], arrs["cpu", 0])
            walk = lf_strings(arrs[DEV, 0], nreads) == want
            pflat = np.array_equal(arrs[DEV, 1], arrs[DEV, 0])
            pwalk = lf_strings(arrs[DEV, 1], nreads) == want
            say(f"[4] so {so} defer_r {defer_r}: cuda == cpu {same}, "
                f"LF walk spells the reads {walk}; packed: == flat on the "
                f"card {pflat}, LF walk {pwalk}")
            if not (same and walk and pflat and pwalk):
                raise AssertionError(f"small build failed (so {so}, "
                                     f"defer_r {defer_r})")


# ---------------------------------------------------------------- phase 5

def report_profile(label, wall, rows, top=12, tag="[5]"):
    """Print a profiled batch's device busy time, idle share and top
    kernels; the whole table goes to smoke_out/."""
    busy = sum(r[1] for r in rows) / 1e6
    say(f"{tag} profile {label}: wall {wall:.4f} s (profiled), device busy "
        f"{busy:.4f} s, idle share {1 - busy / wall:.3f}")
    kinds = by_kind(rows)
    say(f"{tag} profile {label}, device time by kind: " + ", ".join(
        f"{k} {100 * us / 1e6 / busy:.1f}%" for k, us in kinds))
    for name, us, calls in rows[:top]:
        say(f"{tag}   {us / 1e3:10.3f} ms {100 * us / 1e6 / busy:5.1f}% "
            f"{calls:7d}x {name[:90]}")
    for kernel in ("merge_kernel", "pending_kernel", "merge_packed_kernel",
                   "rank_flat_kernel", "rank_packed_kernel",
                   "rank_pend_kernel", "rank_virtual_kernel",
                   "rank_virtual_packed_kernel"):
        for name, us, calls in rows:  # the hand-written kernels, wherever
            if kernel in name:        # they rank
                say(f"{tag}   {kernel}: {us / 1e3:.3f} ms, "
                    f"{100 * us / 1e6 / busy:.2f}% of device time, {calls} "
                    f"launches, {us / 1e3 / calls:.4f} ms each")
    out = os.path.join(HERE, "smoke_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"profile_{label.split()[0]}.txt"), "w") as f:
        for name, us, calls in rows:
            f.write(f"{us:.1f}\t{calls}\t{name}\n")


KINDS = (  # kind of a profiled kernel, by the first match in its name
    ("kernels A, B, C", ("merge_kernel", "pending_kernel",
                         "merge_packed_kernel")),
    ("rank kernels", ("rank_flat_kernel", "rank_packed_kernel",
                      "rank_pend_kernel", "rank_virtual_kernel",
                      "rank_virtual_packed_kernel")),
    ("searchsorted", ("searchsorted",)),
    ("bucket sort", ("sort", "radix", "Sort")),
    ("scans", ("scan", "cumsum", "cummax", "cummin", "Scan")),
    ("gathers, scatters, index_add_", ("index", "gather", "scatter",
                                       "Index", "Gather", "Scatter")),
    ("copies and cat", ("copy", "Copy", "cat", "Cat", "memcpy", "Memcpy",
                        "memset", "Memset", "fill")),
    ("sum reductions", ("reduce", "Reduce", "sum")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized",
                     "unrolled")),
)


def by_kind(rows):
    """[(kind, device us)] of a profile's rows, largest first."""
    tot = {}
    for name, us, _ in rows:
        kind = next((k for k, keys in KINDS if any(x in name for x in keys)),
                    "other")
        tot[kind] = tot.get(kind, 0.0) + us
    return sorted(tot.items(), key=lambda kv: -kv[1])


def phase_main(torch):
    """bench.py's two regimes through the port's bench stage functions
    (ropebwt2_tpu_torch/bench.py): the batch regime twice, the last run's
    launches read; the sustained regime, its last prefill batch profiled
    and its timed batches' launches read; the sustained regime again on
    the packed tier, held to the flat BWT by md5."""
    from ropebwt2_tpu_torch import bench
    from ropebwt2_tpu_torch.scripts.common import timed_insert
    from ropebwt2_tpu_torch.scripts.scale_run import text_md5

    cfg = bench.Config(M=M_BENCH, L=L_BENCH, so=1, K=128, prefill_x=PREFILL,
                       sustain_runs=SUSTAIN)
    gen = bench.reads_gen(cfg)
    reads = gen.batch(M_BENCH).view(np.int8)
    syms = cfg.syms
    sustained_batches = [gen.batch(M_BENCH).view(np.int8)
                         for _ in range(PREFILL + SUSTAIN)]
    done = PREFILL + SUSTAIN

    torch.cuda.reset_peak_memory_stats()
    batch_walls = []
    for _ in range(2):  # the first run includes PyTorch's lazy set-up
        reset_launches()  # the batch path: the last run's launches
        batch_walls.append(bench.batch_run(cfg, reads, DEV))
    batch_launches = read_launches()
    wall, rows = profile(
        lambda: bench.new_engine(cfg, DEV).insert_multi(reads))
    report_profile("batch", wall, rows)

    eng = bench.sustained_engine(cfg, DEV)
    defer_r, pcap = eng._choose_defer(M_BENCH)
    prefill_s = bench.prefill(eng, sustained_batches[:PREFILL - 1])
    # the last prefill batch runs under the profiler: where the time goes
    wall, rows = profile(lambda: eng.insert_multi(
        sustained_batches[PREFILL - 1]))
    report_profile("sustained (prefill batch 8)", wall, rows)
    reset_launches()  # the sustained path: the timed batches
    walls = [timed_insert(eng, bt)[0]
             for bt in sustained_batches[PREFILL:]]
    launches = read_launches()
    bench.check_counts(eng.counts(), M_BENCH * done, syms * done)
    peak = torch.cuda.max_memory_allocated()

    say(f"[5] batch regime (bench.batch_run): {syms} symbols into an empty "
        f"index, walls {[round(w, 4) for w in batch_walls]} s, "
        f"{syms / min(batch_walls) / 1e6:.3f} Msym/s (best), launches "
        f"{launched(batch_launches)}")
    say(f"[5] sustained regime (bench.sustained_engine, prefill, "
        f"timed_insert): cap {eng.state.cap} R {defer_r} pcap {pcap}, "
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
    deferred_flat("[5] sustained:", launches)
    if launches["rank_flat"] != 0:
        raise AssertionError(f"[5] the deferred path ran rank_flat: "
                             f"{launches}")

    # the sustained regime again on the packed tier: the same BWT
    flat_md5 = text_md5(eng)
    kept = {"flat": to_host(eng)}  # phase 8 queries the two indexes
    del eng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = bench.sustained_engine(cfg, DEV, pack4=1)
    p_defer, p_pcap = eng._choose_defer(M_BENCH)
    p_prefill_s = bench.prefill(eng, sustained_batches[:PREFILL])
    reset_launches()  # the packed sustained path: the timed batches
    p_walls = [timed_insert(eng, bt)[0]
               for bt in sustained_batches[PREFILL:]]
    p_launches = read_launches()
    bench.check_counts(eng.counts(), M_BENCH * done, syms * done)
    p_peak = torch.cuda.max_memory_allocated()
    packed_md5 = text_md5(eng)
    p_cap = eng.state.cap
    kept["packed"] = to_host(eng)
    kept["reads"] = sustained_batches[0][:QUERY_CHECKS]
    kept["md5"] = flat_md5  # phases 10 and 13 hold their builds to it
    kept["sustained_rate"] = syms / min(walls) / 1e6
    kept["batch_rate"] = syms / min(batch_walls) / 1e6
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
    if any(p_launches[k] == 0 for k in ("merge_packed", "pending_merge")):
        raise AssertionError(f"a kernel never launched: {p_launches}")
    deferred_packed("[5] packed sustained:", p_launches)
    if batch_launches["merge"] == 0 or batch_launches["rank_flat"] == 0:
        raise AssertionError(f"a kernel never launched: {batch_launches}")
    return {"batch": (batch_launches, 1), "sustained": (launches, SUSTAIN),
            "sustained_packed": (p_launches, SUSTAIN)}, kept


def to_host(eng):
    """(state with every tensor on the host, n) of an engine: phase 8 moves
    it back, so that the indexes take no device memory meanwhile."""
    import dataclasses

    st = eng.state
    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).cpu() for f in dataclasses.fields(st)
    }), eng.n


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


def lf_walk(torch, rank, counts, rows, steps):
    """LF walks on the card from ``rows`` of an index, with its rank
    (rank(pos) -> (W, 6)): the (W, steps) int8 symbols read, 0 once a walk
    has reached its string's sentinel."""
    C = torch.cumsum(counts, 0) - counts
    live = torch.ones_like(rows, dtype=torch.bool)
    out = []
    for _ in range(steps):
        r0 = rank(rows)
        s = (rank(rows + 1) - r0).argmax(dim=1)
        live &= s != 0
        out.append(torch.where(live, s, 0).to(torch.int8))
        rows = torch.where(live, C[s] + r0.gather(1, s[:, None])[:, 0], rows)
    return torch.stack(out, dim=1)


def phase_capacity(torch, ReadGen):
    """scripts/scale_run.py's build through the port's scale_run
    (TorchBwt.plan, batches drawn on a host thread, insert_batch with its
    counts after every batch, text_md5 a chunk at a time), at the cut size
    below, with the packed tier's checks."""
    from ropebwt2_tpu_torch.engine import TorchBwt
    from ropebwt2_tpu_torch.index.packed import (
        ACHUNK, PackedFlatBwt, rank_global_packed, unpack_bwt,
    )
    from ropebwt2_tpu_torch.index import rank_cuda
    from ropebwt2_tpu_torch.index.rank import build_block_tables, rank_global
    from ropebwt2_tpu_torch.probes import _timing
    from ropebwt2_tpu_torch.scripts import scale_run

    mb, nbatch, L = SCALE_MBATCH, SCALE_BATCHES, L_BENCH
    nreads = mb * nbatch
    total = nreads * (L + 1)
    say(f"[6] cut: SCALE4G_r04.json's 39,321,600 reads x {L} "
        f"(4,010,803,200 symbols) cut to {nbatch} batches of {mb} reads: "
        f"{nreads} reads, {total} symbols, to stay inside the time limit")
    gen = ReadGen(seed=0, nreads=nreads, L=L, mode="coverage", cov=47.0,
                  err=0.01)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = TorchBwt(so=1, K=128, device=DEV)  # pack4="auto"
    eng.plan(total)
    defer_r, pcap = eng._choose_defer(mb)
    say(f"[6] plan: {type(eng.state).__name__} cap {eng.state.cap} R "
        f"{defer_r} pcap {pcap}")
    if not isinstance(eng.state, PackedFlatBwt) or eng.state.cap != CAP_SCALE:
        raise AssertionError("the capacity plan is not packed at CAP_SCALE")
    hashes, walls, gen_s = [], [], 0.0
    reset_launches()
    t_all = time.perf_counter()
    # scale_run.batches draws the next batch on a host thread meanwhile
    for i, (bt, g) in enumerate(scale_run.batches(gen, nreads, mb)):
        gen_s += g
        hashes.append(read_hashes(bt[:, ::-1]))  # the reads as walked
        if i == nbatch - 1:  # the last batch: where the time goes
            wall, rows = profile(
                lambda: scale_run.insert_batch(eng, bt, i * mb, L))
            report_profile(f"capacity batch {i + 1}", wall, rows, tag="[6]")
        else:
            wall, _ = scale_run.insert_batch(eng, bt, i * mb, L)
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
    tables = build_block_tables(flat_bwt, 128)
    want = rank_global(flat_bwt, tables, pos, 128)
    rank_err = max(
        max_abs_diff(rank_cuda.rank_flat(flat_bwt, tables, pos, 128), want),
        max_abs_diff(rank_cuda.rank_packed(st.pbwt, st.blkA, st.blkB, pos),
                     want),
        max_abs_diff(rank_global_packed(st.pbwt, st.blkA, st.blkB, pos),
                     want))
    del flat_bwt, tables, want
    torch.cuda.empty_cache()
    say(f"[6] rank: the packed rank kernel and its plain version, and the "
        f"flat rank kernel over the unpacked int8 copy with int64 tables, "
        f"== the plain flat rank with int64 tables at {pos.numel()} "
        f"positions ({anchors.numel()} anchor boundaries +-1, "
        f"{int((pos >= 1 << 31).sum())} at or past 2^31): max_abs_err "
        f"{rank_err} (tolerance 0)")
    qpos = torch.sort(torch.randint(0, n + 1, (RANK_Q,), generator=g,
                                    device=DEV)).values
    rank_res = {"phase 6": rank_case(
        torch, f"packed capacity (phase 6's index): cap {st.cap}, n {n}, "
               f"{RANK_Q} sorted positions", lambda: rank_cuda.rank_packed(
                   st.pbwt, st.blkA, st.blkB, qpos),
        lambda: rank_global_packed(st.pbwt, st.blkA, st.blkB, qpos),
        _timing.rank_packed_bytes(qpos, st.blkB.shape[0] // 2 - 1),
        tag="[6]", earlier_ms=EARLIER_MS.get(("rank_packed", "phase 6")))}
    del qpos

    # LF walks from sentinel rows spell reads of the input
    spelled = lf_walk(
        torch, lambda p: rank_cuda.rank_packed(st.pbwt, st.blkA, st.blkB, p),
        torch.from_numpy(eng.counts()).to(DEV),
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
    md5 = scale_run.text_md5(eng)
    say(f"[6] bwt md5 {md5} (scale_run.text_md5, chunk by chunk; no "
        f"phantom read; {time.perf_counter() - tm:.3f} s incl. transfer)")
    del eng, st
    torch.cuda.empty_cache()
    if n <= 1 << 31 or rank_err != 0 or not shaped or found != SCALE_WALKS:
        raise AssertionError("the capacity phase failed its checks")
    if any(launches[k] == 0 for k in ("merge_packed", "pending_merge")):
        raise AssertionError(f"a kernel never launched: {launches}")
    deferred_packed("[6] capacity:", launches)
    return {"capacity": (launches, nbatch)}, rank_res


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


# ---------------------------------------------------------------- phase 8

def numpy_rank(bwt, pos):
    """occ[q, s] = # of s in bwt[:pos[q]] for sorted pos, by numpy counts
    over the segments between consecutive positions."""
    occ = np.zeros((pos.size, 6), np.int64)
    run = np.zeros(6, np.int64)
    prev = 0
    for i, p in enumerate(pos):
        run += np.bincount(bwt[prev:p], minlength=6)[:6]
        occ[i] = run
        prev = p
    return occ


def extend_chain(torch, query, st, pats):
    """Sizes of the patterns' SA intervals by chained backward extends from
    the whole-index bi-interval, one symbol at a time from the last."""
    q, ln = pats.shape
    n = int(st.n)
    ik = torch.tensor([[0, 0, n]], device=pats.device).expand(q, 3)
    rows = torch.arange(q, device=pats.device)
    for col in range(ln - 1, -1, -1):
        ik = query.extend(st, ik, is_back=True)[rows, pats[:, col]]
    return ik[:, 2]


def phase_queries(torch, kept, smi):
    """bench.py's query stages through the port's bench (query_inputs from
    default_rng(1) in the JAX bench's order; stage_rank, stage_extend,
    stage_bsearch over engine/query.py) on the flat and the packed index
    of phase 5's sustained regime; rank held against numpy counts over the
    host copy of the BWT, backward search against chained extends, the
    tiers against each other.  Each tier's three timed stages are a path
    whose launches are read (its rank kernel must launch); returns
    {path: (launches, 1)}."""
    from ropebwt2_tpu_torch import bench
    from ropebwt2_tpu_torch.engine import query

    Q, iters = QUERY_RANK
    Qb, plen = QUERY_SEARCH
    if (iters, Qb, plen) != (bench.ITERS, Q // 4, bench.PLEN):
        raise AssertionError("phase 8's workloads are not the bench's")
    reads = kept["reads"]
    answers, paths = {}, {}
    for tier in ("flat", "packed"):
        host, n = kept[tier]
        st = type(host)(**{k: v.to(DEV) for k, v in vars(host).items()})
        qpos, starts, pats = bench.query_inputs(np.random.default_rng(1), n,
                                                Q)
        reset_launches()  # the query path: the three timed stages
        ranks, r_s = bench.stage_rank(st, n, qpos, DEV)
        exts, e_s = bench.stage_extend(st, n, starts, DEV)
        (blo, bhi), b_s = bench.stage_bsearch(st, pats, DEV)
        launches = read_launches()
        paths[f"queries_{tier}"] = (launches, 1)
        if launches[f"rank_{tier}"] == 0:
            raise AssertionError(f"[8] the {tier} queries did not launch "
                                 f"rank_{tier}: {launched(launches)}")
        r_rate, e_rate, b_rate = Q * iters / r_s, Q * iters / e_s, \
            Qb * plen / b_s
        say(f"[8] {tier} index, n {n}: rank {r_rate / 1e6:.3f} Mq/s "
            f"({Q} positions x {iters} chained steps, best {r_s:.4f} s); "
            f"extend {e_rate / 1e6:.3f} M ext/s ({Q} bi-intervals x {iters} "
            f"steps, best {e_s:.4f} s); backward_search {b_rate / 1e6:.3f} M "
            f"sym-steps/s ({Qb} patterns x {plen}, best {b_s:.4f} s); "
            f"launches {launched(launches)}; {smi}")

        # the checks
        cpos = np.sort(np.random.default_rng(8).integers(0, n + 1,
                                                         QUERY_CHECKS))
        occ = query.rank1a(st, cpos).cpu().numpy()
        bwt = (host.bwt[:n].numpy() if tier == "flat" else
               unpack_rows(host.pbwt, n))
        rank_ok = np.array_equal(occ, numpy_rank(bwt, cpos))
        starts = np.random.default_rng(9).integers(0, reads.shape[1] - plen,
                                                   reads.shape[0])
        sub = reads[np.arange(reads.shape[0])[:, None],
                    starts[:, None] + np.arange(plen)[None, :]]
        sub_t = torch.from_numpy(sub.astype(np.int64)).to(DEV)
        lo, hi = query.backward_search(st, sub_t, torch.full(
            (sub.shape[0],), plen, device=DEV))
        size = hi - lo
        chained = extend_chain(torch, query, st, sub_t)
        found = bool((size >= 1).all())
        chain_ok = torch.equal(size, chained)
        say(f"[8] {tier} checks: rank at {QUERY_CHECKS} sorted positions == "
            f"numpy counts over the host copy {rank_ok}; backward_search "
            f"of {sub.shape[0]} substrings ({plen} symbols) of the reads: "
            f"every one found {found} (sizes {int(size.min())}-"
            f"{int(size.max())}), == chained extend {chain_ok}")
        if not (rank_ok and found and chain_ok):
            raise AssertionError(f"phase 8 failed its checks ({tier})")
        answers[tier] = [ranks.cpu(), exts.cpu(), blo.cpu(), bhi.cpu(),
                         lo.cpu(), hi.cpu(), torch.from_numpy(occ)]
        del st
        torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(answers["flat"],
                                                 answers["packed"]))
    say(f"[8] flat and packed indexes give equal answers (rank chains, "
        f"extend chains, backward_search intervals, sampled ranks): {same}")
    if not same:
        raise AssertionError("the flat and packed queries disagree")
    return paths


def unpack_rows(pbwt, n):
    """int8[n] symbols of a host packed buffer."""
    from ropebwt2_tpu_torch.index.packed import unpack_bwt_np

    return unpack_bwt_np(pbwt[: -(-n // 256) * 128].numpy())[:n]


# ---------------------------------------------------------------- phase 9

def case_shape(name):
    """(cap, lanes, live n, active lanes) of a MERGE_CASES row; active is
    None where every lane is."""
    row = next(r for r in MERGE_CASES if r[0] == name)
    return row[1], row[2], row[3], row[5]


def write_fastq_gz(path, reads, first=0):
    """Reads (m, L) nt6 codes as gzip FASTQ, names @r<index>, quality I."""
    import gzip

    m, ln = reads.shape
    lut = np.frombuffer(b"$ACGTN", np.uint8)
    rec = np.empty((m, 10 + 2 * ln + 4), np.uint8)
    rec[:, 0:2] = np.frombuffer(b"@r", np.uint8)
    idx = np.arange(first, first + m)
    for k in range(7):
        rec[:, 8 - k] = 48 + (idx // 10 ** k) % 10
    rec[:, 9] = ord("\n")
    rec[:, 10:10 + ln] = lut[reads]
    rec[:, 10 + ln:13 + ln] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 13 + ln:13 + 2 * ln] = ord("I")
    rec[:, 13 + 2 * ln] = ord("\n")
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(rec.tobytes())


def revcomp_hashes(mat):
    """read_hashes of the reads and of their reverse complements."""
    rc = np.where((mat >= 1) & (mat <= 4), 5 - mat, mat)[:, ::-1]
    return np.concatenate([read_hashes(mat), read_hashes(rc)])


@contextlib.contextmanager
def engine_calls():
    """Record the engine's calls of kernel A's wrapper (flush or round,
    cap, lanes, live n, active lanes) and of pending_add (kernel B: pcap,
    lanes, rows pending before, active lanes), and its batches, by
    wrapping the engine's names for them.  The counts stay on the device
    until the caller reads them: the run is not made to wait."""
    from ropebwt2_tpu_torch.engine import bcr
    from ropebwt2_tpu_torch.index.flat import PAD_TAIL

    saved = bcr.merge, bcr.pending_add, bcr.bcr_batch
    log = {"batches": [], "merge": [], "pending": []}

    def batch(state, reads, buf, n_rounds, **kw):
        log["batches"].append(kw.get("defer_r", 0) > 0)
        return saved[2](state, reads, buf, n_rounds, **kw)

    def merge(bwt, pos, sym, stream, valid, n, K):
        log["merge"].append((log["batches"][-1], bwt.shape[0] - PAD_TAIL,
                             pos.shape[0], n, valid.sum()))
        return saved[0](bwt, pos, sym, stream, valid, n, K)

    def pending_add(pend, gX, sym, stream, active):
        log["pending"].append((pend.cap, gX.shape[0], pend.p, active.sum()))
        return saved[1](pend, gX, sym, stream, active)

    bcr.merge, bcr.pending_add, bcr.bcr_batch = merge, pending_add, batch
    try:
        yield log
    finally:
        bcr.merge, bcr.pending_add, bcr.bcr_batch = saved


def largest_calls(log):
    """The recorded calls of the largest live size: kernel A's round and
    flush as (cap, lanes, n, active), kernel B's as (pcap, lanes, rows
    pending, active); None where there was no such call."""
    def ints(rows):
        return [tuple(int(x) for x in r) for r in rows]

    merges = ints(r[1:] for r in log["merge"])
    flushes = [c for c, r in zip(merges, log["merge"]) if r[0]]
    rounds = [c for c, r in zip(merges, log["merge"]) if not r[0]]
    pend = ints(log["pending"])

    def top(calls):
        return max(calls, key=lambda c: c[2]) if calls else None

    return {"round": top(rounds), "flush": top(flushes), "pending": top(pend)}


def phase_cli(torch, ReadGen, smi):
    """The CLI end to end: a gzip FASTQ of 2^20 coverage reads x 101 through
    ``python -m ropebwt2_tpu_torch.cli -s -d`` in a child process, then
    in this process with -m 64m and text output (kernel launches counted);
    the FMD against the text BWT, an LF walk over it, and -b then -i plus
    a second file against a one-shot build of both."""
    from ropebwt2_tpu_torch import cli
    from ropebwt2_tpu_torch.engine import query
    from ropebwt2_tpu_torch.io.fmd import FmdReader
    from ropebwt2_tpu_torch.native import lib as nlib

    if not nlib.native_available():
        raise AssertionError(f"the native host runtime did not build: "
                             f"{nlib.BUILD_ERROR}")
    out = os.path.join(HERE, "smoke_out")
    os.makedirs(out, exist_ok=True)
    m, L = CLI_READS, L_BENCH
    t0 = time.perf_counter()
    gen = ReadGen(seed=0, nreads=m, L=L, mode="coverage", cov=47.0,
                  err=0.01)
    reads = gen.batch(m)
    fq = os.path.join(out, "reads.fq.gz")
    write_fastq_gz(fq, reads)
    total = 2 * m * (L + 1)  # both strands
    say(f"[9] input: {m} reads x {L} (seed 0, coverage 47x, 1% errors) as "
        f"gzip FASTQ, {os.path.getsize(fq)} B, written in "
        f"{time.perf_counter() - t0:.3f} s; {2 * m} strings and {total} "
        f"symbols with both strands")

    # run 1's one batch, as TorchBwt plans it: MERGE_CASES' "cli" row
    from ropebwt2_tpu_torch.engine.bcr import TorchBwt

    plan = TorchBwt(device=DEV)
    plan._plan(total)
    run1 = (plan.state.cap, 2 * m, total - 2 * m, None)
    run1_ok = run1 == case_shape("cli") and \
        plan._choose_defer(2 * m) == (0, 0)
    del plan
    torch.cuda.empty_cache()
    say(f"[9] run 1's plan: one batch, cap {run1[0]}, R = 0, {2 * m} lanes "
        f"a round, the last round at n {run1[2]}; == phase 2's cli case "
        f"{run1_ok}")

    # a fresh process's imports, the part of run 1's wall before main
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import ropebwt2_tpu_torch.cli"],
                   cwd=HERE, stdin=subprocess.DEVNULL, check=True,
                   timeout=300)
    imports = time.perf_counter() - t0
    say(f"[9] python -c 'import ropebwt2_tpu_torch.cli' (interpreter, "
        f"torch, numpy, the package): {imports:.3f} s")

    fmd = os.path.join(out, "cli.fmd")
    cmd = [sys.executable, "-m", "ropebwt2_tpu_torch.cli", "-s", "-d", "-o",
           fmd, fq]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=HERE, stdin=subprocess.DEVNULL,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in r.stderr.splitlines():
        say(f"[9]   child: {line}")
    if r.returncode != 0:
        raise AssertionError(f"the CLI failed ({r.returncode})")
    dev_line = [x for x in r.stderr.splitlines() if "[M::main] device" in x]
    batches = [x for x in r.stderr.splitlines() if "] inserted " in x]
    run1_ok &= len(batches) == 1 and f"inserted {total} symbols" in \
        batches[0]
    on_card = bool(dev_line) and "cuda" in dev_line[0]
    native = "reader: native" in r.stderr and "writer: native fmd" in \
        r.stderr
    say(f"[9] run 1, {' '.join(cmd[1:])}: wall {wall:.3f} s in a fresh "
        f"process, {total / wall / 1e6:.3f} Msym/s including start-up, "
        f"parse and write; built on the card {on_card} "
        f"({dev_line[0] if dev_line else 'no device line'}); native reader "
        f"and writer {native}; {smi}")

    txt = os.path.join(out, "cli.txt")
    argv = ["-s", "-m", CLI_M, "-o", txt, fq]
    torch.cuda.synchronize()
    with engine_calls() as calls:
        reset_launches()  # the CLI path: run 2, in this process
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        launches = read_launches()
    torch.cuda.empty_cache()
    if rc != 0:
        raise AssertionError(f"the CLI failed ({rc})")
    nbatch = len(calls["batches"])
    say(f"[9] run 2, cli.main({argv}): wall {wall2:.3f} s, "
        f"{total / wall2 / 1e6:.3f} Msym/s including parse and write; "
        f"{nbatch} batches; launches {launched(launches)}; {smi}")
    # the shapes this run gave kernels A and B, against phases 2 and 3's
    big = largest_calls(calls)
    del calls
    want = {"round": case_shape("cli 64m round"),
            "flush": case_shape("cli 64m flush"),
            "pending": (PEND_CLI[0], PEND_CLI[1],
                        int(PEND_CLI[0] * PEND_CLI[3]), PEND_CLI[4])}
    shapes_ok = big == want
    say(f"[9] run 2's largest calls (cap or pcap, lanes, live n or rows "
        f"pending, active): A round {big['round']}, A flush "
        f"{big['flush']}, B {big['pending']}; == the cases of phases 2 and "
        f"3 {shapes_ok}")

    # the FMD decodes to the text BWT, byte for byte
    lut = np.frombuffer(b"$ACGTN", np.uint8)
    text = np.fromfile(txt, np.uint8)
    rd = FmdReader(fmd)
    sym, ln = rd.runs_arrays()
    fmd_bwt = np.repeat(sym, ln)
    fmd_ok = bool(text.size == total + 1 and text[-1] == ord("\n")
                  and np.array_equal(lut[fmd_bwt], text[:-1]))
    say(f"[9] FMD ({os.path.getsize(fmd)} B, {sym.size} runs) decoded by "
        f"FmdReader == the text BWT of run 2 ({text.size} B): {fmd_ok}")
    del text

    # an LF walk over the FMD spells back strings of the input
    st = rd.to_flat(K=128, device=DEV)
    cnt = st.pcounts.sum(0)
    C = torch.cumsum(cnt, 0) - cnt
    rows = torch.arange(CLI_WALKS, device=DEV)
    live = torch.ones_like(rows, dtype=torch.bool)
    spelled = []
    for _ in range(L + 1):
        r0 = query.rank1a(st, rows)
        s = (query.rank1a(st, rows + 1) - r0).argmax(dim=1)
        live &= s != 0
        spelled.append(torch.where(live, s, 0))
        rows = torch.where(live, C[s] + r0.gather(1, s[:, None])[:, 0], rows)
    spelled = torch.stack(spelled, dim=1).cpu().numpy()
    del st
    torch.cuda.empty_cache()
    shaped = bool((spelled[:, :L] != 0).all() and (spelled[:, L] == 0).all())
    table = np.sort(revcomp_hashes(reads))
    h = read_hashes(spelled[:, :L][:, ::-1].astype(np.uint8))
    found = int((table[np.searchsorted(table, h).clip(max=table.size - 1)]
                 == h).sum())
    say(f"[9] LF walk over the FMD on the card from {CLI_WALKS} sentinel "
        f"rows: {L} symbols then the sentinel {shaped}; {found} of "
        f"{CLI_WALKS} spell a read or its reverse complement")

    # -b on a first file, -i with a second == one build of both
    small = [gen.batch(CLI_RESTORE) for _ in range(2)]
    paths = [os.path.join(out, f"small{i}.fq.gz") for i in range(2)]
    for i, (p, bt) in enumerate(zip(paths, small)):
        write_fastq_gz(p, bt, first=i * CLI_RESTORE)
    both = os.path.join(out, "small_both.fq.gz")
    write_fastq_gz(both, np.concatenate(small))
    fmr = os.path.join(out, "small0.fmr")
    res = [cli.main(["-s", "-b", "-o", fmr, paths[0]]),
           cli.main(["-d", "-i", fmr, "-o", fmr + ".fmd", paths[1]]),
           cli.main(["-s", "-d", "-o", both + ".fmd", both])]
    restore_ok = res == [0, 0, 0] and \
        open(fmr + ".fmd", "rb").read() == open(both + ".fmd", "rb").read()
    say(f"[9] -b on {CLI_RESTORE} reads, then -i with {CLI_RESTORE} more == "
        f"one -s build of both (FMD bytes): {restore_ok}")
    if not (on_card and native and fmd_ok and shaped and found == CLI_WALKS
            and restore_ok and run1_ok and shapes_ok):
        raise AssertionError("phase 9 failed its checks")
    if launches["merge"] == 0 or launches["pending_merge"] == 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    deferred_flat("[9] the CLI's run 2:", launches)
    return {"cli": (launches, nbatch)}, {"run1_s": wall, "run2_s": wall2}


# --------------------------------------------------------------- phase 10

def resident_bytes(st):
    """Bytes of a run-tier index's arrays: rsym, rend, bstart, bocc."""
    return sum(t.numel() * t.element_size()
               for t in (st.rsym, st.rend, st.bstart, st.bocc))


def pending_shape_ok(calls, case):
    """Kernel B's largest recorded call (pcap, lanes) == the phase 3 case's;
    returns (ok, the call)."""
    big = largest_calls(calls)["pending"]
    return big is not None and big[:2] == tuple(case[:2]), big


def phase_runs(torch, ReadGen, flat_md5, smi):
    """The run tier on phase 5's sustained reads: TorchBwt(so=1, runs=1),
    8 prefill batches (the last profiled) and 2 timed; its BWT must equal
    phase 5's flat BWT (md5)."""
    from ropebwt2_tpu_torch.engine import TorchBwt
    from ropebwt2_tpu_torch.scripts.scale_run import text_md5

    gen = ReadGen(seed=0, nreads=M_BENCH * (1 + PREFILL + SUSTAIN),
                  L=L_BENCH, mode="coverage", cov=47.0, err=0.01)
    gen.batch(M_BENCH)  # the batch regime's reads
    batches = [gen.batch(M_BENCH).view(np.int8)
               for _ in range(PREFILL + SUSTAIN)]
    syms = M_BENCH * (L_BENCH + 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = TorchBwt(so=1, K=128, device=DEV, runs=1)
    t0 = time.perf_counter()
    for bt in batches[:PREFILL - 1]:
        eng.insert_multi(bt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    wall, rows = profile(lambda: eng.insert_multi(batches[PREFILL - 1]))
    report_profile("runs sustained (prefill batch 8)", wall, rows,
                   tag="[10]")
    walls = []
    with engine_calls() as calls:
        reset_launches()  # the run tier's sustained path: the timed batches
        for bt in batches[PREFILL:]:
            t0 = time.perf_counter()
            eng.insert_multi(bt)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = read_launches()
        shape_ok, big = pending_shape_ok(calls, PEND_RUNS)
    peak = torch.cuda.max_memory_allocated()
    st, n = eng.state, eng.n
    defer_r, pcap = eng._choose_defer(M_BENCH)
    cnt = eng.counts()
    counts_ok = int(cnt[0]) == M_BENCH * (PREFILL + SUSTAIN) and \
        int(cnt.sum()) == n
    nslot, rcap = int(st.nslot), st.rcap
    res = resident_bytes(st)
    md5 = text_md5(eng)
    del eng, st
    torch.cuda.empty_cache()
    say(f"[10] run tier, sustained regime (runs=1): prefill {PREFILL - 1} "
        f"batches {prefill_s:.3f} s (+1 profiled), timed walls "
        f"{[round(w, 4) for w in walls]} s, {syms / min(walls) / 1e6:.3f} "
        f"Msym/s (best), n {n}; R {defer_r} pcap {pcap}; {smi}")
    say(f"[10] run tier: {nslot} live slots of {rcap}, {n / nslot:.3f} "
        f"symbols a slot; "
        f"resident {res} B ({res / n:.4f} B/sym: rsym + rend + bstart + "
        f"bocc, against the packed tier's 0.6875 and the flat tier's "
        f"1.1875 B per symbol of capacity); "
        f"peak device memory {peak} B ({peak / 2**30:.3f} GiB); launches "
        f"{launched(launches)}; kernel B's largest call (pcap, lanes, "
        f"pending, active) {big}, == phase 3's run case {shape_ok}")
    say(f"[10] run-tier BWT == phase 5's flat BWT (md5 of the text "
        f"encoding): {md5 == flat_md5} ({md5}, {flat_md5}); counts "
        f"{counts_ok}")
    if md5 != flat_md5 or not counts_ok or not shape_ok:
        raise AssertionError("phase 10 failed its checks")
    if launches["pending_merge"] == 0:
        raise AssertionError(f"kernel B never launched: {launches}")
    return {"runs": (launches, SUSTAIN)}


# --------------------------------------------------------------- phase 11

def phase_deep(torch, ReadGen, smi):
    """The run tier at deep coverage: scripts/configs/scale4gdeep_runs.sh's
    configuration cut to DEEP_BATCHES batches, built through the port's
    scale_run (TorchBwt.plan, batches, insert_batch, text_md5); per batch
    Msym/s, then symbols a slot, resident B/sym, overflow, md5, counts and
    an LF walk from sentinel rows that spells reads of the input."""
    from ropebwt2_tpu_torch.engine import TorchBwt, query
    from ropebwt2_tpu_torch.scripts import scale_run

    mb, nb, L = DEEP_MBATCH, DEEP_BATCHES, L_BENCH
    nreads = mb * nb
    total = nreads * (L + 1)
    say(f"[11] cut: scale4gdeep_runs.sh's {DEEP_READS} reads x {L} cut to "
        f"{nb} batches of {mb} reads: {nreads} reads, {total} symbols, at "
        f"its coverage (150x over a genome cut with the reads), to stay "
        f"inside the time limit")
    gen = ReadGen(seed=777, nreads=nreads, L=L, mode="coverage", cov=150.0,
                  err=0.003)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = TorchBwt(so=1, K=128, device=DEV, defer_r=8, runs=1,
                   runs_margin=0.35)
    eng.plan(total)  # the conversion, int32 tables for the total
    hashes, walls, gen_s = [], [], 0.0
    t_all = time.perf_counter()
    with engine_calls() as calls:
        reset_launches()  # the deep-coverage path
        for i, (bt, g) in enumerate(scale_run.batches(gen, nreads, mb)):
            gen_s += g
            hashes.append(read_hashes(bt[:, ::-1]))
            # insert_multi reads nslot and overflow when it ends
            wall, _ = scale_run.insert_batch(eng, bt, i * mb, L)
            walls.append(wall)
            st = eng.state
            say(f"[11] batch {i + 1}: {walls[-1]:.4f} s, "
                f"{mb * (L + 1) / walls[-1] / 1e6:.3f} Msym/s, n {eng.n}, "
                f"nslot {int(st.nslot)}, rcap {st.rcap}, overflow "
                f"{int(st.overflow)}")
        launches = read_launches()
        shape_ok, big = pending_shape_ok(calls, PEND_DEEP)
    build_s = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated()
    st, n = eng.state, eng.n
    nslot, overflow = int(st.nslot), int(st.overflow)
    res = resident_bytes(st)
    live = (st.rsym.element_size() + st.rend.element_size()) * nslot \
        + (st.bstart.element_size() * 7) * -(-nslot // 128)
    cnt = eng.counts()
    counts_ok = int(cnt[0]) == nreads and int(cnt.sum()) == total == n
    steady = walls[1:]
    say(f"[11] built {n} symbols in {build_s:.3f} s (reads drawn on a host "
        f"thread meanwhile, {gen_s:.3f} s); first batch {walls[0]:.4f} s; "
        f"steady {mb * (L + 1) * len(steady) / sum(steady) / 1e6:.3f} "
        f"Msym/s over batches 2-{nb} (walls {min(steady):.4f}-"
        f"{max(steady):.4f} s); all-in {n / build_s / 1e6:.3f} Msym/s; "
        f"{smi}")
    say(f"[11] {nslot} live slots of {st.rcap}, {n / nslot:.3f} symbols a "
        f"slot (the JAX package's record on a TPU: {DEEP_RECORD[1]}); "
        f"resident {res} B, {res / n:.4f} B/sym allocated, {live / n:.4f} "
        f"B/sym live (rsym + rend + bstart + bocc; the packed tier 0.6875); "
        f"tables {st.bstart.dtype}; overflow {overflow}; peak device memory "
        f"{peak} B ({peak / 2**30:.3f} GiB); counts {cnt.tolist()} {counts_ok}"
        f"; launches {launched(launches)}; kernel B's largest call {big}, == "
        f"phase 3's deep case {shape_ok}")

    spelled = lf_walk(torch, lambda p: query.rank1a(st, p),
                      torch.from_numpy(cnt).to(DEV),
                      torch.arange(SCALE_WALKS, device=DEV), L + 1)
    spelled = spelled.cpu().numpy()
    shaped = bool((spelled[:, :L] != 0).all() and (spelled[:, L] == 0).all())
    table = np.sort(np.concatenate(hashes))
    h = read_hashes(spelled[:, :L].astype(np.uint8))
    found = int((table[np.searchsorted(table, h).clip(max=table.size - 1)]
                 == h).sum())
    say(f"[11] LF walk from {SCALE_WALKS} sentinel rows with the run tier's "
        f"rank on the card: {L} symbols then the sentinel {shaped}; {found} "
        f"of {SCALE_WALKS} spell a read of the input")
    tm = time.perf_counter()
    md5 = scale_run.text_md5(eng)
    say(f"[11] bwt md5 {md5} ({time.perf_counter() - tm:.3f} s incl. "
        f"transfer); the JAX package's record of {DEEP_RECORD[1]} symbols a "
        f"slot at 29 batches has {DEEP_RECORD[0]} (its seed is not "
        f"recorded): equal {md5 == DEEP_RECORD[0]}")
    del eng, st
    torch.cuda.empty_cache()
    if overflow or not counts_ok or not shaped or found != SCALE_WALKS \
            or not shape_ok:
        raise AssertionError("phase 11 failed its checks")
    if launches["pending_merge"] == 0:
        raise AssertionError(f"kernel B never launched: {launches}")
    return {"runs_deep": (launches, nb)}


# --------------------------------------------------------------- phase 12

def phase_long(torch, smi):
    """Long reads: LONG_READS uniform reads of 2,000-5,000 bp in one batch
    (thousands of rounds), built through the port's longread_run.build, on
    the flat tier (defer_r=16) and the run tier;
    equal md5s, and LF walks from every sentinel row of the run-tier
    index spell the reads (the flat index is held to it by md5)."""
    from ropebwt2_tpu_torch.engine import query
    from ropebwt2_tpu_torch.scripts import longread_run
    from ropebwt2_tpu_torch.scripts.scale_run import text_md5

    rng = np.random.default_rng(LONG_SEED)
    lens = rng.integers(LONG_LEN[0], LONG_LEN[1] + 1, LONG_READS)
    reads = np.split(rng.integers(1, 5, int(lens.sum())).astype(np.int8),
                     np.cumsum(lens)[:-1])
    rounds = int(lens.max()) + 1
    want = sorted(r[::-1].tobytes() for r in reads)
    out, md5s = {}, {}
    for path, kw, case in (("long", {"defer_r": 16}, PEND_LONG),
                           ("long_runs", {"runs": 1}, PEND_LONG_RUNS)):
        torch.cuda.empty_cache()
        with engine_calls() as calls:
            reset_launches()  # this long-read path
            eng, wall, _ = longread_run.build(reads, DEV, kw)
            launches = read_launches()
            shape_ok, big = pending_shape_ok(calls, case)
        st, n = eng.state, eng.n
        md5s[path] = text_md5(eng)
        walk_ok, walk = True, "held to the other build by md5"
        if path == "long_runs":
            t0 = time.perf_counter()
            spelled = lf_walk(torch, lambda p: query.rank1a(st, p),
                              torch.from_numpy(eng.counts()).to(DEV),
                              torch.arange(LONG_READS, device=DEV), rounds)
            spelled = spelled.cpu().numpy()
            walk_ok = sorted(r[r != 0].tobytes() for r in spelled) == want
            walk = (f"LF walk from every sentinel row spells the reads "
                    f"{walk_ok} ({time.perf_counter() - t0:.3f} s)")
        say(f"[12] {path} ({type(st).__name__}, {kw}): {LONG_READS} reads "
            f"of {int(lens.min())}-{int(lens.max())} bp, n {n}, {rounds} "
            f"rounds in {wall:.3f} s, {rounds / wall:.1f} rounds/s, "
            f"{n / wall / 1e6:.3f} Msym/s; {walk}; launches "
            f"{launched(launches)}; kernel B's largest call {big}, == phase "
            f"3's case {shape_ok}; {smi}")
        if not walk_ok or not shape_ok:
            raise AssertionError(f"phase 12 failed its checks ({path})")
        if launches["pending_merge"] == 0:
            raise AssertionError(f"kernel B never launched: {launches}")
        if path == "long":
            deferred_flat("[12] long, flat tier:", launches)
        out[path] = (launches, 1)
        del eng, st
    same = md5s["long"] == md5s["long_runs"]
    say(f"[12] flat and run-tier BWTs equal (md5): {same} ({md5s['long']})")
    if not same:
        raise AssertionError("the long-read builds differ")
    return out


# --------------------------------------------------------------- phase 13

def stitched_case(torch, gen, lcap, m, a, s_lo):
    """Kernel A on one rank's stitched buffer (parallel/sharded.py::
    stitched_args): a window of lcap random symbols, a tail of m, ``a``
    insertions routed to the rank among M_BENCH lanes (a if a else 0) and
    s_lo phantom marks; the kernel (run_kernel) against its plain version
    (merge_blocks) on the window and on its rebased K-rows (int32 rows),
    tolerance 0.  Returns max_abs_err, the kernel's time alone (a CUDA
    graph), the whole stitched_merge's (eager), the plain version's and
    the bound."""
    from ropebwt2_tpu_torch.index import merge_cuda
    from ropebwt2_tpu_torch.index.flat import PAD_TAIL
    from ropebwt2_tpu_torch.parallel.sharded import (
        stitched_args, stitched_merge, stitched_window,
    )
    from ropebwt2_tpu_torch.probes import _timing

    dev = DEV
    bwt = torch.randint(0, 6, (lcap + PAD_TAIL,), generator=gen, device=dev,
                        dtype=torch.int8)
    tail = torch.randint(0, 6, (m,), generator=gen, device=dev,
                         dtype=torch.int8)
    lanes = M_BENCH if a else 0
    rv = torch.zeros(lanes, dtype=torch.bool, device=dev)
    rv[torch.randperm(lanes, generator=gen, device=dev)[:a]] = True
    ldest = torch.full((lanes,), lcap, device=dev)
    ldest[rv] = torch.sort(torch.randperm(lcap, generator=gen, device=dev)[
        :a]).values
    rsym = torch.randint(0, 6, (lanes,), generator=gen, device=dev)
    s_lo_t = torch.tensor(s_lo, device=dev)
    args = stitched_args(bwt, tail, ldest, rsym, rv, s_lo_t, lcap)
    got = stitched_window(*merge_cuda.run_kernel(*args), m, lcap, 128)
    want = stitched_window(*merge_cuda.merge_blocks(*args), m, lcap, 128)
    torch.cuda.synchronize()
    err = max(max_abs_diff(got[0], want[0]), max_abs_diff(got[1], want[1]))
    if got[1].dtype != torch.int32:
        raise AssertionError(f"stitched rows are {got[1].dtype}")
    del got, want
    alloc = args[0].shape[0]
    nb = -(-alloc // merge_cuda.BS)
    res = {"err": err,
           "ms": _timing.graph_ms(lambda: merge_cuda.run_kernel(*args)),
           "wrapper_ms": time_ms(lambda: stitched_merge(
               bwt, tail, ldest, rsym, rv, s_lo_t, lcap, 128)),
           "plain_ms": time_ms(lambda: merge_cuda.merge_blocks(*args)),
           "bound_ms": _timing.bound_ms(_timing.merge_bytes(
               m + lcap, s_lo + a, alloc, tile=merge_cuda.tile_blocks(nb)))}
    del bwt, tail, args
    torch.cuda.empty_cache()
    return res


def phase_sharded(torch, ReadGen, kept, smi):
    """The sharded engine (parallel/): 13a, kernels A and B at the per-rank
    shapes of a world of 4; 13b, ShardedTorchBwt at a world of one over
    NCCL on phase 5's sustained reads (its BWT == phase 5's flat BWT by
    md5), with defer_r = 0 on one batch into an empty index (== the
    flat engine's), and grown with no plan through two re-shards (==
    TorchBwt's BWT on the same reads by md5); 13c, the CLI under
    ROPEBWT2_TPU_SHARDED=1 on phase 9's FASTQ in a fresh process (its FMD
    == phase 9's run 1)."""
    import torch.distributed as dist
    from ropebwt2_tpu_torch.engine import TorchBwt
    from ropebwt2_tpu_torch.scripts.scale_run import text_md5
    from ropebwt2_tpu_torch.engine.bcr import _pad_pow2, _round_up
    from ropebwt2_tpu_torch.parallel.mesh import make_mesh
    from ropebwt2_tpu_torch.parallel.sharded import ShardedTorchBwt
    from ropebwt2_tpu_torch.scripts import reshard_run

    syms = M_BENCH * (L_BENCH + 1)
    total = (PREFILL + SUSTAIN + 1) * syms
    # 13a: the per-rank shapes at d = SHARD_D, as ShardedTorchBwt plans them
    lcap = _round_up(_pad_pow2(-(-total // SHARD_D), lo=4096), 128)
    planner = ShardedTorchBwt.__new__(ShardedTorchBwt)
    planner._defer_cfg, planner._lcap, planner.d = -1, lcap, SHARD_D
    shape_ok = (lcap, planner._choose_defer(M_BENCH)) == \
        (SHARD_LCAP, (16, SHARD_PCAP))
    say(f"[13a] d = {SHARD_D} on phase 5's plan ({total} symbols): lcap "
        f"{lcap}, (R, pcap) {planner._choose_defer(M_BENCH)}; == the cases' "
        f"{shape_ok}")
    gen = torch.Generator(device=DEV).manual_seed(13)
    out = {}
    for name, m, a, s_lo in (
            [(f"stitched s_lo {x}", M_BENCH, SHARD_ROUTED, x)
             for x in SHARD_SLO]
            + [("sharded shift", *SHARD_SHIFT[:1], 0, SHARD_SHIFT[1])]):
        r = stitched_case(torch, gen, SHARD_LCAP, m, a, s_lo)
        say(f"[13a] kernel A, {name}: lcap {SHARD_LCAP} tail {m} routed "
            f"insertions {a} s_lo {s_lo}: max_abs_err {r['err']} (window "
            f"and rebased int32 K-rows against merge_blocks, tolerance 0); "
            f"kernel alone {r['ms']:.4f} ms, stitched_merge "
            f"{r['wrapper_ms']:.4f} ms eager, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms, share "
            f"{r['bound_ms'] / r['ms']:.3f}; {smi}")
        if r["err"] != 0:
            raise AssertionError(f"the stitched merge disagrees ({name})")
        out[name] = r
    if not shape_ok:
        raise AssertionError("phase 13a's shapes are not the engine's")

    # 13b: a world of one over NCCL on phase 5's sustained reads
    gen = ReadGen(seed=0, nreads=M_BENCH * (1 + PREFILL + SUSTAIN),
                  L=L_BENCH, mode="coverage", cov=47.0, err=0.01)
    first = gen.batch(M_BENCH).view(np.int8)
    batches = [gen.batch(M_BENCH).view(np.int8)
               for _ in range(PREFILL + SUSTAIN)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(device=None if DEV == "cuda" else DEV)
    try:
        backend = dist.get_backend()
        eng = ShardedTorchBwt(so=1, K=128, mesh=mesh)
        eng._plan(total)
        defer_r, pcap = eng._choose_defer(M_BENCH)
        t0 = time.perf_counter()
        for bt in batches[:PREFILL - 1]:
            eng.insert_multi(bt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        wall, rows = profile(lambda: eng.insert_multi(batches[PREFILL - 1]))
        report_profile("sharded (prefill batch 8)", wall, rows, tag="[13b]")
        walls = []
        reset_launches()  # the sharded path: the timed batches
        for bt in batches[PREFILL:]:
            t0 = time.perf_counter()
            eng.insert_multi(bt)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = read_launches()
        cnt = eng.counts()
        counts_ok = int(cnt[0]) == M_BENCH * (PREFILL + SUSTAIN) and \
            int(cnt.sum()) == syms * (PREFILL + SUSTAIN)
        md5 = text_md5(eng.bwt_array())
        lcap1 = eng._lcap
        peak = torch.cuda.max_memory_allocated()
        del eng
        torch.cuda.empty_cache()
        one = ShardedTorchBwt(so=1, K=128, mesh=mesh, defer_r=0)
        torch.cuda.synchronize()
        reset_launches()  # the sharded path merged every round: one batch
        t0 = time.perf_counter()
        one.insert_multi(first)
        torch.cuda.synchronize()
        one_wall = time.perf_counter() - t0
        one_launches = read_launches()
        got = one.bwt_array()
        del one
        torch.cuda.empty_cache()
        # growth with no plan: a re-shard at every doubling of the index
        t_grow = time.perf_counter()
        grown = ShardedTorchBwt(so=1, K=128, mesh=mesh)
        reset_launches()  # the sharded path grown without a plan
        watch, grow_rows = reshard_run.grow(grown, reshard_run.read_batches(
            GROW_MBATCH, L_BENCH))
        grow_launches = read_launches()
        grow_s = time.perf_counter() - t_grow
        t0 = time.perf_counter()
        grow_md5 = text_md5(grown.bwt_array())
        grow_md5_s = time.perf_counter() - t0
        grow_peak = watch.run_peak()
        del grown
    finally:
        mesh.close()
    ref = TorchBwt(so=1, K=128, device=DEV, defer_r=0)
    ref.insert_multi(first)
    one_ok = bool(np.array_equal(got, ref.bwt_array()))
    del ref, got
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = TorchBwt(so=1, K=128, device=DEV)
    for bt in reshard_run.read_batches(GROW_MBATCH, L_BENCH):
        ref.insert_multi(bt)
    grow_ok = grow_md5 == text_md5(ref)
    grow_ref_s = time.perf_counter() - t0
    del ref
    torch.cuda.empty_cache()
    md5_ok = md5 == kept["md5"]
    rate = syms / min(walls) / 1e6
    say(f"[13b] ShardedTorchBwt over a world of {mesh.d} ({backend}): lcap "
        f"{lcap1} R {defer_r} pcap {pcap}, prefill {PREFILL - 1} batches "
        f"{prefill_s:.3f} s (+1 profiled), timed walls "
        f"{[round(w, 4) for w in walls]} s, {rate:.3f} Msym/s (best) against "
        f"phase 5's flat {kept['sustained_rate']:.3f} Msym/s; launches per "
        f"batch: kernel A {launches['merge'] / SUSTAIN}, kernel B "
        f"{launches['pending_merge'] / SUSTAIN}; peak device memory {peak} "
        f"B ({peak / 2**30:.3f} GiB); {smi}")
    say(f"[13b] sharded BWT == phase 5's flat BWT (md5 of the text "
        f"encoding): {md5_ok} ({md5}); counts {counts_ok}")
    say(f"[13b] defer_r = 0, one batch of {syms} symbols into an empty "
        f"index: {one_wall:.3f} s, {syms / one_wall / 1e6:.3f} Msym/s, "
        f"launches {launched(one_launches)}; == TorchBwt's BWT {one_ok}; "
        f"process group destroyed {not dist.is_initialized()}")
    recs = watch.records
    say(f"[13b] growth with no plan, {reshard_run.BATCHES} batches of "
        f"{GROW_MBATCH} uniform reads x {L_BENCH}: batch walls "
        f"{[round(w, 4) for w, _, _ in grow_rows]} s, lcap after each "
        f"{[lc for _, lc, _ in grow_rows]}, n {grow_rows[-1][2]}; "
        f"peak device memory of the run {gib(grow_peak)}; launches "
        f"{launched(grow_launches)}; {smi}")
    for r in recs:  # the first plan makes the windows; the rest re-shard
        say(f"[13b]   plan {r['lcap_from']} -> {r['lcap_to']} at n "
            f"{r['n_from']}: wall {r['wall_s']:.6f} s (synchronised), "
            f"received {r['recv_bytes']} B ({r['calls']}: (name, elements, "
            f"bytes) a collective; the new window's live symbols "
            f"min(lcap_to, n) and the (d, 6) totals wanted: "
            f"{reshard_run.received_exactly(r, mesh.d, mesh.s)}), peak "
            f"during it {gib(r['peak_b'])}")
    reshards = [r for r in recs if r["lcap_from"]]
    exact = all(reshard_run.received_exactly(r, mesh.d, mesh.s)
                for r in recs)
    say(f"[13b] growth: re-shards {len(reshards)} (2 wanted), each received "
        f"exactly its new window's live symbols and the totals {exact}; BWT "
        f"== TorchBwt's on the same reads (md5 of the text encoding) "
        f"{grow_ok} ({grow_md5})")
    grow_all = grow_s + grow_md5_s + grow_ref_s
    say(f"[13b] growth's share of phase 13: {grow_all:.1f} s (the unplanned "
        f"build {grow_s:.1f} s, its md5 {grow_md5_s:.1f} s, "
        f"TorchBwt's reference build and md5 {grow_ref_s:.1f} s)")
    if not (md5_ok and counts_ok and one_ok and grow_ok and exact) or \
            len(reshards) < 2 or dist.is_initialized():
        raise AssertionError("phase 13b failed its checks")
    if launches["merge"] == 0 or launches["pending_merge"] == 0 or \
            one_launches["merge"] == 0 or grow_launches["merge"] == 0:
        raise AssertionError(f"a kernel never launched: {launches}, "
                             f"{one_launches}, {grow_launches}")
    deferred_flat("[13b] sharded:", launches)

    # 13c: the CLI's switch, in a fresh process, on phase 9's FASTQ
    smoke = os.path.join(HERE, "smoke_out")
    fq, want = os.path.join(smoke, "reads.fq.gz"), \
        os.path.join(smoke, "cli.fmd")
    fmd = os.path.join(smoke, "cli_sharded.fmd")
    cmd = [sys.executable, "-m", "ropebwt2_tpu_torch.cli", "-s", "-d", "-o",
           fmd, fq]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=HERE, stdin=subprocess.DEVNULL,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, ROPEBWT2_TPU_SHARDED="1"))
    wall = time.perf_counter() - t0
    for line in r.stderr.splitlines():
        say(f"[13c]   child: {line}")
    switch = "sharded engine over 1 devices" in r.stderr
    same = r.returncode == 0 and \
        open(fmd, "rb").read() == open(want, "rb").read()
    say(f"[13c] ROPEBWT2_TPU_SHARDED=1 {' '.join(cmd[1:])}: rc "
        f"{r.returncode}, wall {wall:.3f} s in a fresh process; FMD == "
        f"phase 9's run 1 {same}; 'sharded engine over 1 devices' "
        f"{switch}; {smi}")
    if not (same and switch):
        raise AssertionError("phase 13c failed its checks")
    return {"sharded": (launches, SUSTAIN),
            "sharded_batch": (one_launches, 1),
            "sharded_growth": (grow_launches, reshard_run.BATCHES)}, out


# --------------------------------------------------------------- phase 14

def run_module(module, env, log_name, timeout=900):
    """``python -m module`` from the checkout in a fresh process with
    ``env`` added to this one's: (wall s, its stdout lines).  Its output
    goes to smoke_out/<log_name>; raises if it exits nonzero."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module], cwd=HERE,
                       env={**os.environ, **env}, capture_output=True,
                       text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    out = os.path.join(HERE, "smoke_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, log_name), "w") as f:
        f.write(r.stdout + "\n---- stderr ----\n" + r.stderr)
    if r.returncode != 0:
        raise AssertionError(f"{module} exited {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    return wall, r.stdout.splitlines()


def phase_entry_points(name, smi):
    """The bench and scale_run as a user runs them, each in a fresh
    process: ``python -m ropebwt2_tpu_torch.bench`` with BENCH_RUNS=2 (its
    last line parses, has no ``degraded``, names this card and its power
    limit, and its launches show kernel A on the batch path and A and B on
    the sustained one), then ``python -m
    ropebwt2_tpu_torch.scripts.scale_run`` at SCALE14_BATCHES batches of
    2^20 reads on the packed tier with SCALE_MD5=1 (its index hashed, its
    FM spot check passed, kernels B and C launched at CAP_SCALE14 and R 4,
    the shapes PEND_SCALE14 and PACKED_CASES hold them at), and ``python
    -m ropebwt2_tpu_torch.scripts.scale_shards`` (every world's parity on
    the card)."""
    wall, lines = run_module("ropebwt2_tpu_torch.bench",
                             {"BENCH_RUNS": str(BENCH14_RUNS)},
                             "phase14_bench.log")
    line = json.loads(lines[-1])
    d = line.get("detail", {})
    say(f"[14] python -m ropebwt2_tpu_torch.bench (BENCH_RUNS="
        f"{BENCH14_RUNS}), {wall:.1f} s: {json.dumps(line)}")
    keys = ("batch", "warmup_s", "rank_queries", "extend", "backward_search",
            "launches", "power_limit")
    lb, ls = d.get("launches", {}).get("batch", {}), \
        d.get("launches", {}).get("sustained", {})
    ok = ("degraded" not in line and "error" not in line
          and all(k in d for k in keys) and d["device"] == f"cuda:{name}"
          and d["power_limit"] and line["value"] > 0
          and lb.get("merge", 0) > 0 and ls.get("merge", 0) > 0
          and ls.get("pending_merge", 0) > 0)
    say(f"[14] bench line: value {line['value']} sym/s (sustained), batch "
        f"{d.get('batch', {}).get('value')}, warm-up {d.get('warmup_s')} s "
        f"(build {d.get('build_s')} s), rank "
        f"{d.get('rank_queries', {}).get('value')} q/s, extend "
        f"{d.get('extend', {}).get('value')} ext/s, backward_search "
        f"{d.get('backward_search', {}).get('value')} sym-steps/s; device "
        f"{d.get('device')}, {d.get('power_limit')}; launches {lb} / {ls}; "
        f"complete, no degraded, names this card: {ok}; {smi}")
    if not ok:
        raise AssertionError("phase 14: the bench's line is not complete")

    nreads = SCALE14_BATCHES << 20
    wall, lines = run_module(
        "ropebwt2_tpu_torch.scripts.scale_run",
        {"SCALE_NREADS": str(nreads), "SCALE_MBATCH": str(1 << 20),
         "SCALE_MD5": "1", "ROPEBWT2_TPU_PACK4": "1",
         "SCALE_JSON": os.path.join(HERE, "smoke_out", "phase14_scale.json")},
        "phase14_scale_run.log")
    res = json.loads(next(x for x in reversed(lines)
                          if x.startswith("[scale] RESULT "))[15:])
    say(f"[14] python -m ropebwt2_tpu_torch.scripts.scale_run, {wall:.1f} s: "
        f"{json.dumps(res)}")
    sl = res["launches"]
    phantom = 1 if nreads * (L_BENCH + 1) % 16384 == 0 else 0
    # the shapes of phases 2b and 3: this capacity, and R 4 (a flush of
    # kernel C every 4 of the 102 rounds of a batch)
    flushes = SCALE14_BATCHES * -(-(L_BENCH + 1) // 4)
    ok = (res["index_tier"] == "packed" and len(res.get("bwt_md5", "")) == 32
          and min(res["spot_check"]) >= 1
          and res["counts"][0] == nreads + phantom + 4
          and sum(res["counts"]) == res["symbols"] + phantom + 4 * 13
          and res["device"] == f"cuda:{name}"
          and res["capacity"] == CAP_SCALE14
          and sl["pending_merge"] == SCALE14_BATCHES * (L_BENCH + 1)
          and sl["merge_packed"] == flushes)
    say(f"[14] scale_run: packed, cap {res['capacity']}, {res['symbols']} "
        f"symbols, steady {res['steady_throughput_sym_s'] / 1e6:.3f} Msym/s, "
        f"all-in {res['throughput_sym_s'] / 1e6:.3f} Msym/s, md5 "
        f"{res['bwt_md5']}, FM spot check {res['spot_check']}, launches "
        f"{sl} (B {SCALE14_BATCHES * (L_BENCH + 1)} and C {flushes} at R 4 "
        f"wanted); checks {ok}")
    if not ok:
        raise AssertionError("phase 14: scale_run's result fails its checks")

    wall, lines = run_module("ropebwt2_tpu_torch.scripts.scale_shards", {},
                             "phase14_scale_shards.log")
    worlds = [x for x in lines if x.startswith("WEAK D=")]
    for x in lines:
        say(f"[14] scale_shards: {x}")
    ok = (bool(worlds) and all(x.endswith("parity=ok") for x in worlds)
          and f"cuda:{name}" in lines[0])
    say(f"[14] python -m ropebwt2_tpu_torch.scripts.scale_shards, {wall:.1f} "
        f"s: {len(worlds)} world(s) on the card, each rank 0's BWT equal "
        f"to TorchBwt's: {ok}")
    if not ok:
        raise AssertionError("phase 14: scale_shards' parity fails")
    return {"bench_batch": (lb, BENCH14_RUNS),
            "bench_sustained": (ls, PREFILL + SUSTAIN),
            "scale_run": (sl, SCALE14_BATCHES)}


def kernel_table(merge_res, packed_res, pend_res, rank_res, paths, probes):
    """The kernels line: A, B, C with their launches per batch on every
    path, their time, plain time and bound at the shape of each path, the
    rank kernels with their launches per batch on every path (None where
    a child process counted A, B and C only), and every probe kernel of
    phase 7."""
    from ropebwt2_tpu_torch.probes import _timing, kernel_stages

    def by_path(name):
        return {path: counts[name] / nbatch if name in counts else None
                for path, (counts, nbatch) in paths.items()}

    def entry(name, source, replaces, launches, err, r, **extra):
        return {"name": name, "route": "cuda",
                "source": f"ropebwt2_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "library_ms": r.get("library_ms"), **extra}

    def shapes(res):
        return {k: {f: v[f] for f in ("ms", "wrapper_ms", "wrapper_device_ms",
                                      "plain_ms", "bound_ms") if f in v}
                for k, v in res.items()}

    pend = {f"pcap {k[0]} M {k[1]} {int(100 * k[2])}% full": v
            for k, v in pend_res.items()}

    def pend_at(case, frac=None):
        return pend_res[(case[0], case[1], case[3] if frac is None
                         else frac)]

    # time and bound of A, B, C at the shape each path gives them
    at_path = {
        "merge": {"batch": merge_res["batch"],
                  "sustained": merge_res["flush"],
                  "cli": merge_res["cli 64m round"],
                  "long": merge_res["long flush"],
                  "sharded": merge_res["sharded flush"],
                  "sharded_batch":
                      merge_res[f"stitched s_lo {SHARD_SLO[-1]}"]},
        "pending_merge": {"sustained": pend_at(PEND_SHAPE, 0.3),
                          "sustained_packed": pend_at(PEND_SHAPE, 0.3),
                          **{path: pend_at(c) for path, c in (
                              ("capacity", PEND_CAPACITY), ("cli", PEND_CLI),
                              ("runs", PEND_RUNS), ("runs_deep", PEND_DEEP),
                              ("sharded", PEND_RUNS),
                              ("long", PEND_LONG),
                              ("long_runs", PEND_LONG_RUNS),
                              ("scale_run", PEND_SCALE14))}},
        "merge_packed": {"sustained_packed": packed_res["sustained"],
                         "capacity": packed_res["flush"],
                         "scale_run": packed_res["scale_run flush"]},
    }
    main = []
    for name, source, replaces, res, first, headline in (
        ("merge", "merge.cu", "ropebwt2_tpu/index/merge_pallas.py:582",
         merge_res, merge_res["batch"], "sustained"),
        ("pending_merge", "pending.cu",
         "ropebwt2_tpu/index/pending_pallas.py:279", pend,
         pend_at(PEND_SHAPE, 0.3), "sustained"),
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
            first, shapes=shapes(res), by_path=path_rows,
            launches_by_path={p: c[name] for p, (c, _) in paths.items()}))
    # the rank kernels: launches from the path that runs them most (the
    # batch regime merges every round; the deferred flat and packed paths
    # rank through their virtual kernels, the run tier through the pending
    # one; the packed rank runs on the packed index's queries)
    for name, replaces, headline, case in (
        ("rank_flat", "ropebwt2_tpu/index/rank.py:38", "batch", "sustained"),
        ("rank_pend", "ropebwt2_tpu/index/pending.py:188", "runs", "runs"),
        ("rank_virtual", "ropebwt2_tpu/index/pending.py:289", "sustained",
         "sustained"),
        ("rank_packed", "ropebwt2_tpu/index/packed.py:244",
         "queries_packed", "queries rank"),
        ("rank_virtual_packed", "ropebwt2_tpu/index/pending.py:297",
         "capacity", "capacity"),
    ):
        res = rank_res[name]
        main.append(entry(
            name, "rank.cu", replaces, paths[headline][0][name],
            max(r["err"] for r in res.values()), res[case],
            shapes=shapes(res),
            launches_per_batch={p: v for p, v in by_path(name).items() if v},
            launches_by_path={p: c.get(name) for p, (c, _) in
                              paths.items()}))
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


def kernel_name(mangled):
    """A kernel's name and template arguments from its mangled symbol:
    the length-prefixed name that ends in "kernel" (the whole symbol if
    none does)."""
    for i in range(len(mangled)):
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        if j > i and j < len(mangled):
            name = mangled[j:j + int(mangled[i:j])]
            if name.endswith("kernel"):
                rest = mangled[j + len(name):]
                depth, k = 0, 0  # the template arguments, I ... E
                while rest.startswith("I") and k < len(rest):
                    depth += {"I": 1, "E": -1}.get(rest[k], 0)
                    k += 1
                    if depth == 0:
                        break
                return name + rest[:k]
    return mangled


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; refusing to run on the CPU",
              file=sys.stderr)
        return 1
    from ropebwt2_tpu_torch import _build
    from ropebwt2_tpu_torch.scripts.readgen import ReadGen

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
            kernel = ""  # the entry function that ptxas reports on
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    kernel = kernel_name(line.split("'")[1])
                elif "registers" in line or "spill" in line:
                    say(f"[1] ptxas ({lib}) {kernel}: "
                        f"{line.split('ptxas info    :')[-1].strip()}")
    for unit, status in _build.unit_status("probes").items():
        if status != "ok":
            say(f"[1] probe unit {unit} did not compile (reported in phase "
                f"7): {status.strip().splitlines()[0][:200]}")

    def timed(tag, phase, *args):
        t = time.perf_counter()
        res = phase(*args)
        say(f"[{tag}] phase {tag} took {time.perf_counter() - t:.1f} s "
            f"({time.perf_counter() - t0:.1f} s since the build began)")
        return res

    if sys.argv[1:] == ["--rank-variants"]:
        # on request: phase 3r with the earlier design's launches and this
        # design's parts, and the kernels' SASS counts; no other phase
        res = timed("3r", phase_rank, torch, True)
        res["issue"] = rank_issue(torch)
        say(json.dumps({"rank_variants": {
            k: {c: {f: r[f] for f in ("ms", "bound_ms", "variants")}
                for c, r in v.items()} if k != "issue" else v
            for k, v in res.items()}}))
        say(smi)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; the only one "
              "is --rank-variants", file=sys.stderr)
        return 2
    merge_res = timed("2", phase_merge, torch)
    packed_res = timed("2b", phase_packed, torch)
    pend_res = timed("3", phase_pending, torch)
    rank_res = timed("3r", phase_rank, torch)
    timed("4", phase_small, torch, ReadGen)
    paths, kept = timed("5", phase_main, torch)
    cap_paths, cap_rank = timed("6", phase_capacity, torch, ReadGen)
    paths.update(cap_paths)
    rank_res["rank_packed"].update(cap_rank)
    probes, probe_launches = phase_probes(torch)
    probes["launches"] = probe_launches
    paths.update(timed("8", phase_queries, torch, kept, smi))
    cli_paths, _ = timed("9", phase_cli, torch, ReadGen, smi)
    paths.update(cli_paths)
    paths.update(timed("10", phase_runs, torch, ReadGen, kept["md5"], smi))
    paths.update(timed("11", phase_deep, torch, ReadGen, smi))
    paths.update(timed("12", phase_long, torch, smi))
    shard_paths, stitched = timed("13", phase_sharded, torch, ReadGen, kept,
                                  smi)
    paths.update(shard_paths)
    merge_res.update(stitched)
    paths.update(timed("14", phase_entry_points, name, smi))

    kernels = kernel_table(merge_res, packed_res, pend_res, rank_res, paths,
                           probes)
    say(json.dumps({"kernels": kernels,
                    "not_compiled": probes["failed"]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
