"""What the probes share: CUDA-event timing, the chained two-length
difference, and the byte model of each kernel.

The byte model counts what a call must move at the least: each input it
needs read once and each output written once, from the call's shapes and
live sizes (a kernel that stops at the live prefix needs only that much
of its inputs, and need not write what its contract leaves unspecified).
Over the card's memory rate it is the call's bound, the least time the
card could take for it; every kernel here does a few integer operations
per byte, so bytes and not operations bound them.  The looped stage
kernels of probe E run on data held on the chip, so their bound is the
bytes a pass moves through L1 and shared memory (``stage_bound_ms``).

Plain Python: the byte models run anywhere; the timers need a card.
"""

import sys

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet (80 GB HBM3)
# L1 and shared memory: 128 B a clock per SM (32 banks of 4 B), 132 SMs at
# the H100 SXM's 1.98 GHz maximum boost clock
ONCHIP_BYTES_PER_S = 132 * 128 * 1.98e9
L2_BYTES = 50 << 20  # the H100's L2 cache
BS = 4096  # symbols (or pending rows) per CTA of kernels A, B, C
CAP_FLUSH = 147_062_784  # the capacity of bench.py's sustained plan
M_FLUSH = 1 << 20  # the insertions of one pending flush there (R = 8)
ROW_BYTES = 6 * 4  # one int32 count row of the 6 symbols
ROWS_PER_CTA = BS // 128
STAGE_THREADS = 256  # threads per CTA of the stage kernels (common.cuh)


def require_card(what: str) -> bool:
    """False, with a message, when there is no card: a probe measures the
    card and has no CPU fallback."""
    import torch

    if torch.cuda.is_available():
        return True
    print(f"{what}: no CUDA device; this probe runs only on the card",
          file=sys.stderr)
    return False


def event_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean device time of fn() in ms over ``iters`` calls after
    ``warmup`` calls (CUDA events around the whole run)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph(step, r: int):
    """A CUDA graph of step(0) ... step(r - 1), captured after one eager
    warm-up call.  The capture records the kernels and launches none, so
    the wrappers count no launch for it; a replay runs them without
    calling the wrappers, so it is not counted either: the launch counts
    are the eager launches."""
    import torch

    step(0)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(r):
            step(i)
    torch.cuda.synchronize()
    return g


def _replay_ms(g, reps: int) -> float:
    """The best of ``reps`` timed replays of graph g, in ms."""
    import torch

    g.replay()  # warm-up
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def graph_ms(fn, iters: int = 10, reps: int = 3) -> float:
    """Device time of fn() in ms: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's launch cost is not in it (the best
    of ``reps`` replays, over iters)."""
    return _replay_ms(_graph(lambda i: fn(), iters), reps) / iters


def chain_ms(step, r_lo: int = 8, r_hi: int = 48, reps: int = 3):
    """(ms per call, ms of r_lo calls, ms of r_hi calls): step(i) chained
    r_lo and r_hi times, each chain a CUDA graph replayed ``reps`` times
    (best kept), differenced.  The difference cancels the graph's launch
    and the wait at its end, as scripts/probe_kernel_scaling.py's two
    chain lengths cancel dispatch and fetch; the graph keeps the host's
    per-call cost out, so a call shorter than its launch is still timed
    on the device."""
    lo = _replay_ms(_graph(step, r_lo), reps)
    hi = _replay_ms(_graph(step, r_hi), reps)
    return (hi - lo) / (r_hi - r_lo), lo, hi


def bound_ms(nbytes: int) -> float:
    """The least time, in ms, to move ``nbytes`` at the card's memory
    rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def merge_bytes(n: int, ins: int, alloc: int) -> int:
    """Kernel A (csrc/merge.cu): reads the n live old symbols and the
    insertion map up to the new live end L = n + ins, one start entry per
    live CTA and n; writes L output symbols and the count rows of the live
    CTAs (merge_cuda.merge leaves the rows past L unspecified)."""
    live = min(n + ins, alloc)
    na = _cdiv(live, BS)
    return (n + live + 8 * (na + 1) + 8
            + live + na * ROWS_PER_CTA * ROW_BYTES)


def merge_packed_bytes(n: int, ins: int, alloc_bytes: int) -> int:
    """Kernel C (csrc/merge_packed.cu): kernel A's model at half a byte
    per symbol for the old buffer, the packed insertion map and the
    output."""
    live = min(n + ins, 2 * alloc_bytes)
    na = _cdiv(live, BS)
    return (_cdiv(n, 2) + _cdiv(live, 2) + 8 * (na + 1) + 8
            + _cdiv(live, 2) + na * ROWS_PER_CTA * ROW_BYTES)


def pending_bytes(pcap: int, p_after: int, new: int) -> int:
    """Kernel B (csrc/pending.cu): reads the p_after - new old rows (8 B
    vp, 1 B psym), the new-slot map up to p_after, the new rows' vp and
    the live CTAs' starts; writes both planes of the p_after live rows and
    the live CTAs' count rows.  The rows past p_after hold INF/PAD before
    the call as after it, so the function need not write them (pending.cu
    does, into a fresh buffer)."""
    na = _cdiv(min(p_after, pcap), BS)
    return (9 * (p_after - new) + p_after + 8 * new + 8 * (na + 1) + 8
            + 9 * p_after + na * ROWS_PER_CTA * ROW_BYTES)


def windows_bytes(nwin: int, win: int = BS) -> int:
    """A staging of ``nwin`` windows of ``win`` bytes copied out: each
    window read once (with its int64 start) and written once."""
    return nwin * (2 * win + 8)


def stage_bytes(stage: str, ctas: int) -> int:
    """One pass of one of kernel A's stages over ``ctas`` CTAs: the part
    of kernel A's bytes that the stage moves (the old window read, the
    insertion map read, the output written, the count rows written).
    The four add up to merge_bytes with every CTA live.  Only a reference
    for the looped stages, which run on data held on the chip."""
    per_cta = {"window": BS, "scan": BS, "gather": BS,
               "counts": ROWS_PER_CTA * ROW_BYTES}[stage]
    return ctas * per_cta


def stage_bound_ms(stage: str, ctas: int, iters: int) -> float:
    """The bound of one pass of a looped stage kernel
    (csrc/probes/stages.cu) over ``ctas`` CTAs: the larger of the bytes a
    pass must move through the SMs' L1 and shared memory over their rate,
    and a launch's bytes (inputs read once, outputs written once) over
    the HBM rate, shared by its ``iters`` passes.  A pass reads the
    window from L1 and stages it in shared memory (window), reads the
    insertion map (scan), reads the staged window and writes the output
    (gather), or writes the count rows of symbols held in registers
    (counts)."""
    rows = ROWS_PER_CTA * ROW_BYTES
    onchip = {"window": 2 * BS, "scan": BS, "gather": 2 * BS,
              "counts": rows}[stage]
    acc = 4 * STAGE_THREADS  # the accumulator each thread writes
    hbm = {"window": BS + 8 + BS, "scan": BS + 4 * BS,
           "gather": BS + 16 + 8 + BS + BS, "counts": BS + rows}[stage] + acc
    return max(ctas * onchip / ONCHIP_BYTES_PER_S,
               ctas * hbm / iters / HBM_BYTES_PER_S) * 1e3


def share(bound: float, ms: float) -> float:
    """The share of the bound that a time reaches (1 is the bound)."""
    return bound / ms if ms > 0 else float("nan")
