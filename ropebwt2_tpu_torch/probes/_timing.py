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
STATUS_BYTES = 6 * 8  # kernel A's look-back status: a 64-bit word a symbol
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


def merge_bytes(n: int, ins: int, alloc: int, width: int = 4,
                tile: int = 1) -> int:
    """Kernel A (csrc/merge.cu): reads the n live old symbols and the
    insertion map up to the new live end L = n + ins, one start entry per
    live 4096-symbol block and n; writes L output symbols, the rank prefix
    rows of the live blocks and the zero row (6 entries of ``width`` bytes
    a row: 4 for int32 tables, 8 for int64; merge_cuda.run_kernel leaves
    the rows past L unspecified), and the look-back's status words of the
    live tiles of ``tile`` blocks (STATUS_BYTES each)."""
    live = min(n + ins, alloc)
    na = _cdiv(live, BS)
    return (n + live + 8 * (na + 1) + 8 + live
            + (na * ROWS_PER_CTA + 1) * 6 * width
            + _cdiv(na, tile) * STATUS_BYTES)


def merge_packed_bytes(n: int, ins: int, alloc_bytes: int) -> int:
    """Kernel C (csrc/merge_packed.cu): kernel A's model at half a byte
    per symbol for the old buffer, the packed insertion map and the
    output.  The kernel reads each packed byte of the old run once (whole
    packed rows, 16 bytes a load) and each map byte once (the two threads
    that own its planes load it in one warp instruction), and writes each
    output byte once."""
    live = min(n + ins, 2 * alloc_bytes)
    na = _cdiv(live, BS)
    return (_cdiv(n, 2) + _cdiv(live, 2) + 8 * (na + 1) + 8
            + _cdiv(live, 2) + na * ROWS_PER_CTA * ROW_BYTES)


def pending_bytes(pcap: int, p_after: int, new: int) -> int:
    """Kernel B (csrc/pending.cu): reads the p_after - new old rows (8 B
    vp, 1 B psym), the new-slot map up to p_after, the new rows' vp and
    the live CTAs' starts; writes both planes of the p_after live rows and
    the live CTAs' count rows.  The rows past p_after hold INF/PAD before
    the call as after it, so the function need not write them: pending.cu
    writes into planes the caller keeps (two pairs used in turn), only the
    CTAs below a host-known bound of p_after, and INF/PAD only from
    p_after to the end of the last such CTA."""
    na = _cdiv(min(p_after, pcap), BS)
    return (9 * (p_after - new) + p_after + 8 * new + 8 * (na + 1) + 8
            + 9 * p_after + na * ROWS_PER_CTA * ROW_BYTES)


SECTOR = 32  # bytes of the card's smallest device-memory access


def sector_bytes(start, count) -> int:
    """The bytes of the distinct SECTOR-byte sectors holding the byte
    ranges [start, start + count) (int64 tensors, count >= 0): what a
    gather of those ranges must read at the least."""
    import torch

    live = count > 0
    first = start[live] // SECTOR
    last = (start[live] + count[live] - 1) // SECTOR
    span = int((last - first).max()) + 1 if first.numel() else 0
    secs = first[:, None] + torch.arange(span, device=start.device)[None, :]
    return int(torch.unique(secs[secs <= last[:, None]]).numel()) * SECTOR


def rank_flat_bytes(pos, K: int, width: int, nrows: int,
                    nprefix: int) -> int:
    """A rank kernel (csrc/rank.cu) at the int64 positions ``pos`` of this
    call: each query's position read and its 6-entry answer written; the
    distinct 6-entry prefix rows; the distinct sectors of the rows' bytes
    below ``within`` (the bytes the count needs).  ``width``: 4 or 8 bytes
    an entry; ``nrows``: K-rows of the buffer, ``nprefix``: prefix rows."""
    import torch

    blk = torch.div(pos, K, rounding_mode="floor")
    within = pos - blk * K
    rows = blk.clamp(0, nrows - 1)
    nq = pos.numel()
    return (nq * (8 + 6 * width)
            + int(torch.unique(blk.clamp(0, nprefix - 1)).numel()) * 6 * width
            + sector_bytes(rows * K, within))


def rank_packed_bytes(pos, nprows: int) -> int:
    """The packed rank at ``pos``: the flat model over the packed rows
    (a query reads bytes of one 128-byte packed row, whose nibble plane
    holds its symbol row), its base an int64 anchor row and an int32
    relative row, its answer int64."""
    import torch

    blk = torch.div(pos, 128, rounding_mode="floor").clamp(0, 2 * nprows + 1)
    within = (pos - blk * 128).clamp(0, 128)
    brow = (blk >> 1) + (blk & 1) * (nprows + 1)
    anchor = torch.div(pos, 1 << 24, rounding_mode="floor")
    nq = pos.numel()
    return (nq * (8 + 6 * 8) + int(torch.unique(anchor).numel()) * 6 * 8
            + int(torch.unique(brow).numel()) * 6 * 4
            + sector_bytes((blk >> 1) * 128, within))


def rank_pend_bytes(g, p) -> int:
    """The pending rank at ``g`` with answers ``p`` (this call's): each
    query's g read and its p and 6 int32 counts written; the sectors of
    vp holding the rows p - 1 and p, which any search must compare g
    with; the distinct prefix rows and the sectors of the psym rows below
    p in the 128-row block of row p - 1."""
    import torch

    jb = torch.div((p - 1).clamp(min=0), 128, rounding_mode="floor")
    nq = g.numel()
    vp_lo = (8 * (p - 1)).clamp(min=0)
    return (nq * (8 + 8 + 6 * 4)
            + sector_bytes(vp_lo, torch.full_like(p, 16))
            + int(torch.unique(jb).numel()) * 6 * 4
            + sector_bytes(jb * 128, p - jb * 128))


def rank_virtual_bytes(g, p, x, K: int, width: int, nrows: int,
                       nprefix: int) -> int:
    """The one-launch virtual rank (rank_virtual) at ``g``, with this
    call's pending answers ``p`` and base positions ``x`` (g - p, clamped
    as the call clamps it): the pending rank's and the flat rank's bytes
    (rank_pend_bytes, rank_flat_bytes at x), less what the two launches
    passed through device memory: p and the pending counts written and
    read back, and the flat rank's read of its positions."""
    nq = g.numel()
    return (rank_pend_bytes(g, p) - nq * (8 + 6 * 4)
            + rank_flat_bytes(x, K, width, nrows, nprefix) - nq * 8)


def rank_virtual_packed_bytes(g, p, x, nprows: int) -> int:
    """The one-launch virtual rank over a packed base
    (rank_virtual_packed) at ``g``, with this call's pending answers ``p``
    and base positions ``x`` = g - p: the pending rank's and the packed
    rank's bytes (rank_pend_bytes, rank_packed_bytes at x), less what the
    two launches passed through device memory: p and the pending counts
    written and read back, and the packed rank's read of its positions."""
    nq = g.numel()
    return (rank_pend_bytes(g, p) - nq * (8 + 6 * 4)
            + rank_packed_bytes(x, nprows) - nq * 8)


def windows_bytes(nwin: int, win: int = BS) -> int:
    """A staging of ``nwin`` windows of ``win`` bytes copied out: each
    window read once (with its int64 start) and written once."""
    return nwin * (2 * win + 8)


def stage_bytes(stage: str, ctas: int) -> int:
    """One pass of one of kernel A's stages over ``ctas`` CTAs: the part
    of kernel A's bytes that the stage moves (the old window read, the
    insertion map read, the output written, the int32 prefix rows and the
    look-back's status words written).  The four add up to merge_bytes
    with every CTA live, less the start entries and the zero row.  Only a
    reference for the looped stages, which run on data held on the
    chip."""
    per_cta = {"window": BS, "scan": BS, "gather": BS,
               "counts": ROWS_PER_CTA * ROW_BYTES + STATUS_BYTES}[stage]
    return ctas * per_cta


def stage_bound_ms(stage: str, ctas: int, iters: int) -> float:
    """The bound of one pass of a looped stage kernel
    (csrc/probes/stages.cu) over ``ctas`` CTAs: the larger of the bytes a
    pass must move through the SMs' L1 and shared memory over their rate,
    and a launch's bytes (inputs read once, outputs written once) over
    the HBM rate, shared by its ``iters`` passes.  A pass reads the
    window from L1 and stages it in shared memory (window), reads the
    insertion map (scan), reads the staged window and writes the output
    (gather), or writes the CTA's in-CTA prefix rows of symbols held in
    registers (counts)."""
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
