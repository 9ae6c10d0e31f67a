"""Pending-insertion side index: multi-round insertion buffering
(counterpart of ropebwt2_tpu/index/pending.py, whose module docstring
holds the derivation).

The base buffer and its rank table stay frozen for R rounds while each
round's insertions merge into a sorted side index; rank queries against
the virtual (base + pending) sequence are answered as

    rank_virtual(g) = rank_base(g - p) + pending_prefix(p),
    p = |{ i : vp[i] < g }|,

and every R rounds the whole set is flushed into the base with one merge.

State (all on the device, static capacity pcap):

* ``vp``   int64[pcap] virtual positions, strictly increasing; INF beyond p
* ``psym`` int8[pcap]  inserted symbols; PAD beyond p
* ``blk_prefix`` int32[pcap//KP+1, 6] per-symbol prefix counts at every
  KP-row boundary of psym
* ``p``    int64 0-dim live count

Where the JAX package's pending_add returns new arrays, the port keeps TWO
plane pairs and updates them in place, in turn: a round's merge reads the
pair that holds the rows and writes the other (``spare``), which held the
rows of two rounds ago.  ``p`` only grows between flushes, so the spare
pair's rows at or past ``p`` still hold INF/PAD, and the merge writes only
the 4096-row blocks that can hold live rows (``bound``, a host-known upper
bound of ``p``: rows per round times rounds since the flush, no device
read).  A flush refills both pairs (reset_pending).  So pending_add
CONSUMES the index it is given: its planes become the result's spare pair
and are overwritten by the next pending_add.
"""

import dataclasses
import typing

import torch

from ..alphabet import NSYM
from .flat import PAD
from .rank import block_counts, prefix_rows, rank_global
from . import pending_cuda, rank_cuda

KP = 128  # pending rank-table block size
# empty-row sentinel, the JAX package's _inf(int64): headroom keeps
# INF + a round's shift from overflowing before the clamp
INF = (1 << 63) - 1 - (1 << 28)


@dataclasses.dataclass
class PendingIndex:
    vp: torch.Tensor  # int64[pcap]
    psym: torch.Tensor  # int8[pcap]
    blk_prefix: torch.Tensor  # int32[pcap // KP + 1, 6]
    p: torch.Tensor  # int64 0-dim
    # the (vp, psym) pair the next pending_add writes, INF/PAD at or past
    # p; None: that merge takes fresh planes
    spare: typing.Optional[tuple] = None
    # host-known upper bound of p; None: unknown (the capacity)
    bound: typing.Optional[int] = None

    @property
    def cap(self) -> int:
        return self.vp.shape[0]


def pending_cap(max_rows_per_round: int, R: int) -> int:
    """Static pending capacity for R rounds of <= max_rows_per_round
    insertions: a multiple of 256, and of 131072 once that large (the same
    capacities as the JAX package)."""
    need = max(max_rows_per_round * R, 256)
    if need >= (1 << 17):
        return -(-need // (1 << 17)) * (1 << 17)
    return -(-need // 256) * 256


def empty_pending(pcap: int, device) -> PendingIndex:
    if pcap % 256:
        raise ValueError(f"pending capacity {pcap} is not a multiple of 256")
    return PendingIndex(
        vp=torch.full((pcap,), INF, dtype=torch.int64, device=device),
        psym=torch.full((pcap,), PAD, dtype=torch.int8, device=device),
        blk_prefix=torch.zeros((pcap // KP + 1, NSYM), dtype=torch.int32,
                               device=device),
        p=torch.zeros((), dtype=torch.int64, device=device),
        spare=pending_cuda.fresh_planes(pcap, device),
        bound=0,
    )


def reset_pending(pend: PendingIndex) -> PendingIndex:
    """The empty index of pend's capacity, in pend's own planes: both pairs
    are refilled with INF/PAD in place, over the blocks a merge since the
    last reset can have written (all of them when the bound is unknown)."""
    pcap = pend.cap
    hi = pending_cuda.n_blocks(pcap, pend.bound) * pending_cuda.BS
    pairs = [(pend.vp, pend.psym),
             pend.spare or pending_cuda.fresh_planes(pcap, pend.vp.device)]
    for vp, psym in pairs:
        vp[:hi].fill_(INF)
        psym[:hi].fill_(PAD)
    return PendingIndex(
        vp=pairs[0][0], psym=pairs[0][1],
        blk_prefix=torch.zeros_like(pend.blk_prefix),
        p=torch.zeros_like(pend.p), spare=pairs[1], bound=0,
    )


def pending_rank(pend: PendingIndex, g):
    """(p, occ): p[q] = |{ i : vp[i] < g[q] }| and occ[q, s] = the count of
    symbol s among those rows (int32).  One searchsorted, then one gather
    of the 128-row block holding the last row below g."""
    p = torch.searchsorted(pend.vp, g.contiguous())
    jb = (p - 1).clamp(min=0) // KP
    srows = pend.psym.view(-1, KP)[jb]  # (Q, KP)
    row = jb[:, None] * KP + torch.arange(KP, device=g.device)[None, :]
    below = row < p[:, None]
    sym = torch.arange(NSYM, dtype=srows.dtype, device=g.device)
    eq = (srows[:, :, None] == sym[None, None, :]) & below[:, :, None]
    occ = pend.blk_prefix[jb] + eq.sum(dim=1, dtype=torch.int32)
    return p, occ


def rank_virtual(bwt, blk_prefix, pend: PendingIndex, g, K: int, lo=None,
                 hi=None):
    """6-symbol rank of the virtual (base + pending) sequence at ``g`` over
    a flat base (the JAX package's rank_virtual), in blk_prefix's dtype:
    rank_global at g - p, clamped to [lo, hi] when given, plus the pending
    counts.  Plain version of rank_cuda.rank_virtual_flat, the flat tier's
    deferred rank in one launch."""
    p, extra = pending_rank(pend, g)
    x = g - p
    if lo is not None or hi is not None:
        x = x.clamp(lo, hi)
    out = rank_global(bwt, blk_prefix, x, K)
    return out + extra.to(out.dtype)


def rank_virtual_base(base_rank_fn, pend: PendingIndex, g):
    """6-symbol rank of the virtual (base + pending) sequence at ``g``, with
    the base answered by base_rank_fn(pos, sub, extra) -> rank(pos - sub) +
    extra, (Q, 6) (rank_cuda's convention): on the packed tier the rank
    kernels' two launches, the pending count's and the base count's; the
    run tier's base is plain torch."""
    p, extra = rank_cuda.pending_rank(pend, g)
    return base_rank_fn(g, sub=p, extra=extra)


def pending_add(pend: PendingIndex, gX, sym, stream, active) -> PendingIndex:
    """Merge one round's insertions into the pending set.

    gX/stream: int64[M] old-coordinate insertion points and tie ranks (tie
    ranks unique in [0, A) over the A active rows); sym: int64[M];
    active: bool[M].  The old rows and the row counts come from the
    pending merge kernel (pending_cuda.merge), whose plain version is
    merge_rows below.  ``pend`` is consumed: the result is written into
    its spare planes, and its own planes become the result's spare."""
    varr, sarr, start_new, p_after = new_rows(pend, gX, sym, stream, active)
    pcap = pend.cap
    bound = min(pcap, (pcap if pend.bound is None else pend.bound)
                + gX.shape[0])
    vp, psym, rows = pending_cuda.merge(
        pend.vp, pend.psym, varr, sarr, start_new, p_after, pend.spare, bound
    )
    return PendingIndex(vp=vp, psym=psym,
                        blk_prefix=prefix_rows(rows, torch.int32), p=p_after,
                        spare=(pend.vp, pend.psym), bound=bound)


def new_rows(pend: PendingIndex, gX, sym, stream, active):
    """The pending merge's inputs besides the old planes: (varr, sarr,
    start_new, p_after).  New row r lands at merged slot stream[r] + k[r]
    with k[r] = |{ i : vp[i] < gX[r] }| (the JAX package's proof), where
    varr holds its virtual position gX + stream and sarr its symbol + 1;
    start_new is the exclusive prefix of new rows per kernel block,
    counted from the M rows rather than from the pcap slots.  varr is
    meaningful at the new slots only (the merge reads it nowhere else), so
    its other slots are not filled."""
    pcap = pend.cap
    dev = pend.vp.device
    k = torch.searchsorted(
        pend.vp, torch.where(active, gX, INF).contiguous()
    )
    slot = torch.where(active, stream + k, pcap)  # pcap: trash slot
    sarr = torch.zeros(pcap + 1, dtype=torch.int8, device=dev)
    sarr.scatter_(0, slot, torch.where(active, sym + 1, 0).to(torch.int8))
    varr = torch.empty(pcap + 1, dtype=torch.int64, device=dev)
    varr.scatter_(0, slot, gX + stream)
    nb = -(-pcap // pending_cuda.BS)
    blk = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    blk.index_add_(0, torch.where(active, slot // pending_cuda.BS, nb),
                   torch.ones_like(slot))
    start_new = torch.cat([blk.new_zeros(1), torch.cumsum(blk[:nb], 0)])
    return varr[:pcap], sarr[:pcap], start_new, pend.p + active.sum()


def merge_rows(vp, psym, varr, sarr, start_new, p_after, out, bound=None):
    """Plain version of the pending merge kernel: the JAX package's XLA
    ladder.  New slots (sarr != 0) take (varr, sarr - 1); old rows shift by
    s (the count of new rows before them), are clamped to INF, and move
    to their merged slot by a log-shift expand.  As pending_cuda.merge
    does from the same arguments, it writes the rows below
    n_blocks(pcap, bound) * BS into the ``out`` planes, leaves the rows
    past them untouched, and returns (out vp, out psym, row_counts
    int32[pcap // KP, 6]) with zero count rows past the written blocks.
    ``start_new`` and ``p_after`` are unused: the expand needs no block
    prefix, and rows past p_after come out INF/PAD from it."""
    del start_new, p_after
    pcap = vp.shape[0]
    dev = vp.device
    is_new = sarr != 0
    c = torch.cumsum(is_new, 0)  # new rows at or before each slot
    # a new row at slot q has k = q - (new rows before it); s = hist of k
    k = torch.arange(pcap, device=dev) - (c - 1)
    hist = torch.zeros(pcap + 1, dtype=torch.int64, device=dev)
    hist.index_add_(0, torch.where(is_new, k, pcap), torch.ones_like(k))
    s = torch.cumsum(hist[:pcap], 0)
    vo = (vp + s).clamp(max=INF)
    so = psym
    for kk in range(max(pcap.bit_length() - 1, 0), -1, -1):
        step = 1 << kk
        if step >= pcap:
            continue
        take = ((c >> kk) & 1) == 1
        vo = torch.where(take, torch.cat([vo.new_full((step,), INF),
                                          vo[:-step]]), vo)
        so = torch.where(take, torch.cat([so.new_full((step,), PAD),
                                          so[:-step]]), so)
    hi = pending_cuda.n_blocks(pcap, bound) * pending_cuda.BS
    out[0][:hi] = torch.where(is_new, varr, vo)[:hi]
    out[1][:hi] = torch.where(is_new, sarr - 1, so)[:hi]
    rows = block_counts(out[1], KP)
    rows[hi // KP:] = 0
    return out[0], out[1], rows


def pending_flush_args(pend: PendingIndex):
    """(pos, sym, stream, valid) for the base merge: row i is an insertion
    at base position vp[i] - i with tie rank i."""
    iota = torch.arange(pend.cap, device=pend.vp.device)
    valid = iota < pend.p
    pos = torch.where(valid, pend.vp - iota, 0)
    return pos, pend.psym.long(), iota, valid
