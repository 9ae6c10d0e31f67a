"""Batched BCR construction on one device (counterpart of
ropebwt2_tpu/engine/bcr.py): the re-expression of mr_insert_multi
(mrope.c:258-345) as a fixed dataflow of tensor operations per round.

One round inserts the d-th symbol (from the end) of every active read:

  1. stable sort of read states by destination partition ("bucket")
  2. group detection (runs of equal interval-u within a bucket, the
     `a[k].u != a[k-1].u` grouping of mrope.c:192)
  3. two batched 6-symbol rank queries per group (rope_rank2a)
  4. closed-form insertion points in START-OF-ROUND coordinates
     (mrope.c:204-224 made order-free)
  5. one merge pass applying every insertion at once (kernel A on the
     flat tier, kernel C on the packed tier), or, in deferred mode, one
     merge into the pending side index (kernel B) with a flush into the
     base (kernel A or C) every R rounds
  6. interval update with the cross-bucket rebase (mrope.c:332-340).

The JAX package's module docstring holds the invariants that make the
start-of-round coordinates exact.  Positions are int64 throughout.  The
rounds of a batch are a host loop that never waits on the device: no
value is read back inside a batch.
"""

import dataclasses
import math

import numpy as np
import torch

from ..alphabet import NSYM, SO_IO, SO_RCLO, SO_RLO
from ..index.flat import FlatBwt, empty_state, grow_state
from ..index.merge_cuda import merge
from ..index.merge_packed_cuda import merge_packed
from ..index.packed import (
    PackedFlatBwt,
    grow_packed_state,
    packed_from_flat,
    rank_global_packed,
    unpack_bwt,
)
from ..index.pending import (
    empty_pending,
    pending_add,
    pending_cap,
    pending_flush_args,
    rank_virtual_base,
    reset_pending,
)
from ..index.rank import rank_global

I64 = torch.int64
PLAN_ALIGN = 1 << 17  # upfront-plan capacity rounding (the JAX package's)
PACK_ALIGN = 1 << 20  # capacity rounding of the packed tier
PACK4_AUTO = 1 << 31  # pack4="auto": pack past 2^31 symbols (the JAX rule)


@dataclasses.dataclass
class ReadStates:
    """Per-read BCR state (the reference's triple64_t, mrope.c:174-178),
    re-permuted by the bucket sort every round.

    ``pk = (off // 8) << 3 | c`` packs the read's 8-aligned buffer offset
    with its last inserted symbol c; pk < 0 marks padding rows.  The buffer
    holds a 0 terminator after each read, so the terminator round inserts
    the sentinel and sets c to 0, which retires the row."""

    l: torch.Tensor  # int64[M] interval lower bound, local to partition c
    u: torch.Tensor  # int64[M] interval upper bound
    pk: torch.Tensor  # int64[M] packed (off // 8) << 3 | c


def _insertion_order(so):
    """The symbols in their emission order within a group: $ first, then
    A..T (T..A for RCLO), then N (mrope.c:206-224)."""
    mid = (4, 3, 2, 1) if so == SO_RCLO else (1, 2, 3, 4)
    return (0, *mid, 5)


def _excl_rows(x):
    """Exclusive cumsum over rows of a (6, S) table, padded to 8 rows with
    zeros: indexing it with c = pk & 7 gives 0 on padding rows (c = 7)."""
    c = torch.cumsum(x, 0)
    z = torch.zeros((1, x.shape[1]), dtype=x.dtype, device=x.device)
    return torch.cat([z, c[:-1], z, z])


def _scan0(op, x):
    """op (torch.cumsum / cummax / cummin) down the rows of an (M, S)
    table, run along the last dimension of its transpose: PyTorch's CUDA
    scan along the first dimension of a narrow table walks each column in
    one thread."""
    y = op(x.t().contiguous(), dim=1)
    return (y if isinstance(y, torch.Tensor) else y.values).t()


def _emitted_before(x, order):
    """W[:, t] = sum of x[:, s] over the symbols s emitted before t: an
    exclusive running sum of the columns in emission order."""
    cols = [None] * NSYM
    running = torch.zeros_like(x[:, 0])
    for s in order:
        cols[s] = running
        running = running + x[:, s]
    return torch.stack(cols, dim=1)


def _take(t, idx):
    """t[m, idx[m]] for a (M, S) table."""
    return t.gather(1, idx[:, None])[:, 0]


def plan_round(psize, pcounts, reads: ReadStates, buf, d: int,
               is_first: bool, rank_fn, *, so):
    """Steps 1-4 and 6 of one round.  ``rank_fn(gpos) -> (M, 6)`` gives
    6-symbol ranks at global positions (the base table, or base + pending).

    Returns (new_reads, gX, sym, stream, active, ins_bucket, n_ins); gX and
    stream are meaningful on active rows only."""
    dev = reads.l.device
    M = reads.l.shape[0]
    arange_m = torch.arange(M, device=dev)

    # ---- 1. stable sort by bucket (mrope.c:303-310) ----
    pk0 = reads.pk
    key = torch.where(pk0 < 0, 0, pk0 & 7)
    perm = torch.argsort(key, stable=True)
    l, u, pk = reads.l[perm], reads.u[perm], pk0[perm]
    dead = pk < 0
    c = pk & 7  # 7 on padding rows

    # done: the sentinel went in an earlier round (bucket 0); in the first
    # round every real read is active with c == 0 (mrope.c:279-285)
    inert = dead | ((c == 0) & (not is_first))
    active = ~inert

    # ---- next symbol of each read (reads are stored reversed) ----
    off = (pk >> 3) * 8
    sym = buf[(off + d).clamp(0, buf.shape[0] - 1)].long()
    sym = torch.where(active, sym, 0)

    # ---- 2. groups: runs of equal (inert, bucket, u) ----
    tkey = c * 2 + inert.long()
    bucket_head = (arange_m == 0) | (tkey != torch.roll(tkey, 1))
    head = bucket_head | (u != torch.roll(u, 1))
    hh = torch.stack([torch.where(head, arange_m, 0),
                      torch.where(bucket_head, arange_m, 0)], dim=1)
    hh = _scan0(torch.cummax, hh)
    headidx, bktheadidx = hh[:, 0], hh[:, 1]

    # stored intervals are in progressive coordinates; E = reads in earlier
    # groups of this bucket recovers start-of-round coordinates
    E = headidx - bktheadidx
    L = l - E
    U = u - E

    # ---- 3. rank at the group interval ends ----
    poff = _excl_rows(psize[:, None])[:, 0]  # partition offsets, 8 rows
    pprefix = _excl_rows(pcounts)  # [b, s] = count of s in partitions < b
    poc = poff[c]
    pprefix_c = pprefix[c]
    gLq = poc + L
    TLr = rank_fn(gLq).long()
    if so == SO_IO:
        # input order keeps every interval empty (l == u by induction)
        delta = torch.zeros_like(TLr)
    else:
        # exact on every active row: rank(U) - rank(L) is 0 for an empty
        # interval, so no width test (and no host sync) is needed
        delta = rank_fn(poc + U).long() - TLr
    TL = TLr - pprefix_c

    # ---- 4. insertion points per symbol, start-of-round local coords ----
    # X[:, s] = L + the interval's counts of the symbols emitted before s
    order = _insertion_order(so)
    X = L[:, None] + _emitted_before(delta, order)
    gX = poc + _take(X, sym)

    # ---- per-row / per-group combinatorics ----
    oh = (sym[:, None] == torch.arange(NSYM, device=dev)[None, :]) \
        & active[:, None]
    oh = oh.long()
    csum = _scan0(torch.cumsum, oh)  # inclusive
    excl = csum - oh

    Wc = _emitted_before(csum, order)
    We = _emitted_before(excl, order)
    is_tail = torch.cat([head[1:], head.new_ones(1)])
    fwd = _scan0(torch.cummax, torch.cat([
        torch.where(head[:, None], excl, 0),
        torch.where(bucket_head[:, None], excl, 0),
        torch.where(head[:, None], We, 0),
    ], dim=1))
    head_excl, bkt_excl = fwd[:, :NSYM], fwd[:, NSYM:2 * NSYM]
    We_head = fwd[:, 2 * NSYM:]
    big = torch.iinfo(I64).max
    Wc_tail = _scan0(
        torch.cummin, torch.where(is_tail[:, None], Wc, big).flip(0)
    ).flip(0)
    before_in_group = _take(Wc_tail - We_head, sym)
    P_sym = _take(head_excl - bkt_excl, sym)  # by earlier groups of bucket

    # per-bucket inserted-symbol totals (rows 6-7 take the padding rows'
    # zeros)
    ins_bucket = torch.zeros((8, NSYM), dtype=I64, device=dev)
    ins_bucket.index_add_(0, c, oh)
    ins_bucket = ins_bucket[:NSYM]
    ac_excl = _excl_rows(pcounts + ins_bucket)

    # ---- global tie rank (stream index) of each insertion ----
    rank_in_run = _take(excl - head_excl, sym)
    stream = headidx - inert.sum() + before_in_group + rank_in_run

    # ---- interval update (+ fused cross-bucket rebase) ----
    l_new = _take(TL, sym) + P_sym + _take(ac_excl[c], sym)
    u_new = l_new + _take(delta, sym)
    l = torch.where(active, l_new, l)
    u = torch.where(active, u_new, u)
    pk = torch.where(active, (pk & ~7) | sym, pk)

    n_ins = active.sum()
    return (ReadStates(l=l, u=u, pk=pk), gX, sym, stream, active,
            ins_bucket, n_ins)


def _state_rank_fn(state, K):
    """rank_fn(gpos) -> (M, 6) over the base of either tier."""
    if isinstance(state, PackedFlatBwt):
        return lambda g: rank_global_packed(state.pbwt, state.blkA,
                                            state.blkB, g)
    return lambda g: rank_global(state.bwt, state.blk_prefix, g, K)


def _state_merge(state, pos, sym, stream, valid, n, K):
    """The state with the insertions merged into its buffer and its rank
    tables rebuilt: kernel C on the packed tier, kernel A on the flat."""
    if isinstance(state, PackedFlatBwt):
        pbwt, blkA, blkB = merge_packed(state.pbwt, pos, sym, stream, valid,
                                        n, K)
        return dataclasses.replace(state, pbwt=pbwt, blkA=blkA, blkB=blkB)
    bwt, blk = merge(state.bwt, pos, sym, stream, valid, n, K)
    return dataclasses.replace(state, bwt=bwt, blk_prefix=blk)


def bcr_round(state, reads: ReadStates, buf, d: int, is_first: bool, *, K,
              so):
    """One round merged straight into the base (kernel A or C).  Returns
    (new_state, new_reads)."""
    new_reads, gX, sym, stream, active, ins_bucket, n_ins = plan_round(
        state.psize, state.pcounts, reads, buf, d, is_first,
        _state_rank_fn(state, K), so=so,
    )
    new_state = dataclasses.replace(
        _state_merge(state, gX, sym, stream, active, state.n, K),
        n=state.n + n_ins, psize=state.psize + ins_bucket.sum(1),
        pcounts=state.pcounts + ins_bucket,
    )
    return new_state, new_reads


def _flush_pending(st, pend, *, K):
    """Apply the whole pending set to the base in one merge (kernel A or C)
    and reset the pending index.  st.n/psize/pcounts already hold the
    virtual totals; only the buffer and its rank tables change."""
    pos, sym, stream, valid = pending_flush_args(pend)
    return _state_merge(st, pos, sym, stream, valid, st.n - pend.p, K), \
        reset_pending(pend)


def bcr_batch_deferred(state, reads, buf, n_rounds: int, *, K, so, defer_r,
                       pcap):
    """All rounds of one batch with the base frozen for ``defer_r`` rounds
    at a time: each round's insertions merge into the pending index
    (kernel B), ranks come from base + pending, and the pending set is
    flushed into the base every defer_r rounds (kernel A or C).  ``pcap``
    must be >= defer_r * (rows per round)."""
    pend = empty_pending(pcap, state.n.device)
    st, rd = state, reads
    for lo in range(0, n_rounds, defer_r):
        base_fn = _state_rank_fn(st, K)  # the base is frozen meanwhile
        n, psize, pcounts = st.n, st.psize, st.pcounts
        for d in range(lo, min(lo + defer_r, n_rounds)):
            rd, gX, sym, stream, active, ins_bucket, n_ins = plan_round(
                psize, pcounts, rd, buf, d, d == 0,
                lambda g: rank_virtual_base(base_fn, pend, g), so=so,
            )
            pend = pending_add(pend, gX, sym, stream, active)
            n = n + n_ins
            psize = psize + ins_bucket.sum(1)
            pcounts = pcounts + ins_bucket
        st = dataclasses.replace(st, n=n, psize=psize, pcounts=pcounts)
        st, pend = _flush_pending(st, pend, K=K)
    return st, rd


def bcr_batch(state, reads, buf, n_rounds: int, *, K, so, defer_r=0,
              pcap=0):
    """All rounds of one batch: merged every round, or deferred when
    defer_r > 0 (bcr_batch_deferred)."""
    if defer_r > 0:
        return bcr_batch_deferred(state, reads, buf, n_rounds, K=K, so=so,
                                  defer_r=defer_r, pcap=pcap)
    for d in range(n_rounds):
        state, reads = bcr_round(state, reads, buf, d, d == 0, K=K, so=so)
    return state, reads


def _round_up(x, m):
    return -(-x // m) * m


def _pad_pow2(x, lo=16):
    n = lo
    while n < x:
        n *= 2
    return n


class TorchBwt:
    """Host-side driver, the mrope_t equivalent: batched insertion
    (mr_insert_multi), single-string insertion, incremental growth across
    batches, and export of the BWT.  Flat int8 tier, switching to the 4-bit
    packed tier (index/packed.py) once a build plans past a threshold.

    ``defer_r``: None picks the pending depth R from the capacity per batch
    (_choose_defer), 0 merges every round, R > 1 defers R rounds.
    ``device``: where the index lives; None means the card, and raises
    when there is none (pass device="cpu" for the plain versions).
    ``pack4``: the packed-tier threshold, as the JAX package's
    ROPEBWT2_TPU_PACK4: "auto" packs once the planned total passes 2^31
    symbols, 0 never packs, and an integer T packs past T symbols (K must
    then be 128)."""

    def __init__(self, so=SO_IO, K=128, defer_r=None, device=None,
                 pack4="auto"):
        if so not in (SO_IO, SO_RLO, SO_RCLO):
            raise ValueError(f"unknown sorting order {so}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBwt: no CUDA device; pass device='cpu' to build "
                    "on the CPU with the plain versions of the kernels")
            device = "cuda"
        if pack4 == "auto":
            self._pack_thr = PACK4_AUTO
        elif isinstance(pack4, int) and pack4 >= 0:
            self._pack_thr = pack4 or None
        else:
            raise ValueError(f"pack4 must be 'auto' or an int >= 0: {pack4!r}")
        self.so = so
        self.K = K
        self.device = torch.device(device)
        self.state = empty_state(K, K, self.device)
        # host mirrors: the driver never reads device scalars mid-build
        self._n = 0  # total symbols
        self._n_strings = 0  # total strings (== sentinel count)
        self._defer_cfg = -1 if defer_r is None else defer_r

    def _choose_defer(self, mpad):
        """(defer_r, pcap) for the next batch.  Auto mode balances the
        full-prefix flush (~ cap) against the per-round pending work
        (~ R * mpad): R* = sqrt(ratio * cap / mpad).  The ratio 0.055 is
        the JAX package's, kept so that R and pcap match it shape for
        shape until it is fitted on this card."""
        if self._defer_cfg >= 0:
            r = self._defer_cfg
        else:
            ratio = 0.055 * self.state.cap / max(mpad, 1)
            r = int(math.sqrt(ratio)) if ratio >= 1 else 0
            if r < 4:
                r = 0  # shallow deferral does not pay for the pending work
            else:
                r = 1 << min(6, (r - 1).bit_length())  # pow2 >= r, <= 64
        if r <= 1:
            return 0, 0
        return r, pending_cap(mpad, r)

    def _plan(self, extra_symbols: int):
        """Grow the capacity to hold ``extra_symbols`` more.  Past the
        pack4 threshold the index is (or becomes) packed, its capacity
        rounded linearly to PACK_ALIGN.  Otherwise an upfront plan (>= 4x
        the capacity, >= 2^24) rounds linearly to PLAN_ALIGN, and
        incremental growth to a power of two."""
        need = self._n + extra_symbols
        cap = self.state.cap
        is_packed = isinstance(self.state, PackedFlatBwt)
        if self._pack_thr is not None and (need > self._pack_thr
                                           or is_packed):
            if self.K != 128:
                raise ValueError(f"the packed tier needs K = 128, not "
                                 f"{self.K}")
            new_cap = _round_up(cap if need <= cap else
                                _round_up(need, PACK_ALIGN), 256)
            if is_packed:
                self.state = grow_packed_state(self.state, new_cap)
            else:
                if cap % 256:
                    self.state = grow_state(self.state, _round_up(cap, 256),
                                            self.K)
                self.state = packed_from_flat(self.state, new_cap)
            return
        if need <= cap:
            return
        if need >= 4 * cap and need >= (1 << 24):
            cap = _round_up(need, max(PLAN_ALIGN, self.K))
        else:
            cap = _round_up(_pad_pow2(need, lo=self.K), self.K)
        self.state = grow_state(self.state, cap, self.K)

    # --- the public insertion API ---

    def insert_multi(self, reads, already_reversed=False):
        """Insert a batch of reads column by column.  ``reads`` is a list
        of nt6 code arrays or an (m, L) matrix; unless ``already_reversed``
        they are in original orientation and are reversed here
        (main.c:200-203).  Each read is stored 8-aligned with a 0
        terminator (the ReadStates.pk layout)."""
        m = len(reads)
        if m == 0:
            return
        if isinstance(reads, np.ndarray) and reads.ndim == 2:
            ln = reads.shape[1]
            lens = np.full(m, ln, dtype=np.int64)
            stride = _round_up(ln + 1, 8)
            buf = np.zeros(m * stride, dtype=np.int8)
            mat = reads.astype(np.int8, copy=False)
            if not already_reversed:
                mat = mat[:, ::-1]
            buf.reshape(m, stride)[:, :ln] = mat
            starts = np.arange(m, dtype=np.int64) * stride
        else:
            lens = np.array([len(r) for r in reads], dtype=np.int64)
            strides = (lens + 8) & ~np.int64(7)  # round_up(len + 1, 8)
            starts = np.concatenate([[0], np.cumsum(strides)[:-1]])
            buf = np.zeros(int(strides.sum()), dtype=np.int8)
            for i, r in enumerate(reads):
                rv = np.asarray(r, dtype=np.int8)
                if not already_reversed:
                    rv = rv[::-1]
                buf[starts[i]: starts[i] + len(rv)] = rv
        total = int(lens.sum()) + m  # symbols + sentinels
        self._plan(total)
        self._run_batch(buf, starts, total, int(lens.max()))

    def insert_nul_batch(self, nulbuf: np.ndarray):
        """Insert a batch given as a buffer of NUL-terminated, insertion-
        oriented strings (the reference's -m batch buffer, mrope.c:269-277),
        re-packed to 8-aligned starts."""
        nulbuf = np.ascontiguousarray(nulbuf).view(np.int8)
        ends = np.flatnonzero(nulbuf == 0)
        if len(ends) == 0:
            return
        total = int(nulbuf.shape[0])  # symbols + sentinels
        if ends[-1] != total - 1:
            raise ValueError("batch must end with a terminator")
        self._plan(total)
        starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
        lens = (ends - starts).astype(np.int64)
        strides = (lens + 8) & ~np.int64(7)
        astarts = np.concatenate([[0], np.cumsum(strides)[:-1]])
        buf = np.zeros(int(strides.sum()), dtype=np.int8)
        buf[(astarts - starts).repeat(lens + 1) + np.arange(total)] = nulbuf
        self._run_batch(buf, astarts, total, int(lens.max()))

    def _run_batch(self, buf, starts, total, max_len):
        """Lay out the read states (padding rows first, up to a power of
        two, as the JAX package does) and run every round of the batch."""
        m = len(starts)
        mpad = _pad_pow2(m)
        npad = mpad - m
        pk = np.full(mpad, -1, dtype=np.int64)
        pk[npad:] = starts  # 8-aligned: off == (off // 8) << 3, c = 0
        l = np.zeros(mpad, dtype=np.int64)
        u = np.zeros(mpad, dtype=np.int64)
        if self.so == SO_IO:
            l[npad:] = self._n_strings + np.arange(m)
            u[npad:] = l[npad:]
        else:
            u[npad:] = self._n_strings
        dev = self.device
        reads = ReadStates(l=torch.from_numpy(l).to(dev),
                           u=torch.from_numpy(u).to(dev),
                           pk=torch.from_numpy(pk).to(dev))
        defer_r, pcap = self._choose_defer(mpad)
        self.state, _ = bcr_batch(
            self.state, reads, torch.from_numpy(buf).to(dev), max_len + 1,
            K=self.K, so=self.so, defer_r=defer_r, pcap=pcap,
        )
        self._n += total
        self._n_strings += m

    def insert1(self, read):
        """Single-string insertion (mr_insert1): a one-read batch gives the
        same output (tex/ropebwt2.tex:108-110)."""
        self.insert_multi([read])

    # --- export ---

    @property
    def n(self) -> int:
        return self._n

    def counts(self):
        """Global per-symbol counts ($,A,C,G,T,N), like mr_get_c."""
        return self.state.pcounts.sum(dim=0).cpu().numpy()

    def bwt_array(self) -> np.ndarray:
        """The full BWT as an int8 numpy array (a packed index unpacks the
        packed rows that cover it, on its device)."""
        if isinstance(self.state, PackedFlatBwt):
            nbytes = -(-self._n // 256) * 128
            return unpack_bwt(self.state.pbwt[:nbytes])[: self._n].cpu().numpy()
        return self.state.bwt[: self._n].cpu().numpy()

    def runs(self):
        """Run-length view [(sym, len), ...] of the BWT."""
        b = self.bwt_array()
        if b.size == 0:
            return []
        change = np.flatnonzero(np.diff(b)) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [b.size]])
        return [(int(b[s]), int(e - s)) for s, e in zip(starts, ends)]
