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
     flat tier, kernel C on the packed tier, the run insertion of
     index/runs.py on the run tier), or, in deferred mode, one merge into
     the pending side index (kernel B) with a flush into the base every R
     rounds
  6. interval update with the cross-bucket rebase (mrope.c:332-340).

The JAX package's module docstring holds the invariants that make the
start-of-round coordinates exact.  Positions are int64 throughout.  The
rounds of a batch are a host loop that never waits on the device: no
value is read back inside a batch.  Rounds of reads of any length run the
same loop, thousands of them for kilobase reads: engine/graph.py's
runner, which on the card replays the deferred rounds of the flat and the
packed tier as CUDA graphs (the counterpart of the JAX package's jitted
batch loop).  The run tier reads its slot count and overflow flag once
after each batch.
"""

import dataclasses
import math

import numpy as np
import torch

from ..alphabet import NSYM, SO_IO, SO_RCLO, SO_RLO
from ..index.flat import FlatBwt, empty_state, grow_state, resolve_device
from ..index.merge_cuda import merge
from ..index.merge_packed_cuda import merge_packed
from ..index.packed import (
    PackedFlatBwt,
    grow_packed_state,
    packed_from_flat,
    unpack_bwt,
)
from ..index.pending import (
    pending_add,
    pending_cap,
    pending_flush_args,
    rank_virtual_base,
    reset_pending,
)
from ..index import rank_cuda
from ..index.runs import (
    RCAP_ALIGN,
    RUN_LEN_MAX,
    RunBwt,
    _rebuild_tables,
    apply_insertions_runs,
    gdt_for_symbols,
    grow_runs_state,
    rank_global_runs,
    rcap_for_slots,
    run_ends,
    runs_from_arrays,
    slot_lengths,
)
from ..parallel.comm import LocalComm
from ..utils import trace

I32, I64 = torch.int32, torch.int64
LOCAL = LocalComm()
PLAN_ALIGN = 1 << 17  # upfront-plan capacity rounding (the JAX package's)
PACK_ALIGN = 1 << 20  # capacity rounding of the packed tier
PACK4_AUTO = 1 << 31  # pack4="auto": pack past 2^31 symbols (the JAX rule)
RUN_CHUNK = 1 << 28  # symbols per chunk of the run export (run_arrays)


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


def _emitted_before(x, order):
    """W[:, t] = sum of x[:, s] over the symbols s emitted before t: an
    exclusive running sum of the columns in emission order."""
    cols = [None] * NSYM
    cols[order[0]] = torch.zeros_like(x[:, 0])
    cols[order[1]] = running = x[:, order[0]]
    for prev, s in zip(order[1:], order[2:]):
        cols[s] = running = running + x[:, prev]
    return torch.stack(cols, dim=1)


def _take(t, idx):
    """t[m, idx[m]] for a (M, S) table."""
    return t.gather(1, idx[:, None])[:, 0]


def bucket_totals(comm, key, pre):
    """int64[6, 6]: [b, s] = the rows of bucket b that insert s, over every
    rank.  ``key`` holds the rows' buckets in sorted order and ``pre`` is
    comm.prefix_rows of the rows' one-hot symbols, so a bucket's totals are
    pre at its end less pre at its start (a rank's share on a ShardComm
    rank, then summed over the ranks)."""
    bounds = torch.searchsorted(key, torch.arange(NSYM + 1,
                                                  device=key.device))
    return comm.psum_array(pre[bounds].diff(dim=0).long())


@trace.spanned("plan")
def plan_round(psize, pcounts, reads: ReadStates, buf, d,
               is_first, rank_fn, *, so, comm=None):
    """Steps 1-4 and 6 of one round.  ``rank_fn(gpos) -> (M, 6)`` gives
    6-symbol ranks at global positions (the base table, or base + pending).
    ``d`` is the round (the symbol column), an int or a 0-dim int64 tensor
    on the device (engine/graph.py, whose CUDA graphs replay a round for
    every d); ``is_first`` is d == 0, a bool, or None to derive it from d
    on the device.

    ``comm`` carries the few global steps (the bucket sort, the symbol
    fetch, the running counts, the lookups at flagged rows, the boundary
    rolls, the sums): None is one device (parallel/comm.py::LocalComm); a
    ShardComm runs the same plan on this rank's block of the read states
    (parallel/sharded.py).  Where the JAX plan scans down the rows with
    cummax and cummin, each scan carries a value from one row of the row's
    group (its head, its bucket's head, its last row), so here each is a
    lookup at that row, in the column of the row's symbol.

    Returns (new_reads, gX, sym, stream, active, ins_bucket, n_ins); gX and
    stream are meaningful on active rows only."""
    if comm is None:
        comm = LOCAL
    dev = reads.l.device
    M = reads.l.shape[0]  # this rank's rows

    with trace.span("plan.sort"):
        # ---- 1. stable sort by bucket (mrope.c:303-310) ----
        pk0 = reads.pk
        key = torch.where(pk0 < 0, 0, pk0 & 7)
        l, u, pk = comm.sort(key, (reads.l, reads.u, pk0))
        dead = pk < 0
        c = pk & 7  # 7 on padding rows

        # done: the sentinel went in an earlier round (bucket 0); in the first
        # round every real read is active with c == 0 (mrope.c:279-285)
        if is_first is None:
            later = d != 0
        else:
            later = not is_first
        inert = dead | ((c == 0) & later)
        active = ~inert

        # ---- next symbol of each read (reads are stored reversed) ----
        off = (pk >> 3) * 8
        sym = comm.fetch_syms(buf, off + d)
        sym = torch.where(active, sym, 0)

    with trace.span("plan.groups"):
        # ---- 2. groups: runs of equal (inert, bucket, u) ----
        arange_m = comm.iota(M, dev)  # the global row index
        tkey = c * 2 + inert.long()
        bucket_head = (arange_m == 0) | (tkey != comm.roll1(tkey))
        head = bucket_head | (u != comm.roll1(u))

        # ---- per-row / per-group combinatorics ----
        # pre[m, s]: active rows before m (in any bucket) that insert s; wpre:
        # the same summed over the symbols emitted before each column.  Row
        # m + 1 of each holds the counts up to and including row m.
        oh = (sym[:, None] == torch.arange(NSYM, device=dev)[None, :]) \
            & active[:, None]
        pre = comm.prefix_rows(oh, I32)
        order = _insertion_order(so)
        wpre = _emitted_before(pre, order)
        excl, We, Wc = pre[:-1], wpre[:-1], wpre[1:]
        # the counts at the group's head, at the bucket's head and at the
        # group's last row, in the column of the row's symbol
        headidx, (head_excl, We_head) = comm.last_flagged(head, sym, excl, We)
        bktheadidx, (bkt_excl,) = comm.last_flagged(bucket_head, sym, excl)
        _, (Wc_tail,) = comm.next_flagged(comm.shift_up1(head, True), sym, Wc)

        # stored intervals are in progressive coordinates; E = reads in earlier
        # groups of this bucket recovers start-of-round coordinates
        E = headidx - bktheadidx
        L = l - E
        U = u - E

    with trace.span("plan.rank"):
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

    with trace.span("plan.update"):
        # ---- 4. insertion points per symbol, start-of-round local coords ----
        # X[:, s] = L + the interval's counts of the symbols emitted before s
        X = L[:, None] + _emitted_before(delta, order)
        gX = poc + _take(X, sym)

        before_in_group = Wc_tail - We_head
        P_sym = head_excl - bkt_excl  # by earlier groups of the bucket

        ins_bucket = bucket_totals(comm, torch.where(dead, 0, c), pre)
        ac_excl = _excl_rows(pcounts + ins_bucket)

        # ---- global tie rank (stream index) of each insertion ----
        rank_in_run = _take(excl, sym) - head_excl
        stream = (headidx - comm.sum_scalar(inert) + before_in_group
                  + rank_in_run)

        # ---- interval update (+ fused cross-bucket rebase) ----
        l_new = _take(TL, sym) + P_sym + ac_excl[c, sym]
        u_new = l_new + _take(delta, sym)
        l = torch.where(active, l_new, l)
        u = torch.where(active, u_new, u)
        pk = torch.where(active, (pk & ~7) | sym, pk)

        n_ins = comm.sum_scalar(active)
    return (ReadStates(l=l, u=u, pk=pk), gX, sym, stream, active,
            ins_bucket, n_ins)


def _state_rank_fn(state, K):
    """rank_fn(gpos) -> (M, 6) over the base of any tier (the rank kernels
    on the flat and the packed tier); on the run tier it also takes (sub,
    extra) and answers the rank at gpos - sub plus extra
    (index/pending.py::rank_virtual_base's convention)."""
    if isinstance(state, RunBwt):
        return lambda g, sub=None, extra=None: rank_cuda.shifted(
            lambda p: rank_global_runs(state.rend, state.rsym, state.bstart,
                                       state.bocc, p), g, sub, extra)
    if isinstance(state, PackedFlatBwt):
        return lambda g: rank_cuda.rank_packed(state.pbwt, state.blkA,
                                               state.blkB, g)
    return lambda g: rank_cuda.rank_flat(state.bwt, state.blk_prefix, g, K)


def _virtual_rank_fn(state, pend, K):
    """rank_fn(gpos) -> (M, 6) over the frozen base plus the pending index:
    one launch of the flat or the packed virtual rank kernel; on the run
    tier the pending kernel, then the base at g - p in plain torch."""
    if isinstance(state, RunBwt):
        base_fn = _state_rank_fn(state, K)
        return lambda g: rank_virtual_base(base_fn, pend, g)
    if isinstance(state, PackedFlatBwt):
        return lambda g: rank_cuda.rank_virtual_packed(
            state.pbwt, state.blkA, state.blkB, pend, g)
    return lambda g: rank_cuda.rank_virtual_flat(state.bwt, state.blk_prefix,
                                                 pend, g, K)


def _state_merge(state, pos, sym, stream, valid, n, K):
    """The state with the insertions merged into its buffer and its rank
    tables rebuilt: the run insertion on the run tier, kernel C on the
    packed tier, kernel A on the flat."""
    if isinstance(state, RunBwt):
        return dataclasses.replace(
            state, **apply_insertions_runs(state, pos, sym, stream, valid))
    if isinstance(state, PackedFlatBwt):
        pbwt, blkA, blkB = merge_packed(state.pbwt, pos, sym, stream, valid,
                                        n, K)
        return dataclasses.replace(state, pbwt=pbwt, blkA=blkA, blkB=blkB)
    bwt, blk = merge(state.bwt, pos, sym, stream, valid, n, K)
    return dataclasses.replace(state, bwt=bwt, blk_prefix=blk)


def _store(into, merged):
    """``into`` with the buffer and tables of ``merged`` (a merge of it)
    copied into its own tensors: the fixed addresses that a CUDA graph of
    a round reads (engine/graph.py)."""
    for f in dataclasses.fields(into):
        dst, src = getattr(into, f.name), getattr(merged, f.name)
        if dst is not src:
            dst.copy_(src)
    return into


@trace.spanned("flush")
def _flush_pending(st, pend, *, K, into=None):
    """Apply the whole pending set to the base in one merge (kernel A, C
    or the run insertion) and reset the pending index in place.
    st.n/psize/pcounts already hold the virtual totals; only the buffer
    and its rank tables change.  ``into``: a state to copy the merged
    buffer and tables into (_store)."""
    pos, sym, stream, valid = pending_flush_args(pend)
    merged = _state_merge(st, pos, sym, stream, valid, st.n - pend.p, K)
    if into is not None:
        merged = _store(into, merged)
    return merged, reset_pending(pend)


def _round_up(x, m):
    return -(-x // m) * m


def _pad_pow2(x, lo=16):
    n = lo
    while n < x:
        n *= 2
    return n


def cut_points(bounds, n):
    """The distinct offsets of ``bounds`` strictly inside (0, n)."""
    cuts = np.unique(bounds)
    return cuts[(cuts > 0) & (cuts < n)]


def chunk_runs(chunks, cuts, device):
    """(sym int8, len int64) tensors on ``device``: the maximal runs of a
    sequence given as (lo, hi, int8 symbols [lo, hi) on the device) chunks
    in order, split at the offsets in ``cuts``.  A run goes on across chunk
    boundaries; only run heads are kept of each chunk."""
    syms, lens, cont = [], [], []
    for lo, hi, x in chunks:
        head = torch.ones(hi - lo, dtype=torch.bool, device=device)
        head[1:] = x[1:] != x[:-1]
        local = cuts[(cuts > lo) & (cuts < hi)] - lo
        if local.size:
            head[torch.from_numpy(local).to(device)] = True
        h = torch.nonzero(head)[:, 0]
        s = x[h]
        # the first run goes on from the previous chunk's last one
        c = torch.zeros(s.numel(), dtype=torch.bool, device=device)
        if syms and lo not in cuts:
            c[0] = s[0] == syms[-1][-1]
        syms.append(s)
        lens.append(torch.diff(h, append=h.new_full((1,), hi - lo)))
        cont.append(c)
    if not syms:
        return (torch.zeros(0, dtype=torch.int8, device=device),
                torch.zeros(0, dtype=I64, device=device))
    s, ln, c = (torch.cat(a) for a in (syms, lens, cont))
    first = torch.nonzero(~c)[:, 0]
    ends = torch.cumsum(ln, 0)[torch.cat([first[1:] - 1,
                                          first.new_full((1,), -1)])]
    return s[first], torch.diff(ends, prepend=ends.new_zeros(1))


class TorchBwt:
    """Host-side driver, the mrope_t equivalent: batched insertion
    (mr_insert_multi), single-string insertion, incremental growth across
    batches, and export of the BWT.  Flat int8 tier, switching to the 4-bit
    packed tier (index/packed.py) or the run-length tier (index/runs.py)
    once a build plans past a threshold.

    ``defer_r``: None picks the pending depth R from the capacity per batch
    (_choose_defer), 0 merges every round, R > 1 defers R rounds.
    ``device``: where the index lives; None means the card, and raises
    when there is none (pass device="cpu" for the plain versions).
    ``pack4``: the packed-tier threshold, as the JAX package's
    ROPEBWT2_TPU_PACK4: "auto" packs once the planned total passes 2^31
    symbols, 0 never packs, and an integer T packs past T symbols (K must
    then be 128).
    ``runs``: the run-tier threshold, as ROPEBWT2_TPU_RUNS: None or 0
    never converts, 1 converts from the start, and an integer T past T
    symbols (the run tier comes before the packed one).  ``runs_margin``
    (ROPEBWT2_TPU_RUNS_MARGIN): slots planned per inserted symbol; 2.0 is
    the worst case, and a smaller margin sizes the slots for compressible
    data.  ``runs_rcap`` (ROPEBWT2_TPU_RUNS_RCAP): a fixed slot capacity
    instead.  A batch that outgrows its slots raises RuntimeError after
    it; the index is then corrupt, and its export raises too.
    ``graphs``: on a card, the deferred batches of the flat and the
    packed tier replay each round as CUDA graphs (engine/graph.py) from
    the second batch of a configuration on; False runs every round op by
    op, as the CPU does.  Those batches update the engine's own copy of
    the index in place: a state read from ``state`` before a batch
    changes with it (copy its tensors to keep it), and a state assigned
    to ``state`` is copied at the next batch, never written.  A copy of
    the engine (copy.copy) shares the index's tensors and gets a runner
    of its own."""

    def __init__(self, so=SO_IO, K=128, defer_r=None, device=None,
                 pack4="auto", runs=None, runs_margin=2.0, runs_rcap=0,
                 graphs=True):
        if so not in (SO_IO, SO_RLO, SO_RCLO):
            raise ValueError(f"unknown sorting order {so}")
        device = resolve_device(device, "TorchBwt")
        if pack4 == "auto":
            self._pack_thr = PACK4_AUTO
        elif isinstance(pack4, int) and pack4 >= 0:
            self._pack_thr = pack4 or None
        else:
            raise ValueError(f"pack4 must be 'auto' or an int >= 0: {pack4!r}")
        if runs is not None and not (isinstance(runs, int) and runs >= 0):
            raise ValueError(f"runs must be None or an int >= 0: {runs!r}")
        self._runs_thr = runs or None
        self._runs_margin = float(runs_margin)
        self._runs_rcap = int(runs_rcap)
        # host bound of the run tier's live slots
        self._nslot_bound = 0
        self.so = so
        self.K = K
        self.device = device
        self.state = empty_state(K, K, self.device)
        # host mirrors: the driver never reads device scalars mid-build
        self._n = 0  # total symbols
        self._n_strings = 0  # total strings (== sentinel count)
        self._defer_cfg = -1 if defer_r is None else defer_r
        self.graphs = bool(graphs)
        self._runner = None  # engine/graph.py's, made at the first batch

    def __copy__(self):
        twin = object.__new__(type(self))
        twin.__dict__.update(self.__dict__)
        twin._runner = None
        return twin

    def _choose_defer(self, mpad):
        """(defer_r, pcap) for the next batch.  Auto mode balances the
        full-prefix flush (~ cap) against the per-round pending work
        (~ R * mpad): R* = sqrt(ratio * cap / mpad).  The ratio 0.055 is
        the JAX package's, kept so that R and pcap match it shape for
        shape until it is fitted on this card.  On the run tier the flush
        walks rcap slots of ~5 bytes: 5 * rcap stands for the capacity, as
        in the JAX package."""
        if self._defer_cfg >= 0:
            r = self._defer_cfg
        else:
            st = self.state
            cap = 5 * st.rcap if isinstance(st, RunBwt) else st.cap
            ratio = 0.055 * cap / max(mpad, 1)
            r = int(math.sqrt(ratio)) if ratio >= 1 else 0
            if r < 4:
                r = 0  # shallow deferral does not pay for the pending work
            else:
                r = 1 << min(6, (r - 1).bit_length())  # pow2 >= r, <= 64
        if r <= 1:
            return 0, 0
        return r, pending_cap(mpad, r)

    def plan(self, total_symbols: int):
        """Plan the index for ``total_symbols`` more at once, as a driver
        that knows its whole input does (the JAX scripts' upfront
        ``_plan(total)``): the whole capacity on the flat and packed tiers;
        on the run tier the conversion and tables wide enough for the
        total, while every batch makes room for its own slots (slots for
        the whole total at once would hold up to twice its symbols)."""
        self._plan(total_symbols, upfront=True)

    def _plan(self, extra_symbols: int, upfront: bool = False):
        """Grow the capacity to hold ``extra_symbols`` more.  Past the runs
        threshold the index is (or becomes) a run-tier index
        (_plan_runs; ``upfront`` sizes no slots).  Past the pack4 threshold
        the index is (or becomes) packed, its capacity rounded linearly to
        PACK_ALIGN.  Otherwise an upfront plan (>= 4x the capacity, >= 2^24)
        rounds linearly to PLAN_ALIGN, and incremental growth to a power of
        two."""
        need = self._n + extra_symbols
        if self._runs_thr is not None and (need > self._runs_thr or
                                           isinstance(self.state, RunBwt)):
            self._plan_runs(need, extra_symbols, slots=not upfront)
            return
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

    def _to_runs(self, total_bound: int):
        """Convert the index to the run tier, on its device: its runs (the
        export's run heads), with runs of RUN_LEN_MAX or more split into
        halves as the JAX package splits them, in a slot capacity rounded
        as there.  ``total_bound`` sets the tables' dtype."""
        syms, lens = self._run_tensors(np.zeros(0, np.int64), RUN_CHUNK)
        if lens.numel() and bool((lens >= RUN_LEN_MAX).any()):
            half = RUN_LEN_MAX // 2
            reps = -(-lens // half)
            syms = syms.repeat_interleave(reps)
            rem = (lens - (reps - 1) * half).repeat_interleave(reps)
            last = torch.cumsum(reps, 0).repeat_interleave(reps) - 1
            lens = torch.where(torch.arange(syms.numel(), device=syms.device)
                               == last, rem, half)
        nr = syms.numel()
        self._nslot_bound = nr
        st = self.state
        self.state = runs_from_arrays(
            syms, lens, rcap_for_slots(nr + max(nr // 4, RCAP_ALIGN)),
            total_bound, self._n, st.psize, st.pcounts, device=self.device)

    def _plan_runs(self, need: int, extra: int, slots: bool = True):
        """The run tier's plan for ``extra`` more symbols (``need`` in
        all): convert the index if it is not a run-tier index yet, widen
        the tables to int64 when ``need`` leaves int32, then (if ``slots``)
        make room for ``runs_margin`` slots a symbol (2 while the index
        holds fewer slots than the batch has symbols), or for ``runs_rcap``
        slots.  Unlike the JAX engine, which returns after a conversion, a
        converted index is sized for the batch too: there a first batch of
        more than ~8000 symbols overflows the conversion's 16,384 slots."""
        if not isinstance(self.state, RunBwt):
            self._to_runs(need)
        st = self.state
        if gdt_for_symbols(need).itemsize > st.bstart.element_size():
            rend, bstart, bocc = _rebuild_tables(
                slot_lengths(st.rend), st.rsym, st.nslot, torch.int64)
            self.state = st = dataclasses.replace(st, rend=rend,
                                                  bstart=bstart, bocc=bocc)
        if not slots:
            return
        if self._runs_rcap > 0:
            if self._runs_rcap > st.rcap:
                self.state = grow_runs_state(
                    st, rcap_for_slots(self._runs_rcap))
            return
        f = self._runs_margin
        if self._nslot_bound < extra:
            f = max(f, 2.0)  # a young index splits nearly every insertion
        needed = self._nslot_bound + int(f * extra) + 2048
        if needed > st.rcap:
            self._nslot_bound = int(st.nslot)  # tighten before growing
            needed = self._nslot_bound + int(f * extra) + 2048
            if needed > st.rcap:
                self.state = grow_runs_state(
                    st, rcap_for_slots(needed + needed // 4))

    @trace.spanned("batch.post")
    def _post_batch_runs(self, total: int):
        """After a batch on the run tier: one host read of the live slots
        and the overflow flag; raise if the flag is set.  The slot bound
        grows by the worst case with a margin of 2 or more (as in the JAX
        package) and is the live count below that."""
        st = self.state
        if not isinstance(st, RunBwt):
            return
        nslot, overflow = torch.stack([st.nslot,
                                       st.overflow.long()]).tolist()
        if overflow:
            raise RuntimeError(
                f"run tier: the batch outgrew its {st.rcap} slots (raise "
                "runs_margin or runs_rcap); the index is corrupt")
        if self._runs_margin >= 2.0:
            self._nslot_bound += 2 * total + 1024
        else:
            self._nslot_bound = nslot

    # --- the public insertion API ---

    @trace.spanned("batch")
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
        with trace.span("batch.grow"):
            self._plan(total)
        self._run_batch(buf, starts, total, int(lens.max()))

    @trace.spanned("batch")
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
        with trace.span("batch.grow"):
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
        two, as the JAX package does) and run every round of the batch on
        the engine's runner (engine/graph.py)."""
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
        defer_r, pcap = self._choose_defer(mpad)
        if self._runner is None:
            from .graph import Runner

            self._runner = Runner(self.device, self.graphs)
        run = self._runner
        self.state = run.bind(self.state, K=self.K, so=self.so, R=defer_r,
                              pcap=pcap, mpad=mpad, nbuf=buf.shape[0])
        self.state = run.run(l, u, pk, buf, max_len + 1)
        self._n += total
        self._n_strings += m
        self._post_batch_runs(total)

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

    def _check_runs(self):
        """Raise if a run-tier index is corrupt (its overflow flag set)."""
        if isinstance(self.state, RunBwt) and int(self.state.overflow):
            raise RuntimeError("run tier: the index overflowed its slots "
                               "and is corrupt")

    def _symbols(self, lo: int, hi: int):
        """int8 symbols [lo, hi) of the BWT on the index's device (a packed
        index unpacks only the packed rows that cover them, a run-tier
        index expands only the runs that cover them)."""
        st = self.state
        if isinstance(st, RunBwt):
            if hi <= lo:
                return st.rsym[:0]
            ends = run_ends(st)
            a, b = torch.searchsorted(ends, torch.tensor(
                [lo, hi - 1], device=ends.device), right=True).tolist()
            e = ends[a: b + 1]
            s = e - slot_lengths(st.rend)[a: b + 1]
            take = e.clamp(max=hi) - s.clamp(min=lo)
            return st.rsym[a: b + 1].repeat_interleave(take,
                                                       output_size=hi - lo)
        if isinstance(st, PackedFlatBwt):
            b0 = lo // 256 * 128
            b1 = -(-hi // 256) * 128
            x = unpack_bwt(st.pbwt[b0:b1])
            return x[lo - 2 * b0: hi - 2 * b0]
        return st.bwt[lo:hi]

    def bwt_array(self) -> np.ndarray:
        """The full BWT as an int8 numpy array, RUN_CHUNK symbols a copy
        (a packed or run-tier index expands each chunk on its device)."""
        self._check_runs()
        out = np.empty(self._n, dtype=np.int8)
        for lo in range(0, self._n, RUN_CHUNK):
            hi = min(self._n, lo + RUN_CHUNK)
            out[lo:hi] = self._symbols(lo, hi).cpu().numpy()
        return out

    def run_arrays(self, bounds=None, chunk=RUN_CHUNK):
        """The BWT as runs: (sym uint8[R], len int64[R]) numpy arrays.

        Run heads are found on the index's device, ``chunk`` symbols at a
        time (a packed index unpacks one chunk at a time), so no O(n)
        intermediate exists; a run-tier index coalesces its slots instead.
        Only the run arrays come back to the host.  Runs are also split at
        every offset in ``bounds`` (the FMR writer splits them at the
        partition offsets), so a run never crosses one."""
        if chunk % 256:
            raise ValueError(f"chunk {chunk} is not a multiple of 256")
        self._check_runs()
        s, ln = self._run_tensors(np.asarray(
            [] if bounds is None else bounds, dtype=np.int64), chunk)
        return s.to(torch.uint8).cpu().numpy(), ln.cpu().numpy()

    def _run_tensors(self, bounds, chunk):
        """(sym int8, len int64) tensors on the index's device: the BWT's
        maximal runs, split at the offsets in ``bounds``."""
        n = self._n
        cuts = cut_points(bounds, n)
        dev = self.state.n.device
        if isinstance(self.state, RunBwt):
            return self._slot_runs(torch.from_numpy(cuts).to(dev))
        spans = ((lo, min(n, lo + chunk)) for lo in range(0, n, chunk))
        chunks = ((lo, hi, self._symbols(lo, hi)) for lo, hi in spans)
        return chunk_runs(chunks, cuts, dev)

    def _slot_runs(self, cuts):
        """_run_tensors of a run-tier index: its live slots with equal
        neighbours coalesced (split halves and the slots that the
        insertion's economy rules leave side by side are not maximal
        runs), then split at ``cuts``."""
        st = self.state
        ns = int(st.nslot)
        syms = st.rsym[:ns]
        lens = slot_lengths(st.rend)[:ns].long()
        starts = torch.cumsum(lens, 0) - lens
        head = torch.ones(ns, dtype=torch.bool, device=syms.device)
        head[1:] = syms[1:] != syms[:-1]
        rs = starts[head]
        if cuts.numel():
            rs = torch.unique(torch.cat([rs, cuts]))
        sym = syms[torch.searchsorted(starts, rs, right=True) - 1]
        return sym, torch.diff(rs, append=rs.new_full((1,), self._n))

    def runs(self):
        """Run-length view [(sym, len), ...] of the BWT."""
        s, ln = self.run_arrays()
        return list(zip(s.tolist(), ln.tolist()))
