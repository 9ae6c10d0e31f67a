"""Multi-device BCR over torch.distributed (counterpart of
ropebwt2_tpu/parallel/sharded.py, whose module docstring holds the
derivation).

One process per shard: rank s of a world of d owns

* the window [s * lcap, (s + 1) * lcap) of the flat BWT, int8[lcap +
  PAD_TAIL] with PAD past lcap, and its K-block rank table, which holds
  GLOBAL prefix counts (the window's own counts plus those of the windows
  before it, from one all_gather of per-rank totals);
* rows [s * ml, (s + 1) * ml) of the read state, re-sharded every round by
  the bucket sort (ShardComm.sort), and its byte range of the read buffer.

Per round, over the collectives of parallel/comm.py:

* rank queries are routed to the rank that owns their position, answered
  from its tables and routed back;
* insertions are routed by destination and merged into each window by
  kernel A on a stitched buffer: the left neighbour's last M symbols, then
  the window.  The insertions of the ranks below shift the window right by
  s_lo symbols, and s_lo rides as phantom insertion marks in the head, so
  the kernel's insertion count shifts every window position by s_lo plus
  its local marks: out[t] = stitched[m + t - s_lo - c(t)].  The kernel's
  128-symbol rank prefix, rebased to the window's first row, is the
  window's new table.

Deferred (defer_r = R > 1), each rank keeps a pending index (kernel B) for
the insertions whose base position lies in its window, in window
coordinates, with the replicated per-rank pending prefix ``ppref`` and occ
prefix ``pocc``; every R rounds each rank merges its pending rows into its
window (kernel A) and ships the symbols that now lie past its window end
one hop right, where a second kernel A call on a stitched buffer shifts
them in (the drift again, ppref[s] phantom marks).  d * pcap <= lcap keeps
that one hop.

Every batch is a host loop that reads nothing from the device.  The BWT
and the tables match the JAX engine's row for row (convert.py::
sharded_from_numpy carries a JAX state over).
"""

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from ..alphabet import NSYM, SO_IO, SO_RCLO, SO_RLO
from ..engine.bcr import (
    RUN_CHUNK,
    ReadStates,
    _pad_pow2,
    _round_up,
    chunk_runs,
    cut_points,
    plan_round,
)
from ..index.flat import PAD, PAD_TAIL, table_dtype
from ..index.merge_cuda import (
    BS,
    LANE,
    block_prefix,
    insertion_map,
    merge,
    run_kernel,
)
from ..index.pending import (
    empty_pending,
    pending_add,
    pending_cap,
    pending_flush_args,
    reset_pending,
)
from ..index import rank_cuda
from ..index.rank import build_block_tables
from .comm import ShardComm
from .mesh import local_block, make_mesh

I64 = torch.int64


@dataclasses.dataclass
class ShardedBwt:
    """One rank's shard of the index."""

    bwt: torch.Tensor  # int8[lcap + PAD_TAIL], PAD past lcap
    # table_dtype(lcap * d)[lcap // K + 1, 6]: GLOBAL prefix counts
    blk_prefix: torch.Tensor
    n: torch.Tensor  # int64 0-dim (the same on every rank)
    psize: torch.Tensor  # int64[6]
    pcounts: torch.Tensor  # int64[6, 6]


def _with_global_base(comm, local, lcap, K):
    """A window's table of window-local counts, plus the counts of every
    window before it, in table_dtype(lcap * d)."""
    local = local.to(table_dtype(lcap * comm.d))
    return local + comm.carry(local[lcap // K], torch.cumsum)[None, :]


def _routed_rank_fn(comm, st, lcap, K):
    """Global 6-symbol rank: each query goes to the rank that owns its
    position, which answers from its global-valued table."""

    def rank_fn(gpos):
        tgt = (gpos // lcap).clamp(0, comm.d - 1)
        _, (rq,), route = comm.exchange(tgt, None, [gpos])
        local = (rq - comm.s * lcap).clamp(0, lcap)
        return comm.reply(route, rank_cuda.rank_flat(st.bwt, st.blk_prefix,
                                                     local, K))

    return rank_fn


def stitched_args(bwt_loc, tail, ldest, rsym, rv, s_lo, lcap):
    """Kernel A's arguments (old, insmap, start, n, prefix dtype) for a
    window with the drift from its left: the stitched buffer tail + window
    + PAD_TAIL, with s_lo phantom marks at head positions 0 .. s_lo - 1
    and the window's insertions at their final window positions ldest
    (where rv), so that out[m + t] = stitched[m + t - s_lo - c(t)].  The
    phantom marks write garbage into the head, which is dropped; n is the
    whole stitched window, so that every row of the window comes out
    exact.

    tail: int8[m], m a multiple of 128 and at least s_lo; ldest, rsym:
    int64 lanes; s_lo: an int64 0-dim tensor."""
    m = tail.shape[0]
    if m % LANE:
        raise ValueError(f"stitched merge: tail {m} is not a multiple of "
                         f"{LANE}")
    dev = tail.device
    stitched = torch.cat([tail, bwt_loc[:lcap], torch.full(
        (PAD_TAIL,), PAD, dtype=torch.int8, device=dev)])
    nb = -(-stitched.shape[0] // BS)
    iota = torch.arange(m, device=dev)
    pos = torch.cat([iota, ldest.clamp(0, lcap - 1) + m])
    sym = torch.cat([torch.zeros_like(iota), rsym])
    valid = torch.cat([iota < s_lo, rv])
    dest, insmap = insertion_map(pos, sym, torch.zeros_like(pos), valid, nb)
    return (stitched, insmap, block_prefix(dest, nb),
            torch.full((), m + lcap, dtype=I64, device=dev),
            table_dtype(stitched.shape[0]))


def stitched_window(out, prefix, m, lcap, K):
    """(window int8[lcap + PAD_TAIL] with PAD past lcap, its table [lcap //
    K + 1, 6] of window-local counts) from kernel A's output and 128-symbol
    prefix on a stitched buffer with an m-symbol tail."""
    window = out[m:]
    window[lcap:] = PAD
    rows = prefix[m // LANE: (m + lcap) // LANE + 1: K // LANE]
    return window, rows - rows[:1]


def stitched_merge(bwt_loc, tail, ldest, rsym, rv, s_lo, lcap, K):
    """Kernel A on a window with the drift from its left (stitched_args);
    returns stitched_window's (window, table).  On CPU tensors run_kernel
    runs its plain version, merge_cuda.merge_blocks."""
    out, prefix = run_kernel(*stitched_args(bwt_loc, tail, ldest, rsym, rv,
                                            s_lo, lcap))
    return stitched_window(out, prefix, tail.shape[0], lcap, K)


def _local_merge(comm, st, gX, sym, stream, active, lcap, K):
    """Route this rank's planned insertions to the ranks that own their
    destinations and merge the received ones into the window.  Returns
    the new window and its global-valued table."""
    d, s = comm.d, comm.s
    dest = gX + stream
    tgt = (dest // lcap).clamp(0, d - 1)
    rv, (rdest, rsym), _ = comm.exchange(tgt, active, [dest, sym])
    # the insertions owned by the ranks below shift the window right
    owner = (tgt[:, None] == torch.arange(d, device=tgt.device)) \
        & active[:, None]
    s_lo = comm.psum_array(owner.sum(0))[:s].sum()
    ldest = torch.where(rv, rdest - s * lcap, lcap)
    # the left neighbour's tail covers the drift (at most M per round)
    m = _round_up(gX.shape[0] * d, LANE)
    tail = comm.from_left(st.bwt[lcap - m: lcap])
    window, local = stitched_merge(st.bwt, tail, ldest, rsym, rv, s_lo,
                                   lcap, K)
    return window, _with_global_base(comm, local, lcap, K)


# ---------------------------------------------------------------------------
# The deferred engine: a pending index per rank in WINDOW coordinates (the
# JAX package's virtual-position algebra, sharded.py:254-281):
#   V[s] = s * lcap + ppref[s]           rank s's virtual range start
#   owner(g) = s with V[s] <= g < V[s+1]
#   window-local virtual position wl = g - V[s], in [0, lcap + pcap)
#   rank(g) = base_rank(wl - p_loc) + pocc[s] + occ_loc
# ---------------------------------------------------------------------------


def _v_route(gpos, V):
    """Owner rank of each global virtual position (V ascending, (d+1,))."""
    return (gpos[:, None] >= V[None, 1:-1]).sum(1)


def _bounds(comm, lcap, ppref):
    """V: the virtual range start of every rank, and the end."""
    return torch.arange(comm.d + 1, device=ppref.device) * lcap + ppref


def _routed_rank_virtual_fn(comm, st, pend, lcap, K, ppref, pocc):
    """Deferred routed rank: the owner answers from its frozen base table,
    its pending index and the replicated prefixes of the ranks below."""

    def rank_fn(gpos):
        V = _bounds(comm, lcap, ppref)
        _, (rq,), route = comm.exchange(_v_route(gpos, V), None, [gpos])
        wl = (rq - V[comm.s]).clamp(0, lcap + pend.cap)
        p_loc, occ_loc = rank_cuda.pending_rank(pend, wl)
        base = rank_cuda.rank_flat(st.bwt, st.blk_prefix,
                                   (wl - p_loc).clamp(0, lcap), K,
                                   extra=occ_loc)
        return comm.reply(route, base + pocc[comm.s].to(base.dtype))

    return rank_fn


def _pending_route_add(comm, pend, gX, sym, stream, active, lcap, ppref,
                       pocc):
    """Route one round's insertions to their owner ranks (by the virtual
    range of the start-of-round insertion point) and merge them into each
    owner's pending index (kernel B); update the replicated prefixes.
    Owners' tie ranks are contiguous ranges of the global ones."""
    d, s = comm.d, comm.s
    V = _bounds(comm, lcap, ppref)
    tgt = _v_route(gX, V)
    # per-owner, per-symbol insertions of the round, on every rank
    occ_add = torch.zeros(d * NSYM, dtype=I64, device=gX.device)
    occ_add.index_add_(0, tgt * NSYM + sym, active.long())
    occ_add = comm.psum_array(occ_add.view(d, NSYM))
    hist = occ_add.sum(1)
    s0 = torch.cat([hist.new_zeros(1), torch.cumsum(hist, 0)])
    rv, (rgX, rsym, rstream), _ = comm.exchange(tgt, active,
                                                [gX, sym, stream])
    wl = (rgX - V[s]).clamp(0, lcap + pend.cap)
    pend = pending_add(pend, wl, rsym, rstream - s0[s], rv)
    pocc = pocc + torch.cat([occ_add.new_zeros((1, NSYM)),
                             torch.cumsum(occ_add, 0)[:-1]])
    return pend, ppref + s0, pocc


def _flush_sharded(comm, st, pend, lcap, K, ppref):
    """Merge each rank's pending rows into its window (kernel A) and
    re-align the windows to their fixed ranges: the d * pcap symbols that
    end at the merged window's live end go one hop right, where the last
    ppref[s] of them come in ahead of the window, a drift of ppref[s]
    (stitched_merge, no insertions)."""
    pcap = pend.cap
    spill = comm.d * pcap
    dev = st.bwt.device
    pos, sym, stream, valid = pending_flush_args(pend)
    scratch = torch.cat([st.bwt[:lcap], torch.full(
        (_round_up(pcap, K) + PAD_TAIL,), PAD, dtype=torch.int8,
        device=dev)])
    merged, _ = merge(scratch, pos.clamp(0, lcap), sym, stream, valid,
                      torch.full((), lcap, dtype=I64, device=dev), K)
    out = merged[pend.p + (lcap - spill) + torch.arange(spill, device=dev)]
    none = torch.zeros(0, dtype=I64, device=dev)
    window, local = stitched_merge(
        merged, comm.from_left(out), none, none, none.bool(),
        ppref[comm.s], lcap, K)
    return window, _with_global_base(comm, local, lcap, K)


def sharded_bcr_batch(state, reads, buf, n_rounds: int, *, K, so, lcap,
                      comm, defer_r=0, pcap=0):
    """All rounds of one batch on this rank: merged every round, or
    deferred when defer_r > 0 (pcap per rank).  ``reads`` and ``buf`` are
    this rank's blocks.  Returns (state, reads)."""
    st, rd = state, reads
    if defer_r <= 0:
        for r in range(n_rounds):
            rd, gX, sym, stream, active, insb, n_ins = plan_round(
                st.psize, st.pcounts, rd, buf, r, r == 0,
                _routed_rank_fn(comm, st, lcap, K), so=so, comm=comm)
            bwt, blk = _local_merge(comm, st, gX, sym, stream, active, lcap,
                                    K)
            st = ShardedBwt(bwt=bwt, blk_prefix=blk, n=st.n + n_ins,
                            psize=st.psize + insb.sum(1),
                            pcounts=st.pcounts + insb)
        return st, rd
    dev = st.n.device
    pend = empty_pending(pcap, dev)
    for lo in range(0, n_rounds, defer_r):
        ppref = torch.zeros(comm.d + 1, dtype=I64, device=dev)
        pocc = torch.zeros((comm.d, NSYM), dtype=I64, device=dev)
        n, psize, pcounts = st.n, st.psize, st.pcounts
        for r in range(lo, min(lo + defer_r, n_rounds)):
            rank_fn = _routed_rank_virtual_fn(comm, st, pend, lcap, K, ppref,
                                              pocc)
            rd, gX, sym, stream, active, insb, n_ins = plan_round(
                psize, pcounts, rd, buf, r, r == 0, rank_fn, so=so,
                comm=comm)
            pend, ppref, pocc = _pending_route_add(
                comm, pend, gX, sym, stream, active, lcap, ppref, pocc)
            n, psize, pcounts = n + n_ins, psize + insb.sum(1), \
                pcounts + insb
        bwt, blk = _flush_sharded(comm, st, pend, lcap, K, ppref)
        st = ShardedBwt(bwt=bwt, blk_prefix=blk, n=n, psize=psize,
                        pcounts=pcounts)
        pend = reset_pending(pend)
    return st, rd


class ShardedTorchBwt:
    """Multi-device BWT builder, the counterpart of ShardedTpuBwt, with
    TorchBwt's surface: every rank of the mesh makes one and calls the
    same methods with the same reads in the same order.  The BWT is sharded
    by position range, the read state by sorted rank.  Flat tier only.

    ``mesh``: a parallel.mesh.Mesh; None starts (or joins) the default
    process group on ``device`` (None: the card, cuda:LOCAL_RANK, which
    raises when there is none; "cpu": gloo ranks).  ``defer_r``: None
    picks R per batch (_choose_defer), 0 merges every round, R > 1
    defers R rounds.  bwt_array, run_arrays and runs gather the shards on
    rank 0, and return None on the other ranks; counts() is on every
    rank."""

    def __init__(self, so=SO_IO, K=128, mesh=None, defer_r=None,
                 device=None):
        if so not in (SO_IO, SO_RLO, SO_RCLO):
            raise ValueError(f"unknown sorting order {so}")
        if K % LANE or PAD_TAIL % K:
            raise ValueError(f"K {K} must be a multiple of {LANE} that "
                             f"divides {PAD_TAIL}")
        self.mesh = make_mesh(device=device) if mesh is None else mesh
        self.d = self.mesh.d
        self.device = self.mesh.device
        self.so = so
        self.K = K
        self._n = 0
        self._n_strings = 0
        self.state = None  # created at the first plan
        self._lcap = 0
        self._seed = None  # (flat BWT on the device, psize, pcounts)
        self._defer_cfg = -1 if defer_r is None else defer_r

    def _comm(self, ml=0):
        return ShardComm(self.mesh.group, ml, self.d)

    def _choose_defer(self, mpad):
        """(defer_r, pcap) for the next batch, as the JAX engine chooses
        them: pcap is per rank, sized for every insertion of every
        deferred round routed to one rank; no deferral when the flush's
        spill d * pcap would not fit one hop (> lcap) or the window
        coordinates would leave int32."""
        if self._defer_cfg >= 0:
            r = self._defer_cfg
        else:
            ratio = 0.055 * self._lcap * self.d / max(mpad, 1)
            r = int(math.sqrt(ratio)) if ratio >= 1 else 0
            if r < 4:  # shallow deferral does not pay for the pending work
                r = 0
            else:
                r = 1 << min(6, (r - 1).bit_length())
        while r > 1:
            pcap = pending_cap(mpad, r)
            if self.d * pcap <= self._lcap and \
                    self._lcap + self.d * pcap < (1 << 31):
                return r, pcap
            r //= 2
        return 0, 0

    @classmethod
    def from_single(cls, single, mesh=None):
        """Adopt a TorchBwt's index (the CLI's -i restore): every rank
        takes its window of the index's symbols on its device."""
        eng = cls(so=single.so, K=single.K, mesh=mesh,
                  device=single.device if mesh is None else None)
        eng._n = single.n
        eng._n_strings = single._n_strings
        eng._seed = (single._symbols(0, single.n).to(eng.device),
                     single.state.psize.to(eng.device),
                     single.state.pcounts.to(eng.device))
        eng._plan(0)  # the sharded state now, so that export works at once
        return eng

    def _plan(self, extra):
        """Re-shard to the capacity of ``extra`` more symbols (between
        batches): d windows of lcap, a power of two >= max(K, 4096).  The
        old BWT is gathered on every rank's device, and each rank keeps
        its new window of it."""
        need = self._n + extra
        if self.state is not None and need <= self._lcap * self.d:
            return
        lcap = _round_up(_pad_pow2(-(-need // self.d), lo=max(self.K, 4096)),
                         self.K)
        dev = self.device
        comm = self._comm()
        if self.state is not None:
            old = comm.all_gather(self.state.bwt[: self._lcap]).view(-1)
            psize, pcounts = self.state.psize, self.state.pcounts
        elif self._seed is not None:
            old, psize, pcounts = self._seed
            self._seed = None
        else:
            old = torch.zeros(0, dtype=torch.int8, device=dev)
            psize = torch.zeros(NSYM, dtype=I64, device=dev)
            pcounts = torch.zeros((NSYM, NSYM), dtype=I64, device=dev)
        part = old[: self._n][self.mesh.s * lcap: (self.mesh.s + 1) * lcap]
        window = torch.full((lcap + PAD_TAIL,), PAD, dtype=torch.int8,
                            device=dev)
        window[: part.numel()] = part
        local = build_block_tables(window[:lcap], self.K, dtype=I64)
        self.state = ShardedBwt(
            bwt=window, blk_prefix=_with_global_base(comm, local, lcap,
                                                     self.K),
            n=torch.full((), self._n, dtype=I64, device=dev),
            psize=psize, pcounts=pcounts)
        self._lcap = lcap

    # --- the public insertion API ---

    def insert_multi(self, reads, already_reversed=False):
        """Insert a batch: a list of nt6 code arrays or an (m, L) matrix,
        in original orientation unless ``already_reversed``."""
        m = len(reads)
        if m == 0:
            return
        if isinstance(reads, np.ndarray) and reads.ndim == 2:
            mat = reads.astype(np.int8, copy=False)
            if not already_reversed:
                mat = mat[:, ::-1]
            lens = np.full(m, reads.shape[1], dtype=np.int64)
            cat = np.ascontiguousarray(mat).reshape(-1)
        else:
            lens = np.array([len(r) for r in reads], dtype=np.int64)
            cat = np.concatenate([np.asarray(r, dtype=np.int8)
                                  for r in reads])
            if not already_reversed:  # index each read backwards
                rstarts = np.concatenate([[0], np.cumsum(lens)[:-1]])
                cat = cat[(rstarts + lens - 1).repeat(lens)
                          - (np.arange(cat.size) - rstarts.repeat(lens))]
        self._insert(cat, lens)

    def insert_nul_batch(self, nulbuf):
        """Insert a batch given as NUL-terminated, insertion-oriented
        strings (the reference's -m batch buffer)."""
        nulbuf = np.ascontiguousarray(nulbuf).view(np.int8)
        ends = np.flatnonzero(nulbuf == 0)
        if len(ends) == 0:
            return
        if ends[-1] != nulbuf.shape[0] - 1:
            raise ValueError("batch must end with a terminator")
        starts = np.concatenate([[0], ends[:-1] + 1])
        self._insert(nulbuf[nulbuf != 0], (ends - starts).astype(np.int64))

    def _insert(self, cat, lens):
        """Lay out a batch of insertion-oriented symbols ``cat`` (lens a
        string) as the JAX engine does, and run its rounds on this rank's
        blocks: padding rows first, up to a multiple of d that is a power
        of two or d; each string 8-aligned with a 0 terminator, the buffer
        a multiple of 8 d bytes."""
        m = lens.shape[0]
        total = int(lens.sum()) + m
        self._plan(total)
        d = self.d
        mpad = _round_up(max(_pad_pow2(m), d), d)
        if mpad > self._lcap:  # drift guard: one round inserts <= mpad
            self._plan(self._n + total + mpad * d)
        strides = (lens + 8) & ~np.int64(7)
        starts = np.concatenate([[0], np.cumsum(strides)[:-1]])
        rstarts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        buf = np.zeros(_round_up(_pad_pow2(int(strides.sum()), lo=64), d * 8),
                       dtype=np.int8)
        buf[(starts - rstarts).repeat(lens) + np.arange(cat.size)] = cat
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
        rs = ReadStates(*(torch.from_numpy(local_block(x, self.mesh)).to(dev)
                          for x in (l, u, pk)))
        defer_r, pcap = self._choose_defer(mpad)
        self.state, _ = sharded_bcr_batch(
            self.state, rs, torch.from_numpy(local_block(buf, self.mesh)).to(
                dev), int(lens.max()) + 1, K=self.K, so=self.so,
            lcap=self._lcap, comm=self._comm(mpad // d), defer_r=defer_r,
            pcap=pcap)
        self._n += total
        self._n_strings += m

    # --- export ---

    @property
    def n(self) -> int:
        return self._n

    def counts(self):
        """Global per-symbol counts ($,A,C,G,T,N), on every rank."""
        return self.state.pcounts.sum(dim=0).cpu().numpy()

    def _chunks(self, chunk):
        """On rank 0, (lo, hi, int8 symbols [lo, hi) on its device) over the
        BWT in order, ``chunk`` symbols at most and never across a window;
        every other rank sends its chunks to rank 0 and yields nothing.
        Every rank must run it to its end."""
        comm = self._comm()
        s, lcap, n = self.mesh.s, self._lcap, self._n
        for j in range(self.d):
            jlo, jhi = j * lcap, min((j + 1) * lcap, n)
            for lo in range(jlo, jhi, chunk):
                hi = min(jhi, lo + chunk)
                if s == j:
                    x = self.state.bwt[lo - jlo: hi - jlo]
                    if s == 0:
                        yield lo, hi, x
                    else:
                        dist.send(x.contiguous(), comm.peer(0), comm.group)
                elif s == 0:
                    x = torch.empty(hi - lo, dtype=torch.int8,
                                    device=self.device)
                    dist.recv(x, comm.peer(j), comm.group)
                    yield lo, hi, x

    def bwt_array(self):
        """The full BWT as an int8 numpy array on rank 0 (None elsewhere),
        RUN_CHUNK symbols a copy."""
        out = np.empty(self._n, dtype=np.int8) if self.mesh.s == 0 else None
        for lo, hi, x in self._chunks(RUN_CHUNK):
            out[lo:hi] = x.cpu().numpy()
        return out

    def run_arrays(self, bounds=None, chunk=RUN_CHUNK):
        """The BWT as runs (sym uint8[R], len int64[R]) on rank 0, None on
        the other ranks: rank 0 finds the run heads of each window's chunks
        on its device and coalesces equal symbols across chunks and
        windows, as TorchBwt.run_arrays does; runs are also split at every
        offset in ``bounds``.  Only the run arrays come to the host."""
        if chunk % 256:
            raise ValueError(f"chunk {chunk} is not a multiple of 256")
        chunks = self._chunks(chunk)
        if self.mesh.s != 0:
            for _ in chunks:
                pass
            return None
        cuts = cut_points(np.asarray([] if bounds is None else bounds,
                                     dtype=np.int64), self._n)
        s, ln = chunk_runs(chunks, cuts, self.device)
        return s.to(torch.uint8).cpu().numpy(), ln.cpu().numpy()

    def runs(self):
        """Run-length view [(sym, len), ...] of the BWT on rank 0 (None
        elsewhere)."""
        r = self.run_arrays()
        return None if r is None else list(zip(r[0].tolist(), r[1].tolist()))
