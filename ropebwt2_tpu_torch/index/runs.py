"""Run-length compressed BWT state, the O(runs) tier (counterpart of
ropebwt2_tpu/index/runs.py, whose module docstring holds the derivation).

The reference's index is run-length encoded (rle.h:39-75); this tier keeps
the BWT as runs in fixed blocks of KR = 128 slots, structure of arrays:

* ``rsym``   int8[rcap]    run symbols; PAD past the live slots
* ``rend``   int32[rcap]   block-relative inclusive run ends: rend[i] = the
                           symbols of runs (b * 128 .. i] of i's block b;
                           slots past the live ones repeat the block's last
                           value (length 0)
* ``bstart`` gdt[rcap/128] global position of each block's first run; a
                           sentinel (``_inf``) for blocks with no live slot
* ``bocc``   gdt[rcap/128, 6] per-symbol counts before each block
* ``nslot``  int64 0-dim   live slots: [0, nslot) are runs of length >= 1
* ``n``, ``psize``, ``pcounts`` as in flat.FlatBwt
* ``overflow`` int32 0-dim sticky count of envelope breaches (slots past
                           rcap - 128, a run of RUN_LEN_MAX or more); the
                           engine reads it after every batch and raises

gdt is int32 below 2^31 - 2^29 symbols and int64 past that.

Rank (rank_global_runs): one searchsorted over ``bstart`` gives the block
(where the JAX package descends a 128-fanout pyramid), then occ[s] =
bocc[b, s] + sum_i clamp(rem - start_i, 0, len_i) over the block's runs
of symbol s.

Batched insertion (apply_insertions_runs) keeps the JAX package's three
slot-economy rules, so a flush emits no run of length 0: an insertion of
its host run's symbol extends it and emits no item; a split's right piece
is emitted only when it is not empty; equal (position, symbol) splits
merge into one item, and the first split at offset 0 of a run takes the
host slot.  End insertions resolve to the phantom host slot at nslot.
Items and old runs then meet by a gather by the item prefix, out[p] =
old[p - c(p)], in chunks of EXPAND_CHUNK slots from the top chunk down
(content only moves up, so each chunk is rewritten in place).

Plain torch on either device; none of these functions is a kernel.
"""

import dataclasses

import numpy as np
import torch

from ..alphabet import NSYM
from .flat import PAD, resolve_device
from .rank import flagged_rows, prefix_rows

I32 = torch.int32
I64 = torch.int64
KR = 128  # runs per block
RUN_LEN_MAX = 1 << 24  # per-run length envelope (keeps block totals < 2^31)
RCAP_ALIGN = KR * 128  # slot capacity granularity (the JAX package's)
# the JAX engine's rounding of large slot capacities: past RCAP_BIG slots,
# to a multiple of RCAP_BIG_ALIGN (so that states compare shape for shape)
RCAP_BIG, RCAP_BIG_ALIGN = 1 << 26, 1 << 24
EXPAND_CHUNK = 1 << 24  # slots a step of the flush's expand
_BIG = 1 << 62  # past every row index


def _inf(dt):
    """The dead-block sentinel of bstart (the JAX package's)."""
    return torch.iinfo(dt).max - (1 << 28)


@dataclasses.dataclass
class RunBwt:
    rsym: torch.Tensor  # int8[rcap]
    rend: torch.Tensor  # int32[rcap] block-relative inclusive ends
    bstart: torch.Tensor  # gdt[rcap // KR] block global starts (INF dead)
    bocc: torch.Tensor  # gdt[rcap // KR, 6] per-symbol counts before block
    nslot: torch.Tensor  # int64 0-dim live slots
    n: torch.Tensor  # int64 0-dim total symbols
    psize: torch.Tensor  # int64[6]
    pcounts: torch.Tensor  # int64[6, 6]
    overflow: torch.Tensor  # int32 0-dim sticky envelope breaches

    @property
    def rcap(self) -> int:
        return self.rsym.shape[0]

    @property
    def cap(self) -> int:
        """A symbol capacity consistent with the tables' dtype (the tier
        has no fixed one): 2^30 with int32 tables, 2^40 with int64."""
        return (1 << 30) if self.bstart.dtype == I32 else (1 << 40)


def gdt_for_symbols(total: int):
    """Table dtype for a build of ``total`` symbols."""
    return I32 if total < (1 << 31) - (1 << 29) else I64


def rcap_for_slots(slots: int) -> int:
    """The slot capacity the engine allocates for ``slots``: a multiple of
    RCAP_ALIGN, and of RCAP_BIG_ALIGN once at least RCAP_BIG."""
    rcap = -(-slots // RCAP_ALIGN) * RCAP_ALIGN
    if rcap >= RCAP_BIG:
        rcap = -(-rcap // RCAP_BIG_ALIGN) * RCAP_BIG_ALIGN
    return rcap


def empty_runs_state(rcap: int, total_symbol_bound: int, device) -> RunBwt:
    if rcap % RCAP_ALIGN:
        raise ValueError(f"rcap {rcap} is not a multiple of {RCAP_ALIGN}")
    gdt = gdt_for_symbols(total_symbol_bound)
    nbl = rcap // KR
    z = torch.zeros((), dtype=I64, device=device)
    return RunBwt(
        rsym=torch.full((rcap,), PAD, dtype=torch.int8, device=device),
        rend=torch.zeros(rcap, dtype=I32, device=device),
        bstart=torch.full((nbl,), _inf(gdt), dtype=gdt, device=device),
        bocc=torch.zeros((nbl, NSYM), dtype=gdt, device=device),
        nslot=z, n=z.clone(),
        psize=torch.zeros(NSYM, dtype=I64, device=device),
        pcounts=torch.zeros((NSYM, NSYM), dtype=I64, device=device),
        overflow=torch.zeros((), dtype=I32, device=device),
    )


def grow_runs_state(state: RunBwt, new_rcap: int) -> RunBwt:
    """The state with ``new_rcap`` slots: dead slots and blocks appended."""
    if new_rcap % RCAP_ALIGN or new_rcap < state.rcap:
        raise ValueError(f"bad new rcap {new_rcap} (rcap {state.rcap})")
    if new_rcap == state.rcap:
        return state
    extra = new_rcap - state.rcap
    gdt = state.bstart.dtype
    dev = state.rsym.device
    return dataclasses.replace(
        state,
        rsym=torch.cat([state.rsym, torch.full((extra,), PAD,
                                               dtype=torch.int8, device=dev)]),
        rend=torch.cat([state.rend, torch.zeros(extra, dtype=I32,
                                                device=dev)]),
        bstart=torch.cat([state.bstart, torch.full(
            (extra // KR,), _inf(gdt), dtype=gdt, device=dev)]),
        bocc=torch.cat([state.bocc, torch.zeros((extra // KR, NSYM),
                                                dtype=gdt, device=dev)]),
    )


def slot_lengths(rend):
    """int32[rcap] per-slot run lengths from block-relative ends."""
    ln = rend.view(-1, KR).clone()
    ln[:, 1:] -= rend.view(-1, KR)[:, :-1]
    return ln.view(-1)


def run_ends(state: RunBwt, dtype=I64):
    """dtype[rcap] global exclusive end of every slot (sorted; slots past
    the live ones end at n inside a live block, at the sentinel past it)."""
    return (state.bstart.to(dtype).repeat_interleave(KR)
            + state.rend.to(dtype)).clamp_(max=_inf(state.bstart.dtype))


def rank_global_runs(rend, rsym, bstart, bocc, g):
    """Batched 6-symbol rank at global positions g (0 <= g <= n), in
    bocc's dtype.  Positions out of range are clamped, never faulted, and
    their rows are meaningless."""
    jb = (torch.searchsorted(bstart, g.to(bstart.dtype).contiguous(),
                             right=True) - 1).clamp(min=0)
    rem = (g.long() - bstart[jb].long()).to(I32)
    erow = rend.view(-1, KR)[jb]  # (Q, 128)
    start = torch.cat([erow.new_zeros((erow.shape[0], 1)), erow[:, :-1]], 1)
    taken = torch.minimum((rem[:, None] - start).clamp_(min=0), erow - start)
    # the symbols' sums: PAD slots (length 0) land in a column of their own
    inc = torch.zeros((g.shape[0], 8), dtype=I32, device=g.device)
    inc.scatter_add_(1, rsym.view(-1, KR)[jb].long(), taken)
    return bocc[jb] + inc[:, :NSYM].to(bocc.dtype)


def _rebuild_tables(lens, syms, nslot, gdt):
    """(rend, bstart, bocc) from per-slot lengths and symbols (dead slots
    must already be (0, PAD))."""
    nbl = lens.shape[0] // KR
    lb = lens.view(nbl, KR)
    rend = torch.cumsum(lb, 1, dtype=I32).view(-1)
    btot = rend.view(nbl, KR)[:, -1]
    bstart = torch.cumsum(btot, 0, dtype=gdt) - btot
    dead = torch.arange(nbl, device=lens.device) * KR >= nslot
    bstart = torch.where(dead, _inf(gdt), bstart)
    bcnt = torch.zeros((nbl, 8), dtype=I32, device=lens.device)
    bcnt.scatter_add_(1, syms.view(nbl, KR).long(), lb)
    return rend, bstart, prefix_rows(bcnt[:, :NSYM], gdt)[:-1]


def _roll1(x, fill):
    """x shifted one row down, ``fill`` in front."""
    return torch.cat([x.new_full((1,), fill), x[:-1]])


def _shift_up1(x, fill):
    """x shifted one row up, ``fill`` at the end."""
    return torch.cat([x[1:], x.new_full((1,), fill)])


def _plan_items(state: RunBwt, pos, sym, stream, valid):
    """The planning stage of the batched run insertion: classify the
    insertions (split or extend), form the items under the slot-economy
    rules, scatter them to their merged slots, and apply the host trims
    and replacements to the old per-slot arrays.  Returns (old_len
    int32[rcap + 1], old_sym int8[rcap + 1], ns_arr int8[rcap] (symbol + 1
    at item slots, else 0), nl_arr int32[rcap], n_items, used_phantom);
    index rcap of the old arrays is a trash slot."""
    rcap = state.rcap
    gdt = state.bstart.dtype
    dev = pos.device
    M = pos.shape[0]
    nslot = state.nslot
    inf = _inf(gdt)

    # ---- insertions compacted to dense rows 0..A-1 by tie rank ----
    tgt = torch.where(valid, stream, M)
    cpos = torch.zeros(M + 1, dtype=gdt, device=dev).scatter_(
        0, tgt, pos.to(gdt))[:M]
    csym = torch.full((M + 1,), PAD, dtype=torch.int8, device=dev).scatter_(
        0, tgt, sym.to(torch.int8))[:M]
    row = torch.arange(M, device=dev)
    live = row < valid.sum()
    cpos = torch.where(live, cpos, inf)

    # ---- host run of each insertion ----
    lens0 = slot_lengths(state.rend)
    rix = torch.searchsorted(run_ends(state, gdt), cpos.contiguous(),
                             right=True)
    rix = torch.minimum(rix, nslot)  # the run holding pos, or nslot at the end
    rixc = rix.clamp(max=rcap - 1)
    lenr = torch.where(live, lens0[rixc].long(), 0)
    hostsym = torch.where(live, state.rsym[rixc], PAD)
    estart = state.bstart[rixc // KR].long() + state.rend[rixc].long() - lenr
    off = torch.minimum((cpos.long() - estart).clamp_(min=0), lenr)
    off = torch.where(live, off, 0)

    # ---- groups (one per host run) and segments over the dense rows ----
    ghead = (row == 0) | (rix != _roll1(rix, -1))
    ext = live & (csym == hostsym)  # extends: no item
    sp = live & ~ext  # splits
    exti = ext.long()
    cex = torch.cumsum(exti, 0)  # inclusive extend count
    prev_is_dup = (sp & _roll1(sp, False) & (rix == _roll1(rix, -1))
                   & (off == _roll1(off, -1)) & (csym == _roll1(csym, PAD)))
    # next group head, next split and next non-duplicate at or after a row
    nh, ns_incl, nd = (flagged_rows(f, after=True, none=_BIG)
                       for f in (ghead, sp, ~prev_is_dup))
    gl = (_shift_up1(nh, _BIG) - 1).clamp_(max=M - 1)
    ns = _shift_up1(ns_incl, _BIG)  # next split strictly after a row
    nd = _shift_up1(nd, _BIG)
    # a group's extend count before it, and its first split: their values
    # at the group's head
    gh = flagged_rows(ghead)
    ce = cex - (cex - exti)[gh]  # extends of my group up to and including me
    fs = ns_incl[gh]

    nsc = ns.clamp(max=M - 1)
    in_group_ns = ns <= gl
    off_ns = torch.where(in_group_ns, off[nsc], lenr)
    ce_ns = torch.where(in_group_ns, ce[nsc] - exti[nsc], ce[gl])
    blen = (off_ns - off) + (ce_ns - ce)  # a split's right piece

    ahead = sp & ~prev_is_dup
    alen = torch.where(ahead, nd.clamp(max=M) - row, 0)

    # ---- host trim or replacement (at group heads) ----
    fsc = fs.clamp(max=M - 1)
    has_split = fs <= gl
    trim = torch.where(has_split, off[fsc] + (ce[fsc] - exti[fsc]),
                       lenr + ce[gl])
    replace = has_split & (trim == 0)
    host_len = torch.where(replace, alen[fsc], trim)
    host_sym = torch.where(replace, csym[fsc], hostsym)

    # ---- items ----
    emit_a = ahead & ~(replace & (row == fs))
    emit_b = sp & (blen > 0)
    ic = emit_a.long() + emit_b.long()
    icum = torch.cumsum(ic, 0) - ic  # items before me
    slot_a = torch.where(emit_a, rix + 1 + icum, rcap).clamp_(max=rcap)
    slot_b = torch.where(emit_b, rix + 1 + icum + emit_a.long(),
                         rcap).clamp_(max=rcap)
    ns_arr = torch.zeros(rcap + 1, dtype=torch.int8, device=dev)
    nl_arr = torch.zeros(rcap + 1, dtype=I32, device=dev)
    ns_arr.scatter_(0, slot_a, (csym + 1).to(torch.int8))
    nl_arr.scatter_(0, slot_a, alen.to(I32))
    ns_arr.scatter_(0, slot_b, (hostsym + 1).to(torch.int8))
    nl_arr.scatter_(0, slot_b, blen.to(I32))

    htgt = torch.where(ghead & live, rix, rcap).clamp_(max=rcap)
    old_len = torch.cat([lens0, lens0.new_zeros(1)]).scatter_(
        0, htgt, host_len.to(I32))
    old_sym = torch.cat([state.rsym, state.rsym.new_full((1,), PAD)]) \
        .scatter_(0, htgt, host_sym.to(torch.int8))
    used_phantom = (ghead & live & (rix == nslot)).any()
    return (old_len, old_sym, ns_arr[:rcap], nl_arr[:rcap], ic.sum(),
            used_phantom)


def _expand(old_len, old_sym, ns_arr, nl_arr, new_nslot):
    """out[p] = old[p - c(p)] at the slots that hold no item (c(p): items
    at or before p), the items at theirs, length 0 / PAD from new_nslot
    on; EXPAND_CHUNK slots a step, from the top chunk down and in place
    (a chunk reads only slots below its end, which no earlier step has
    written).  Returns (lengths, symbols, any length >= RUN_LEN_MAX)."""
    rcap = ns_arr.shape[0]
    dev = ns_arr.device
    ch = EXPAND_CHUNK
    is_new = ns_arr != 0
    los = range(0, rcap, ch)
    tot = torch.stack([is_new[lo: lo + ch].sum() for lo in los])
    before = torch.cumsum(tot, 0) - tot
    too_long = torch.zeros((), dtype=torch.bool, device=dev)
    for k in reversed(range(len(los))):
        lo = los[k]
        hi = min(lo + ch, rcap)
        isn = is_new[lo:hi]
        p = torch.arange(lo, hi, device=dev)
        src = (p - before[k] - torch.cumsum(isn, 0)).clamp_(min=0)
        dead = p >= new_nslot
        ln = torch.where(isn, nl_arr[lo:hi], old_len[src]).masked_fill_(
            dead, 0)
        sy = torch.where(isn, ns_arr[lo:hi] - 1, old_sym[src]).masked_fill_(
            dead, PAD)
        old_len[lo:hi] = ln
        old_sym[lo:hi] = sy
        too_long |= (ln >= RUN_LEN_MAX).any()
    return old_len[:rcap], old_sym[:rcap], too_long


def apply_insertions_runs(state: RunBwt, pos, sym, stream, valid):
    """Apply one coalesced batch of insertions to the run arrays.

    pos: int[M] old-coordinate global insertion points (non-decreasing in
    tie-rank order); sym: int[M]; stream: int[M] dense tie ranks over the
    valid rows; valid: bool[M].  Returns the updated (rsym, rend, bstart,
    bocc, nslot, overflow) as a dict for dataclasses.replace.  Nothing is
    read back to the host."""
    old_len, old_sym, ns_arr, nl_arr, n_items, used_phantom = _plan_items(
        state, pos, sym, stream, valid)
    new_nslot = state.nslot + n_items + used_phantom.long()
    new_len, new_sym, too_long = _expand(old_len, old_sym, ns_arr, nl_arr,
                                         new_nslot)
    overflow = state.overflow + (new_nslot > state.rcap - KR).to(I32) \
        + too_long.to(I32)
    rend, bstart, bocc = _rebuild_tables(new_len, new_sym, new_nslot,
                                         state.bstart.dtype)
    return dict(rsym=new_sym, rend=rend, bstart=bstart, bocc=bocc,
                nslot=new_nslot, overflow=overflow)


def runs_from_arrays(syms, lens, rcap, total_symbol_bound, n, psize,
                     pcounts, device=None) -> RunBwt:
    """A RunBwt from run arrays (numpy arrays or tensors; lengths in
    [1, RUN_LEN_MAX)) in ``rcap`` slots, on ``device`` (None: the
    tensors' device, or the card for numpy arrays)."""
    if device is None and isinstance(syms, torch.Tensor):
        device = syms.device
    device = resolve_device(device, "runs_from_arrays")
    syms = torch.as_tensor(syms).to(device=device, dtype=torch.int8)
    lens = torch.as_tensor(lens).to(device=device)
    nr = syms.shape[0]
    if rcap % RCAP_ALIGN or rcap < nr + KR:
        raise ValueError(f"rcap {rcap} does not hold {nr} runs")
    if nr and not bool(((lens > 0) & (lens < RUN_LEN_MAX)).all()):
        raise ValueError(f"run lengths must lie in [1, {RUN_LEN_MAX})")
    full_syms = torch.full((rcap,), PAD, dtype=torch.int8, device=device)
    full_syms[:nr] = syms
    full_lens = torch.zeros(rcap, dtype=I32, device=device)
    full_lens[:nr] = lens.to(I32)
    nslot = torch.tensor(nr, dtype=I64, device=device)
    rend, bstart, bocc = _rebuild_tables(
        full_lens, full_syms, nslot, gdt_for_symbols(total_symbol_bound))

    def i64(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=I64)
        return torch.as_tensor(np.asarray(x, dtype=np.int64)).to(device)

    return RunBwt(rsym=full_syms, rend=rend, bstart=bstart, bocc=bocc,
                  nslot=nslot, n=i64(n), psize=i64(psize),
                  pcounts=i64(pcounts),
                  overflow=torch.zeros((), dtype=I32, device=device))


def runs_to_host(state: RunBwt):
    """(syms int8, lens int64) numpy arrays of the live slots (slots of
    length 0, which the flush never emits, are dropped)."""
    ns = int(state.nslot)
    syms = state.rsym[:ns].cpu().numpy()
    lens = slot_lengths(state.rend)[:ns].long().cpu().numpy()
    keep = lens > 0
    return syms[keep], lens[keep]
