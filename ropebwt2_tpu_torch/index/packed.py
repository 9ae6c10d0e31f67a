"""4-bit packed BWT storage, the capacity tier (counterpart of
ropebwt2_tpu/index/packed.py, whose module docstring holds the design).

Two symbols per byte in VERTICAL PLANE PAIRS of 128-symbol rows:

    packed[r, j] = sym[(2r) * 128 + j]  |  sym[(2r+1) * 128 + j] << 4

so symbol row 2r is the low nibble plane of packed row r and row 2r+1 the
high one.  The rank tables are TWO-LEVEL, for K = 128: an int64 anchor row
per 2^24 symbols (``blkA``) and int32 rows relative to their anchor
(``blkB``), in the plane-separated layout of blkb_row.  The layout is the
JAX package's bit for bit, so a JAX state converts 1:1 (convert.py).

Content past ``n`` is unspecified and never read, as in the flat tier.
Plain torch on either device; apply_insertions_packed with
build_two_level_tables is the plain version of kernel C
(merge_packed_cuda.py).
"""

import dataclasses

import numpy as np
import torch

from ..alphabet import NSYM
from .flat import PAD
from .merge import apply_insertions
from .rank import prefix_rows

LANE = 128
ACHUNK = 1 << 24  # symbols per int64 anchor row
PPAD_ROWS = 16  # packed-row tail slack (the JAX state's)
PACKED_PAD_BYTE = PAD | (PAD << 4)


@dataclasses.dataclass
class PackedFlatBwt:
    """Capacity-tier state: the 4-bit packed buffer and its two-level
    tables, with the flat tier's n/psize/pcounts bookkeeping."""

    pbwt: torch.Tensor  # uint8[cap // 2 + PPAD_ROWS * LANE]
    n: torch.Tensor  # int64 0-dim
    psize: torch.Tensor  # int64[6]
    pcounts: torch.Tensor  # int64[6, 6]
    blkA: torch.Tensor  # int64[ceil(cap / ACHUNK) + 1, 6] anchor rows
    blkB: torch.Tensor  # int32[2 * (cap // 256) + 2, 6] anchor-relative

    @property
    def cap(self) -> int:
        return (self.pbwt.shape[0] - PPAD_ROWS * LANE) * 2


def _n_anchors(cap: int) -> int:
    return -(-cap // ACHUNK)


def empty_packed_state(cap: int, device) -> PackedFlatBwt:
    if cap % 256:
        raise ValueError(f"packed capacity {cap} is not a multiple of 256")
    return PackedFlatBwt(
        pbwt=torch.full((cap // 2 + PPAD_ROWS * LANE,), PACKED_PAD_BYTE,
                        dtype=torch.uint8, device=device),
        n=torch.zeros((), dtype=torch.int64, device=device),
        psize=torch.zeros(NSYM, dtype=torch.int64, device=device),
        pcounts=torch.zeros((NSYM, NSYM), dtype=torch.int64, device=device),
        blkA=torch.zeros((_n_anchors(cap) + 1, NSYM), dtype=torch.int64,
                         device=device),
        blkB=torch.zeros((2 * (cap // 256) + 2, NSYM), dtype=torch.int32,
                         device=device),
    )


def grow_packed_state(state: PackedFlatBwt, new_cap: int) -> PackedFlatBwt:
    """Extend the allocation and its tables (between batches).  Every
    appended table row stands for a position past the old capacity, hence
    past n, so the extension repeats the boundary rows; the next merge
    rebuilds both levels."""
    old_cap = state.cap
    if new_cap % 256 or new_cap < old_cap:
        raise ValueError(f"bad new packed capacity {new_cap} (cap {old_cap})")
    if new_cap == old_cap:
        return state
    dev = state.pbwt.device
    pbwt = torch.cat([
        state.pbwt[: old_cap // 2],
        torch.full((new_cap // 2 + PPAD_ROWS * LANE - old_cap // 2,),
                   PACKED_PAD_BYTE, dtype=torch.uint8, device=dev),
    ])
    n_old, n_new = old_cap // 256, new_cap // 256
    lo_old = state.blkB[: n_old + 1]
    hi_old = state.blkB[n_old + 1:]
    b_bound = lo_old[n_old:]
    blkB = torch.cat([
        lo_old, b_bound.expand(n_new - n_old, NSYM),
        hi_old[:n_old], b_bound.expand(n_new + 1 - n_old, NSYM),
    ])
    rows_a = _n_anchors(new_cap) + 1
    blkA = state.blkA[:rows_a]
    if rows_a > blkA.shape[0]:
        blkA = torch.cat([blkA, blkA[-1:].expand(rows_a - blkA.shape[0],
                                                 NSYM)])
    return dataclasses.replace(state, pbwt=pbwt, blkA=blkA, blkB=blkB)


def packed_from_flat(state, new_cap: int) -> PackedFlatBwt:
    """A flat.FlatBwt (cap % 256 == 0) in the capacity tier at ``new_cap``
    (>= its capacity): pack the buffer, build the tables once, then grow.
    Symbols outside the alphabet (content past n) pack as PAD."""
    cap = state.cap
    if cap % 256 or new_cap % 256 or new_cap < cap:
        raise ValueError(f"cannot pack capacity {cap} into {new_cap}")
    body = state.bwt[:cap]
    body = torch.where((body < 0) | (body > PAD), PAD, body)
    pbwt = torch.cat([
        pack_bwt(body),
        torch.full((PPAD_ROWS * LANE,), PACKED_PAD_BYTE, dtype=torch.uint8,
                   device=body.device),
    ])
    blkA, blkB = build_two_level_tables(pbwt, cap)
    st = PackedFlatBwt(pbwt=pbwt, n=state.n, psize=state.psize,
                       pcounts=state.pcounts, blkA=blkA, blkB=blkB)
    return grow_packed_state(st, new_cap)


def pack_bwt(sym_flat):
    """int8[N] symbols in [0, 16) (N % 256 == 0) -> uint8[N // 2]."""
    rows = sym_flat.view(-1, 2, LANE).to(torch.uint8)
    return (rows[:, 0, :] | (rows[:, 1, :] << 4)).reshape(-1)


def unpack_bwt(packed_flat):
    """uint8[N // 2] -> int8[N] symbols (inverse of pack_bwt)."""
    p = packed_flat.view(-1, LANE)
    return torch.stack([p & 0xF, p >> 4], dim=1).reshape(-1).to(torch.int8)


def pack_bwt_np(sym_flat):
    rows = np.asarray(sym_flat).reshape(-1, 2, LANE).astype(np.uint8)
    return (rows[:, 0, :] | (rows[:, 1, :] << 4)).reshape(-1)


def unpack_bwt_np(packed_flat):
    p = np.asarray(packed_flat).reshape(-1, LANE)
    out = np.empty((p.shape[0], 2, LANE), np.int8)
    out[:, 0, :] = p & 0xF
    out[:, 1, :] = p >> 4
    return out.reshape(-1)


def plane_counts(packed_flat, cap):
    """(lo6, hi6) int32[cap // 256, 6]: per packed row, the counts of the 6
    symbols in its low and its high nibble plane."""
    p = packed_flat[: cap // 2].view(-1, LANE)
    out = []
    for plane in (p & 0xF, p >> 4):
        out.append(torch.stack(
            [(plane == s).sum(dim=1, dtype=torch.int32) for s in range(NSYM)],
            dim=1))
    return out[0], out[1]


def build_two_level_tables(packed_flat, cap):
    """(blkA, blkB) of a packed buffer for K = 128 (counted from the
    buffer: the plain version of kernel C's counts)."""
    return tables_from_plane_counts(*plane_counts(packed_flat, cap), cap)


def blkb_row(blk, nprows):
    """blkB row of symbol row ``blk`` in the plane-separated layout: the
    low-plane prefixes fill rows [0, N], the high-plane ones rows
    [N + 1, 2N + 1] (N = nprows = cap // 256)."""
    return (blk >> 1) + (blk & 1) * (nprows + 1)


def tables_from_plane_counts(lo6, hi6, cap):
    """Two-level tables from per-packed-row, per-plane symbol counts (each
    int[cap // 256, 6]).

    PS[u] = the int64 prefix of all symbols before symbol row 2u.  An
    anchor row is PS at a chunk start; blkB row u (low plane) is PS[u]
    less its chunk's anchor, and row N + 1 + u (high plane, symbol row
    2u + 1) adds the low plane of packed row u.  A chunk holds 2^24
    symbols, so the anchor-relative rows fit int32 exactly."""
    nprows = cap // (2 * LANE)
    rpc = ACHUNK // (2 * LANE)  # packed rows per anchor chunk
    dev = lo6.device
    ps = prefix_rows(lo6.int() + hi6.int(), torch.int64)  # (N + 1, 6)
    na = _n_anchors(cap)
    bnd = (torch.arange(na + 1, device=dev) * rpc).clamp(max=nprows)
    anchors = ps[bnd]  # (na + 1, 6)
    arow = (torch.arange(nprows + 1, device=dev) // rpc).clamp(max=na)
    rel_lo = (ps - anchors[arow]).int()
    rel_hi = rel_lo + torch.cat([lo6.int(), lo6.new_zeros((1, NSYM)).int()])
    return anchors, torch.cat([rel_lo, rel_hi])


def rank_global_packed(pbwt, blkA, blkB, pos):
    """Batched 6-symbol rank over the packed buffer: out[q, s] = |{ i <
    pos[q] : sym[i] == s }| as int64, for 0 <= pos[q] <= n.  Positions out
    of range (inert rows of a round) are clamped, never faulted, and their
    rows are meaningless."""
    nprows = blkB.shape[0] // 2 - 1
    nrp = pbwt.shape[0] // LANE
    blk = torch.div(pos, LANE, rounding_mode="floor").clamp(0, 2 * nprows + 1)
    within = pos - blk * LANE
    a = torch.div(pos, ACHUNK, rounding_mode="floor").clamp(
        0, blkA.shape[0] - 1)
    base = blkA[a] + blkB[blkb_row(blk, nprows)].long()
    rows = pbwt.view(-1, LANE)[(blk >> 1).clamp(max=nrp - 1)]  # (Q, 128)
    nib = torch.where((blk & 1)[:, None] == 1, rows >> 4, rows & 0xF)
    j = torch.arange(LANE, device=pos.device)
    inmask = j[None, :] < within[:, None]
    sym = torch.arange(NSYM, dtype=nib.dtype, device=pos.device)
    eq = (nib[:, :, None] == sym[None, None, :]) & inmask[:, :, None]
    return base + eq.sum(dim=1)


def apply_insertions_packed(pbwt, n, pos, sym, stream, valid):
    """The plain packed merge: unpack, merge.apply_insertions, repack."""
    new = apply_insertions(unpack_bwt(pbwt), n, pos, sym, stream, valid)
    return pack_bwt(torch.where(new > PAD, PAD, new))
