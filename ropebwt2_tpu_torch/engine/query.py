"""Batched FM-index queries (counterpart of ropebwt2_tpu/engine/query.py):
the library surface downstream tools use (mr_rank2a, mrope.c:70-105;
rld_rank1a/2a and rld_extend, rld0.c:357-489).

Every function takes the index state (a FlatBwt, a PackedFlatBwt or a
RunBwt) and a batch of queries: positions (Q,), intervals, or bi-intervals
(Q, 3) in rld's convention x = (backward start, forward start, size)
(rld0.h:43-46).
Queries may be tensors, arrays or lists; they move to the index's device.
The work is plain torch on that device around the rank kernels
(index/rank_cuda.py), and every result is int64.
"""

import torch

from ..alphabet import NSYM
from ..index.flat import FlatBwt
from ..index import rank_cuda
from ..index.packed import PackedFlatBwt
from ..index.runs import RunBwt, rank_global_runs

I64 = torch.int64


def _tier(state) -> str:
    """The state's tier: "flat", "packed" or "runs"."""
    for cls, name in ((FlatBwt, "flat"), (PackedFlatBwt, "packed"),
                      (RunBwt, "runs")):
        if isinstance(state, cls):
            return name
    raise TypeError(f"not an index state: {type(state).__name__}")


def _state_K(state, K):
    """The block size, derived from the state's shapes; an explicit K only
    overrides it (and must then match the index's).  The packed tier's
    tables are per 128-symbol row, and the run tier has no K."""
    if _tier(state) != "flat":
        return 128
    if K is not None:
        return K
    return state.bwt.shape[0] // (state.blk_prefix.shape[0] - 1)


def _device(state):
    return state.n.device


def _as64(state, x):
    """x as an int64 tensor on the index's device."""
    return torch.as_tensor(x, dtype=I64, device=_device(state))


def _base_rank(state, pos, K):
    tier = _tier(state)
    if tier == "runs":
        return rank_global_runs(state.rend, state.rsym, state.bstart,
                                state.bocc, pos).long()
    if tier == "packed":
        return rank_cuda.rank_packed(state.pbwt, state.blkA, state.blkB, pos)
    return rank_cuda.rank_flat(state.bwt, state.blk_prefix, pos, K).long()


def _C(state):
    """Accumulative counts C(a) = # symbols < a (rld's e->cnt after
    finish), int64[7] with C[6] = the total."""
    tot = state.pcounts.sum(dim=0)
    return torch.cat([tot.new_zeros(1), torch.cumsum(tot, 0)])


def rank1a(state, pos, *, K=None):
    """occ[q, s] = # of symbol s in BWT[0:pos[q]] (rld_rank1a / mr_rank2a
    single-point)."""
    return _base_rank(state, _as64(state, pos), _state_K(state, K))


def rank2a(state, x, y, *, K=None):
    """Two-point rank: returns (occ_x, occ_y), each (Q, 6)."""
    K = _state_K(state, K)
    return (_base_rank(state, _as64(state, x), K),
            _base_rank(state, _as64(state, y), K))


def _pick(occ, c):
    """occ[q, c[q]] of a (Q, 6) table."""
    return occ.gather(1, c[:, None])[:, 0]


def rank11(state, pos, c, *, K=None):
    """Single-symbol rank (rld_rank11): # of symbol c[q] in BWT[0:pos[q]]."""
    return _pick(rank1a(state, pos, K=K), _as64(state, c))


def rank21(state, x, y, c, *, K=None):
    """Single-symbol two-point rank (rld_rank21)."""
    ox, oy = rank2a(state, x, y, K=K)
    c = _as64(state, c)
    return _pick(ox, c), _pick(oy, c)


def extend(state, ik, *, is_back=True, K=None):
    """Batched rld_extend (rld0.c:473-489): one backward (is_back=True) or
    forward extension step of bi-intervals.

    ik: (Q, 3) int (x0=backward, x1=forward, size).  Returns ok (Q, 6, 3):
    for each symbol a, the bi-interval of aP (backward) or Pa~ (forward)."""
    C = _C(state)
    ik = _as64(state, ik)
    p = ik[:, 0] if is_back else ik[:, 1]
    tk, tl = rank2a(state, p, p + ik[:, 2], K=K)
    size = tl - tk  # (Q, 6)
    same = C[None, :NSYM] + tk  # new x[!is_back] per symbol

    # the other coordinate accumulates in complement order 0,4,3,2,1,5
    # (rld0.c:482-487)
    other = [None] * NSYM
    other[0] = ik[:, 1] if is_back else ik[:, 0]
    other[4] = other[0] + size[:, 0]
    other[3] = other[4] + size[:, 4]
    other[2] = other[3] + size[:, 3]
    other[1] = other[2] + size[:, 2]
    other[5] = other[1] + size[:, 1]
    other = torch.stack(other, dim=1)  # (Q, 6)

    if is_back:
        return torch.stack([same, other, size], dim=2)
    return torch.stack([other, same, size], dim=2)


def backward_search(state, patterns, lengths, *, K=None):
    """Count occurrences of patterns (as substrings of the indexed
    strings).

    patterns: (Q, Lmax) nt6 codes aligned to the RIGHT end at column
    Lmax - 1 (the search runs from the last symbol backward); lengths:
    (Q,).  Returns (lo, hi), the SA interval of each pattern; hi - lo is
    its number of occurrences.  One step per column, a host loop that
    reads nothing back from the device."""
    C = _C(state)
    patterns = _as64(state, patterns)
    lengths = _as64(state, lengths)
    q, lmax = patterns.shape
    lo = torch.zeros(q, dtype=I64, device=patterns.device)
    hi = C[NSYM].expand(q).clone()
    for i in range(lmax):
        a = patterns[:, lmax - 1 - i]
        ol, oh = rank2a(state, lo, hi, K=K)
        act = i < lengths
        lo = torch.where(act, C[a] + _pick(ol, a), lo)
        hi = torch.where(act, C[a] + _pick(oh, a), hi)
    return lo, hi
