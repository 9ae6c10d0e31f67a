"""The rank kernels (csrc/rank.cu): the 6-symbol rank at a batch of
positions, counted inside the 128-symbol row on the card, for the flat
tier, the packed tier, the pending index and the virtual (base + pending)
sequence of a deferred round on the flat and the packed tier.

Each wrapper takes the arguments of its plain version and returns what it
returns, bit for bit (dtypes and the clamps of out-of-range positions
included): ``rank_flat`` of index/rank.py::rank_global, ``rank_packed``
of index/packed.py::rank_global_packed, ``pending_rank`` of
index/pending.py::pending_rank, ``rank_virtual_flat`` of
index/pending.py::rank_virtual, ``rank_virtual_packed`` of
index/pending.py::rank_virtual_packed.  On CPU tensors a wrapper runs its
plain version; on CUDA tensors it launches its kernel, or raises.

``rank_virtual_flat`` and ``rank_virtual_packed`` are the flat and the
packed tier's deferred rank in one launch each: the pending search and
count and the base count at g - p in one kernel."""

import torch

from .. import _build
from ..alphabet import NSYM
from ..utils import launches

LANE = 128  # symbols per count row
MAX_K = 1024  # the kernel's 8-bit per-thread counts hold K / 8 symbols
# kernel launches by this process, per kernel (utils/launches.py)
LAUNCHES = {"rank_flat": 0, "rank_packed": 0, "rank_pend": 0,
            "rank_virtual": 0, "rank_virtual_packed": 0}
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def rank_flat(bwt, blk_prefix, pos, K: int):
    """rank_global(bwt, blk_prefix, pos, K), in blk_prefix's dtype."""
    if bwt.device.type == "cpu":
        from .rank import rank_global

        return rank_global(bwt, blk_prefix, pos, K)
    pos = pos.contiguous()
    _check("rank_flat", bwt, [*_flat_args("rank_flat", bwt, blk_prefix, K),
                              *_query_args(pos)])
    out = torch.empty((pos.shape[0], NSYM), dtype=blk_prefix.dtype,
                      device=bwt.device)
    q = pos.shape[0]
    _launch("rank_flat", bwt.device, q, _build.lib().rb2_rank_flat,
            bwt.data_ptr(), blk_prefix.data_ptr(), pos.data_ptr(),
            out.data_ptr(), q, K, blk_prefix.shape[0], bwt.shape[0] // K,
            int(blk_prefix.dtype == torch.int64))
    return out


def rank_packed(pbwt, blkA, blkB, pos):
    """rank_global_packed(pbwt, blkA, blkB, pos), int64."""
    if pbwt.device.type == "cpu":
        from .packed import rank_global_packed

        return rank_global_packed(pbwt, blkA, blkB, pos)
    pos = pos.contiguous()
    _check("rank_packed", pbwt, [
        *_packed_args("rank_packed", pbwt, blkA, blkB), *_query_args(pos)])
    out = torch.empty((pos.shape[0], NSYM), dtype=torch.int64,
                      device=pbwt.device)
    q = pos.shape[0]
    _launch("rank_packed", pbwt.device, q, _build.lib().rb2_rank_packed,
            pbwt.data_ptr(), blkA.data_ptr(), blkB.data_ptr(),
            pos.data_ptr(), out.data_ptr(), q,
            *_packed_dims(pbwt, blkA, blkB))
    return out


def pending_rank(pend, g):
    """(p, occ) of index/pending.py::pending_rank: p int64[Q] = |{ i :
    vp[i] < g[q] }| and occ int32[Q, 6] the counts of the 6 symbols among
    those rows."""
    if pend.vp.device.type == "cpu":
        from .pending import pending_rank as plain

        return plain(pend, g)
    g = g.contiguous()
    pcap = pend.vp.shape[0]
    _check("rank_pend", pend.vp, [*_pend_args("rank_pend", pend),
                                  ("g", g, torch.int64, (g.shape[0],))])
    q = g.shape[0]
    p = torch.empty(q, dtype=torch.int64, device=g.device)
    occ = torch.empty((q, NSYM), dtype=torch.int32, device=g.device)
    _launch("rank_pend", g.device, q, _build.lib().rb2_rank_pend,
            pend.vp.data_ptr(), pend.psym.data_ptr(),
            pend.blk_prefix.data_ptr(), g.data_ptr(), p.data_ptr(),
            occ.data_ptr(), q, pcap)
    return p, occ


def rank_virtual_flat(bwt, blk_prefix, pend, g, K: int, lo=None, hi=None):
    """index/pending.py::rank_virtual: the 6-symbol rank of the virtual
    (base + pending) sequence at ``g``, rank_global at g - p (clamped to
    [lo, hi] when given) plus pending_rank's counts, in blk_prefix's
    dtype; p = |{ i : vp[i] < g }|.  One launch of the virtual kernel."""
    if bwt.device.type == "cpu":
        from .pending import rank_virtual

        return rank_virtual(bwt, blk_prefix, pend, g, K, lo, hi)
    g = g.contiguous()
    pcap = pend.vp.shape[0]
    _check("rank_virtual", bwt, [
        *_flat_args("rank_virtual", bwt, blk_prefix, K),
        *_pend_args("rank_virtual", pend),
        ("g", g, torch.int64, (g.shape[0],))])
    lo = I64_MIN if lo is None else int(lo)
    hi = I64_MAX if hi is None else int(hi)
    if lo > hi:
        raise ValueError(f"rank_virtual: the clamp [{lo}, {hi}] is empty")
    out = torch.empty((g.shape[0], NSYM), dtype=blk_prefix.dtype,
                      device=bwt.device)
    q = g.shape[0]
    _launch("rank_virtual", bwt.device, q, _build.lib().rb2_rank_virtual,
            bwt.data_ptr(), blk_prefix.data_ptr(), pend.vp.data_ptr(),
            pend.psym.data_ptr(), pend.blk_prefix.data_ptr(), g.data_ptr(),
            out.data_ptr(), q, K, blk_prefix.shape[0], bwt.shape[0] // K,
            pcap, lo, hi, int(blk_prefix.dtype == torch.int64))
    return out


def rank_virtual_packed(pbwt, blkA, blkB, pend, g):
    """index/pending.py::rank_virtual_packed: the 6-symbol rank of the
    virtual (base + pending) sequence at ``g`` over a packed base,
    rank_global_packed at g - p plus pending_rank's counts, int64; p =
    |{ i : vp[i] < g }|.  One launch of the packed virtual kernel."""
    if pbwt.device.type == "cpu":
        from .pending import rank_virtual_packed as plain

        return plain(pbwt, blkA, blkB, pend, g)
    g = g.contiguous()
    _check("rank_virtual_packed", pbwt, [
        *_packed_args("rank_virtual_packed", pbwt, blkA, blkB),
        *_pend_args("rank_virtual_packed", pend),
        ("g", g, torch.int64, (g.shape[0],))])
    out = torch.empty((g.shape[0], NSYM), dtype=torch.int64,
                      device=pbwt.device)
    q = g.shape[0]
    _launch("rank_virtual_packed", pbwt.device, q,
            _build.lib().rb2_rank_virtual_packed, pbwt.data_ptr(),
            blkA.data_ptr(), blkB.data_ptr(), pend.vp.data_ptr(),
            pend.psym.data_ptr(), pend.blk_prefix.data_ptr(), g.data_ptr(),
            out.data_ptr(), q, *_packed_dims(pbwt, blkA, blkB),
            pend.vp.shape[0])
    return out


def shifted(rank_fn, pos, sub=None, extra=None):
    """rank_fn(pos - sub) + extra in rank_fn's dtype, by plain torch: the
    base rank of the run tier, which has no kernel."""
    out = rank_fn(pos if sub is None else pos - sub)
    return out if extra is None else out + extra.to(out.dtype)


def _flat_args(what, bwt, blk_prefix, K):
    """The checks of a flat buffer and its K-block prefix table (and K);
    the (name, tensor, dtype, shape) checks for _check."""
    if K % LANE or not LANE <= K <= MAX_K:
        raise ValueError(f"{what}: K {K} is not a multiple of {LANE} in "
                         f"[{LANE}, {MAX_K}]")
    if blk_prefix.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: prefix dtype {blk_prefix.dtype} is "
                         "neither int32 nor int64")
    if bwt.shape[0] % K:
        raise ValueError(f"{what}: buffer {bwt.shape[0]} is not a "
                         f"multiple of K {K}")
    _aligned(what, "bwt", bwt)
    return [("bwt", bwt, torch.int8, (bwt.shape[0],)),
            ("prefix", blk_prefix, blk_prefix.dtype,
             (blk_prefix.shape[0], NSYM))]


def _packed_args(what, pbwt, blkA, blkB):
    """The checks of a packed buffer of whole 128-byte rows (16-byte
    aligned) and its two-level tables; the (name, tensor, dtype, shape)
    checks for _check."""
    if pbwt.shape[0] % LANE or blkB.shape[0] % 2 or blkB.shape[0] < 2:
        raise ValueError(f"{what}: buffer {pbwt.shape[0]} or blkB rows "
                         f"{blkB.shape[0]} do not make whole packed rows")
    _aligned(what, "pbwt", pbwt)
    return [("pbwt", pbwt, torch.uint8, (pbwt.shape[0],)),
            ("blkA", blkA, torch.int64, (blkA.shape[0], NSYM)),
            ("blkB", blkB, torch.int32, (blkB.shape[0], NSYM))]


def _packed_dims(pbwt, blkA, blkB):
    """(nprows, nrp, nanchor): the packed kernels' table sizes."""
    return blkB.shape[0] // 2 - 1, pbwt.shape[0] // LANE, blkA.shape[0]


def _pend_args(what, pend):
    """The checks of a pending index (its capacity a multiple of 128, its
    planes 16-byte aligned); the (name, tensor, dtype, shape) checks."""
    pcap = pend.vp.shape[0]
    if pcap % LANE or not 0 < pcap < LANE << 31:
        raise ValueError(f"{what}: capacity {pcap} is not a multiple of "
                         f"{LANE} in [{LANE}, 2^38)")
    _aligned(what, "vp", pend.vp)
    _aligned(what, "psym", pend.psym)
    return [("vp", pend.vp, torch.int64, (pcap,)),
            ("psym", pend.psym, torch.int8, (pcap,)),
            ("pending prefix", pend.blk_prefix, torch.int32,
             (pcap // LANE + 1, NSYM))]


def _query_args(pos):
    """The (name, tensor, dtype, shape) checks of a query batch."""
    return [("pos", pos, torch.int64,
             (pos.shape[0] if pos.dim() == 1 else -1,))]


def _check(what, first, args):
    if not first.is_cuda:
        raise ValueError(f"{what}: unsupported device {first.device}")
    for name, t, dt, shape in args:
        if (t.device != first.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{dt}{list(shape)} on {first.device}, not "
                             f"{t.dtype}{list(t.shape)} on {t.device}")


def _aligned(what, name, t):
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _launch(name, device, q, fn, *args):
    """fn(*args, stream) on the device's current stream; no launch for an
    empty batch (q queries)."""
    if q == 0:
        return
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(rc, f"rb2_{name}")
    launches.launched(LAUNCHES, name)
