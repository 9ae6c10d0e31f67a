"""Kernel A: the flat-BWT merge (csrc/merge.cu), which replaces the JAX
package's Pallas kernel ropebwt2_tpu/index/merge_pallas.py::merge_pallas.

``merge`` applies one round's (or one pending flush's) insertions and
returns the new buffer with its K-block rank prefix.  On CPU tensors it
runs the plain version (merge.apply_insertions + rank.build_block_tables);
on CUDA tensors it launches the kernel, or raises."""

import torch

from .. import _build
from .flat import PAD_TAIL, table_dtype
from .merge import apply_insertions
from .rank import build_block_tables, prefix_rows

BS = 4096  # output symbols per CTA (csrc/common.cuh)
LANE = 128  # symbols per count row
LAUNCHES = 0  # kernel launches by this process


def merge(bwt, pos, sym, stream, valid, n, K: int):
    """(new_bwt, blk_prefix) after inserting sym[i] at pos[i] + stream[i]
    for every valid i (flat.py's buffer layout, merge.py's contract).

    bwt: int8[alloc] with alloc = cap + PAD_TAIL; pos/stream: int64[M];
    sym: int64[M]; valid: bool[M]; n: int64 0-dim live size.  Content past
    n + #insertions is unspecified on return, and so are the table rows
    past it; the rows at or below it are exact."""
    cap_tdt = table_dtype(bwt.shape[0] - PAD_TAIL)
    if bwt.device.type == "cpu":
        new = apply_insertions(bwt, n, pos, sym, stream, valid)
        return new, build_block_tables(new, K, dtype=cap_tdt)
    _check(bwt, pos, sym, stream, valid, n, K)
    global LAUNCHES
    alloc = bwt.shape[0]
    nb = -(-alloc // BS)
    dev = bwt.device
    dest = torch.where(valid, pos + stream, nb * BS)  # nb*BS: trash slot
    insmap = torch.zeros(nb * BS + 1, dtype=torch.int8, device=dev)
    insmap.scatter_(0, dest, (sym + 1).to(torch.int8))
    # exclusive per-CTA insertion prefix, from the M insertions (not cap)
    blk = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    blk.index_add_(0, dest // BS, torch.ones_like(dest))
    start = torch.cat([blk.new_zeros(1), torch.cumsum(blk[:nb], 0)])
    out = torch.empty_like(bwt)
    rows = torch.empty((nb * (BS // LANE), 6), dtype=torch.int32, device=dev)
    rc = _build.lib().rb2_merge(
        bwt.data_ptr(), insmap.data_ptr(), start.data_ptr(), n.data_ptr(),
        out.data_ptr(), rows.data_ptr(), alloc, nb,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "rb2_merge")
    LAUNCHES += 1
    cnt = rows[: alloc // LANE]
    if K != LANE:
        cnt = cnt.view(-1, K // LANE, 6).sum(dim=1, dtype=torch.int32)
    return out, prefix_rows(cnt, cap_tdt)


def _check(bwt, pos, sym, stream, valid, n, K):
    if not bwt.is_cuda:
        raise ValueError(f"merge: unsupported device {bwt.device}")
    if bwt.dtype != torch.int8 or bwt.dim() != 1 or not bwt.is_contiguous():
        raise ValueError("merge: bwt must be a contiguous 1-D int8 tensor")
    if bwt.shape[0] % K or K % LANE:
        raise ValueError(f"merge: allocation {bwt.shape[0]} must be a "
                         f"multiple of K {K}, and K of {LANE}")
    check_lanes("merge", bwt.device, pos, sym, stream, valid, n)


def check_lanes(fn, device, pos, sym, stream, valid, n):
    """Raise unless a merge's insertion lanes (int64 pos/sym/stream, bool
    valid, all of one shape) and its 0-dim int64 n are on ``device``."""
    m = pos.shape
    for name, t, dt in (("pos", pos, torch.int64), ("sym", sym, torch.int64),
                        ("stream", stream, torch.int64),
                        ("valid", valid, torch.bool)):
        if t.device != device or t.dtype != dt or t.shape != m:
            raise ValueError(f"{fn}: {name} must be {dt}{list(m)} on "
                             f"{device}")
    if n.device != device or n.dtype != torch.int64 or n.dim() != 0:
        raise ValueError(f"{fn}: n must be a 0-dim int64 tensor on the card")
