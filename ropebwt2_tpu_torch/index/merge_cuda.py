"""Kernel A: the flat-BWT merge (csrc/merge.cu), which replaces the JAX
package's Pallas kernel ropebwt2_tpu/index/merge_pallas.py::merge_pallas.

``merge`` applies one round's (or one pending flush's) insertions and
returns the new buffer with its K-block rank prefix.  On CPU tensors it
runs the plain version (merge.apply_insertions + rank.build_block_tables);
on CUDA tensors it launches the kernel, or raises.

On the card ``merge`` is four steps, each a function of its own so that
the probe suite (probes/merge_phases.py) times the same code the build
runs: ``insertion_map`` (zero-fill and scatter), ``block_prefix`` (per-CTA
insertion prefix), ``run_kernel`` (kernel A alone) and ``tables`` (the
K-block prefix from the kernel's row counts)."""

import torch

from .. import _build
from .flat import PAD, PAD_TAIL, table_dtype
from .merge import apply_insertions
from .rank import build_block_tables, prefix_rows

BS = 4096  # output symbols per CTA (csrc/common.cuh)
LANE = 128  # symbols per count row
LAUNCHES = 0  # kernel launches by this process (CUDA-graph captures not)


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
    nb = -(-bwt.shape[0] // BS)
    dest, insmap = insertion_map(pos, sym, stream, valid, nb)
    out, rows = run_kernel(bwt, insmap, block_prefix(dest, nb), n)
    return out, tables(rows, bwt.shape[0], K, cap_tdt)


def insertion_map(pos, sym, stream, valid, nb: int):
    """(dest, insmap): every lane's destination pos + stream (nb * BS, a
    trash slot, for a masked lane) and the int8[nb * BS + 1] map holding
    sym + 1 at each destination and 0 elsewhere."""
    dest = torch.where(valid, pos + stream, nb * BS)
    insmap = torch.zeros(nb * BS + 1, dtype=torch.int8, device=pos.device)
    insmap.scatter_(0, dest, (sym + 1).to(torch.int8))
    return dest, insmap


def block_prefix(dest, nb: int):
    """int64[nb + 1]: the exclusive insertion prefix of every 4096-symbol
    CTA, from the M destinations (not from cap); the last entry is the
    number of insertions."""
    blk = torch.zeros(nb + 1, dtype=torch.int64, device=dest.device)
    blk.index_add_(0, dest // BS, torch.ones_like(dest))
    return torch.cat([blk.new_zeros(1), torch.cumsum(blk[:nb], 0)])


def run_kernel(bwt, insmap, start, n):
    """(out, rows): kernel A alone on a prepared insertion map and block
    prefix.  out is int8[alloc], exact up to n + start[-1]; rows is
    int32[nb * 32, 6], the symbol counts of every 128 output symbols
    (zero for CTAs wholly past the live prefix).  On CPU tensors it runs
    ``merge_blocks``, the kernel's plain version."""
    if bwt.device.type == "cpu":
        return merge_blocks(bwt, insmap, start, n)
    global LAUNCHES
    alloc = bwt.shape[0]
    nb = -(-alloc // BS)
    _check_kernel_args(bwt, insmap, start, n, nb)
    out = torch.empty_like(bwt)
    rows = torch.empty((nb * (BS // LANE), 6), dtype=torch.int32,
                       device=bwt.device)
    rc = _build.lib().rb2_merge(
        bwt.data_ptr(), insmap.data_ptr(), start.data_ptr(), n.data_ptr(),
        out.data_ptr(), rows.data_ptr(), alloc, nb,
        torch.cuda.current_stream(bwt.device).cuda_stream,
    )
    _build.check(rc, "rb2_merge")
    if not torch.cuda.is_current_stream_capturing():  # a capture launches none
        LAUNCHES += 1
    return out, rows


def tables(rows, alloc: int, K: int, dtype):
    """The K-block rank prefix (rank.prefix_rows) from the kernel's
    per-128-symbol rows."""
    cnt = rows[: alloc // LANE]
    if K != LANE:
        cnt = cnt.view(-1, K // LANE, 6).sum(dim=1, dtype=torch.int32)
    return prefix_rows(cnt, dtype)


def merge_blocks(old, insmap, start, n):
    """Kernel A's plain version at the kernel's own interface (see
    ``run_kernel``): output position p takes insmap[p] - 1 where that is
    not 0, else old[p - c(p)] (PAD past the allocation), with c(p) the
    insertions at or before p."""
    alloc = old.shape[0]
    nb = start.shape[0] - 1
    ins = insmap[: nb * BS].view(nb, BS)
    flag = ins != 0
    p = torch.arange(nb * BS, device=old.device).view(nb, BS)
    src = p - (torch.cumsum(flag, 1) + start[:nb, None])
    v = torch.where(src < alloc, old[src.clamp(0, alloc - 1)], PAD)
    out = torch.where(flag, ins - 1, v).view(-1)
    sym = out.view(-1, LANE)
    rows = torch.stack([(sym == s).sum(dim=1, dtype=torch.int32)
                        for s in range(6)], dim=1)
    live = (p[:, 0] < n + start[nb]).repeat_interleave(BS // LANE)
    return out[:alloc], torch.where(live[:, None], rows, 0)


def _check(bwt, pos, sym, stream, valid, n, K):
    if not bwt.is_cuda:
        raise ValueError(f"merge: unsupported device {bwt.device}")
    if bwt.dtype != torch.int8 or bwt.dim() != 1 or not bwt.is_contiguous():
        raise ValueError("merge: bwt must be a contiguous 1-D int8 tensor")
    if bwt.shape[0] % K or K % LANE:
        raise ValueError(f"merge: allocation {bwt.shape[0]} must be a "
                         f"multiple of K {K}, and K of {LANE}")
    check_lanes("merge", bwt.device, pos, sym, stream, valid, n)


def _check_kernel_args(bwt, insmap, start, n, nb):
    if not bwt.is_cuda:
        raise ValueError(f"run_kernel: unsupported device {bwt.device}")
    if (bwt.dtype != torch.int8 or bwt.dim() != 1 or not bwt.is_contiguous()
            or bwt.shape[0] % LANE):
        raise ValueError("run_kernel: bwt must be a contiguous 1-D int8 "
                         f"tensor whose size is a multiple of {LANE}")
    for name, t, dt, ok in (
        ("insmap", insmap, torch.int8, insmap.dim() == 1
         and insmap.shape[0] >= nb * BS),
        ("start", start, torch.int64, tuple(start.shape) == (nb + 1,)),
        ("n", n, torch.int64, n.dim() == 0),
    ):
        if (t.device != bwt.device or t.dtype != dt or not ok
                or not t.is_contiguous()):
            raise ValueError(f"run_kernel: bad {name} for {nb} CTAs")


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
