"""Kernel A: the flat-BWT merge (csrc/merge.cu), which replaces the JAX
package's Pallas kernel ropebwt2_tpu/index/merge_pallas.py::merge_pallas.

``merge`` applies one round's (or one pending flush's) insertions and
returns the new buffer with its K-block rank prefix.  On CPU tensors it
runs the plain version (merge.apply_insertions + rank.build_block_tables);
on CUDA tensors it launches the kernel, or raises.

On the card ``merge`` is four steps, each a function of its own so that
the probe suite (probes/merge_phases.py) times the same code the build
runs: ``insertion_map`` (zero-fill and scatter), ``block_prefix`` (per-CTA
insertion prefix), ``run_kernel`` (kernel A alone: the new buffer and its
128-symbol rank prefix in one pass) and ``tables`` (the K-block rows of
that prefix: a slice, no sum)."""

import torch

from .. import _build
from ..utils import launches, trace
from .flat import PAD, PAD_TAIL, table_dtype
from .merge import apply_insertions
from .rank import build_block_tables, prefix_rows

BS = 4096  # output symbols per CTA (csrc/common.cuh)
LANE = 128  # symbols per count row
ROWS = BS // LANE  # count rows per CTA
LAUNCHES = 0  # kernel launches by this process (utils/launches.py)


def merge(bwt, pos, sym, stream, valid, n, K: int):
    """(new_bwt, blk_prefix) after inserting sym[i] at pos[i] + stream[i]
    for every valid i (flat.py's buffer layout, merge.py's contract).

    bwt: int8[alloc] with alloc = cap + PAD_TAIL; pos/stream: int64[M];
    sym: int64[M]; valid: bool[M]; n: int64 0-dim live size.  Content past
    n + #insertions is unspecified on return, and so are the table rows
    past it; the rows at or below it are exact."""
    cap_tdt = table_dtype(bwt.shape[0] - PAD_TAIL)
    if bwt.device.type == "cpu":
        with trace.span("merge.kernel"):
            new = apply_insertions(bwt, n, pos, sym, stream, valid)
        with trace.span("merge.tables"):
            return new, build_block_tables(new, K, dtype=cap_tdt)
    _check(bwt, pos, sym, stream, valid, n, K)
    nb = -(-bwt.shape[0] // BS)
    with trace.span("merge.insertion_map"):
        dest, insmap = insertion_map(pos, sym, stream, valid, nb)
    with trace.span("merge.block_prefix"):
        start = block_prefix(dest, nb)
    with trace.span("merge.kernel"):
        out, prefix = run_kernel(bwt, insmap, start, n, cap_tdt)
    with trace.span("merge.tables"):
        return out, tables(prefix, bwt.shape[0], K)


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


def run_kernel(bwt, insmap, start, n, dtype, tile=None):
    """(out, prefix): kernel A alone on a prepared insertion map and block
    prefix.  out is int8[alloc], exact up to L = n + start[-1]; prefix is
    dtype[nb * 32 + 1, 6], the count of each symbol in out[0, 128 r) at
    row r, exact in rows 0 .. L // 128 and unspecified past them.
    ``tile``: the 4096-symbol blocks a CTA takes, 1 to 8 (tile_blocks(nb)
    by default; the probes time the others).  On CPU tensors it runs
    ``merge_blocks``, the kernel's plain version."""
    if bwt.device.type == "cpu":
        return merge_blocks(bwt, insmap, start, n, dtype)
    alloc = bwt.shape[0]
    nb = -(-alloc // BS)
    _check_kernel_args(bwt, insmap, start, n, nb, dtype)
    g = tile or tile_blocks(nb)
    out = torch.empty_like(bwt)
    prefix = torch.empty((nb * ROWS + 1, 6), dtype=dtype, device=bwt.device)
    # the look-back's status words (6 a tile) and the ticket counter,
    # zeroed on the launch's stream (a CUDA graph records the reset with
    # the launch)
    scratch = torch.zeros(6 * -(-nb // g) + 1, dtype=torch.int64,
                          device=bwt.device)
    rc = _build.lib().rb2_merge(
        bwt.data_ptr(), insmap.data_ptr(), start.data_ptr(), n.data_ptr(),
        out.data_ptr(), prefix.data_ptr(), scratch.data_ptr(), alloc, nb, g,
        int(dtype == torch.int64),
        torch.cuda.current_stream(bwt.device).cuda_stream,
    )
    _build.check(rc, "rb2_merge")
    launches.launched(globals())
    return out, prefix


def tile_blocks(nb: int) -> int:
    """The 4096-symbol blocks of one CTA of kernel A (a tile of its
    look-back), from the allocation's nb blocks: the look-back costs a
    step a tile, so a large allocation takes 8 blocks a CTA; a small one
    takes fewer, so that its live blocks still spread over the SMs."""
    return 2 if nb <= 2048 else 4 if nb <= 8192 else 8


def tables(prefix, alloc: int, K: int):
    """The K-block rank prefix, dtype[alloc // K + 1, 6]: the rows of the
    kernel's 128-symbol prefix at multiples of K (no sum, no scan)."""
    return prefix[: alloc // LANE + 1: K // LANE].contiguous()


def merge_blocks(old, insmap, start, n, dtype):
    """Kernel A's plain version at the kernel's own interface (see
    ``run_kernel``): output position p takes insmap[p] - 1 where that is
    not 0, else old[p - c(p)] (PAD past the allocation), with c(p) the
    insertions at or before p; the prefix counts every 128 output symbols
    of all nb * 4096, whatever lies past the live end."""
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
    return out[:alloc], prefix_rows(rows, dtype)


def _check(bwt, pos, sym, stream, valid, n, K):
    if not bwt.is_cuda:
        raise ValueError(f"merge: unsupported device {bwt.device}")
    if bwt.dtype != torch.int8 or bwt.dim() != 1 or not bwt.is_contiguous():
        raise ValueError("merge: bwt must be a contiguous 1-D int8 tensor")
    if bwt.shape[0] % K or K % LANE:
        raise ValueError(f"merge: allocation {bwt.shape[0]} must be a "
                         f"multiple of K {K}, and K of {LANE}")
    check_lanes("merge", bwt.device, pos, sym, stream, valid, n)


def _check_kernel_args(bwt, insmap, start, n, nb, dtype):
    if not bwt.is_cuda:
        raise ValueError(f"run_kernel: unsupported device {bwt.device}")
    if (bwt.dtype != torch.int8 or bwt.dim() != 1 or not bwt.is_contiguous()
            or bwt.shape[0] % LANE or bwt.data_ptr() % 16):
        raise ValueError("run_kernel: bwt must be a contiguous, 16-byte "
                         "aligned 1-D int8 tensor whose size is a multiple "
                         f"of {LANE}")
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"run_kernel: prefix dtype {dtype} is not int32 or "
                         "int64")
    for name, t, dt, ok in (
        ("insmap", insmap, torch.int8, insmap.dim() == 1
         and insmap.shape[0] >= nb * BS and insmap.data_ptr() % 16 == 0),
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
