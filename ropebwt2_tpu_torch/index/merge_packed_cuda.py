"""Kernel C: the packed-BWT merge (csrc/merge_packed.cu), which replaces
the JAX package's Pallas kernel
ropebwt2_tpu/index/merge_pallas_packed.py::merge_pallas_packed.

``merge_packed`` applies one round's (or one pending flush's) insertions
to the 4-bit packed buffer and returns it with its two-level rank tables.
On CPU tensors it runs the plain version (packed.apply_insertions_packed +
packed.build_two_level_tables); on CUDA tensors it launches the kernel, or
raises."""

import torch

from .. import _build
from ..utils import launches, trace
from .merge_cuda import BS, check_lanes
from .packed import (
    LANE, PPAD_ROWS, apply_insertions_packed, build_two_level_tables,
    tables_from_plane_counts,
)

LAUNCHES = 0  # kernel launches by this process (utils/launches.py)


def merge_packed(pbwt, pos, sym, stream, valid, n, K: int = LANE):
    """(new_pbwt, blkA, blkB) after inserting sym[i] at pos[i] + stream[i]
    for every valid i (merge.py's contract, on packed.py's layout).

    pbwt: uint8[cap // 2 + PPAD_ROWS * 128] with cap % 256 == 0;
    pos/stream: int64[M]; sym: int64[M]; valid: bool[M]; n: int64 0-dim
    live size.  Content past n + #insertions is unspecified on return, and
    so are the table rows past it; the rows at or below it are exact."""
    cap = (pbwt.shape[0] - PPAD_ROWS * LANE) * 2
    if K != LANE or cap <= 0 or cap % 256:
        raise ValueError(f"merge_packed: needs K = {LANE} (got {K}) and a "
                         f"capacity that is a multiple of 256 (got {cap})")
    if pbwt.device.type == "cpu":
        with trace.span("merge.kernel"):
            new = apply_insertions_packed(pbwt, n, pos, sym, stream, valid)
        with trace.span("merge.tables"):
            return (new, *build_two_level_tables(new, cap))
    _check(pbwt, pos, sym, stream, valid, n)
    nb = -(-2 * pbwt.shape[0] // BS)
    with trace.span("merge.insertion_map"):
        insmap, start = insertion_map(pos, sym, stream, valid, nb)
    with trace.span("merge.kernel"):
        out, rows = run_kernel(pbwt, insmap, start, n)
    with trace.span("merge.tables"):
        planes = rows[: cap // LANE].view(-1, 2, 6)  # symbol rows 2r, 2r + 1
        return (out, *tables_from_plane_counts(planes[:, 0], planes[:, 1],
                                               cap))


def insertion_map(pos, sym, stream, valid, nb: int):
    """(insmap, start) for ``nb`` CTAs: the packed insertion map
    uint8[nb * 2048], nibble sym + 1 at plane (dest >> 7) & 1 of byte
    (dest >> 8) * 128 + (dest & 127) for every destination dest = pos +
    stream, and the exclusive per-CTA insertion prefix int64[nb + 1].

    Two destinations share a byte only through different planes, so an ADD
    scatter is exact where a set would drop a nibble.  Masked lanes add 0
    at a byte of their own (their lane index): a uint8 add is a
    compare-and-swap loop, and millions of masked lanes on one trash byte
    (a flush's empty pending rows) serialise on it for seconds."""
    dev = pos.device
    dest = pos + stream
    lane = torch.arange(dest.shape[0], device=dev)
    byte = torch.where(valid, (dest >> 8) * LANE + (dest & (LANE - 1)),
                       lane % (nb * (BS // 2)))
    nibble = torch.where(valid, (sym + 1) << (((dest >> 7) & 1) * 4), 0)
    insmap = torch.zeros(nb * (BS // 2), dtype=torch.uint8, device=dev)
    insmap.index_add_(0, byte, nibble.to(torch.uint8))
    # exclusive per-CTA insertion prefix, from the M insertions (not cap)
    blk = torch.zeros(nb, dtype=torch.int64, device=dev)
    blk.index_add_(0, torch.where(valid, dest // BS, lane % nb),
                   valid.long())
    return insmap, torch.cat([blk.new_zeros(1), torch.cumsum(blk, 0)])


def run_kernel(pbwt, insmap, start, n):
    """(out, rows): kernel C alone on a prepared packed insertion map
    (uint8[nb * 2048]) and block prefix (int64[nb + 1]), the arguments
    ``merge_packed`` makes.  out is uint8[alloc], exact up to n +
    start[-1]; rows is int32[nb * 32, 6], the symbol counts of every 128
    output symbols (zero for CTAs wholly past the live prefix)."""
    if not pbwt.is_cuda:
        raise ValueError(f"merge_packed: unsupported device {pbwt.device}")
    alloc = pbwt.shape[0]
    nb = -(-2 * alloc // BS)
    out = torch.empty_like(pbwt)
    rows = torch.empty((nb * (BS // LANE), 6), dtype=torch.int32,
                       device=pbwt.device)
    if pbwt.data_ptr() % 16 or insmap.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("merge_packed: the packed buffers must be 16-byte "
                         "aligned")
    rc = _build.lib().rb2_merge_packed(
        pbwt.data_ptr(), insmap.data_ptr(), start.data_ptr(), n.data_ptr(),
        out.data_ptr(), rows.data_ptr(), alloc, nb,
        torch.cuda.current_stream(pbwt.device).cuda_stream,
    )
    _build.check(rc, "rb2_merge_packed")
    launches.launched(globals())
    return out, rows


def _check(pbwt, pos, sym, stream, valid, n):
    if not pbwt.is_cuda:
        raise ValueError(f"merge_packed: unsupported device {pbwt.device}")
    if (pbwt.dtype != torch.uint8 or pbwt.dim() != 1
            or not pbwt.is_contiguous()):
        raise ValueError("merge_packed: pbwt must be a contiguous 1-D uint8 "
                         "tensor")
    check_lanes("merge_packed", pbwt.device, pos, sym, stream, valid, n)
