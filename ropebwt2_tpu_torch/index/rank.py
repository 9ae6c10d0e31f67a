"""Blockwise rank (occ) over the flat BWT buffer (counterpart of
ropebwt2_tpu/index/rank.py): a dense per-block prefix-count table plus an
in-block count, the batched equivalent of rope_rank2a (rope.c:179-194).
Plain torch on either device; none of these functions is a kernel."""

import torch

from ..alphabet import NSYM


def block_counts(x, K: int):
    """int32[len(x)//K, 6]: per-symbol counts of every K-symbol block."""
    nb = x.shape[0] // K
    blocks = x[: nb * K].view(nb, K)
    return torch.stack(
        [(blocks == s).sum(dim=1, dtype=torch.int32) for s in range(NSYM)],
        dim=1,
    )


def prefix_rows(cnts, dtype):
    """dtype[rows + 1, S]: the running sum over the rows of a (rows, S)
    count table, with a zero row in front.  The sum runs along the last
    dimension of the transposed table: PyTorch's CUDA scan along the first
    dimension of a narrow table walks each column in one thread."""
    t = torch.cumsum(cnts.t().contiguous(), dim=1, dtype=dtype)
    zero = torch.zeros((t.shape[0], 1), dtype=dtype, device=cnts.device)
    return torch.cat([zero, t], dim=1).t().contiguous()


def scan_rows(op, x):
    """op (torch.cumsum / cummax / cummin) down the rows of an (M, S)
    table, run along the last dimension of its transpose: PyTorch's CUDA
    scan along the first dimension of a narrow table walks each column in
    one thread."""
    y = op(x.t().contiguous(), dim=1)
    return (y if isinstance(y, torch.Tensor) else y.values).t()


def build_block_tables(bwt, K: int, dtype=torch.int64):
    """Per-symbol prefix counts at every K-block boundary.

    bwt: int8[ALLOC] (content past the live prefix is unspecified; rows
    past it are garbage and never consumed).  Returns dtype[ALLOC//K+1, 6]."""
    return prefix_rows(block_counts(bwt, K), dtype)


def rank_global(bwt, blk_prefix, pos, K: int):
    """Batched 6-symbol rank at global positions.

    pos: int64[Q] with 0 <= pos <= n.  Returns out[q, s] = |{ i < pos[q] :
    bwt[i] == s }| in blk_prefix's dtype.  Positions out of range (inert
    rows of a round) are clamped, never faulted, and their rows are
    meaningless."""
    blk = torch.div(pos, K, rounding_mode="floor")
    within = pos - blk * K
    base = blk_prefix[blk.clamp(0, blk_prefix.shape[0] - 1)]  # (Q, 6)
    rows = bwt.view(-1, K)[blk.clamp(0, bwt.shape[0] // K - 1)]  # (Q, K)
    j = torch.arange(K, device=bwt.device)
    inmask = j[None, :] < within[:, None]
    sym = torch.arange(NSYM, dtype=bwt.dtype, device=bwt.device)
    eq = (rows[:, :, None] == sym[None, None, :]) & inmask[:, :, None]
    return base + eq.sum(dim=1, dtype=blk_prefix.dtype)
