"""Blockwise rank (occ) over the flat BWT buffer (counterpart of
ropebwt2_tpu/index/rank.py): a dense per-block prefix-count table plus an
in-block count, the batched equivalent of rope_rank2a (rope.c:179-194);
and the running sums and flagged-row lookups that the build's plans take
down their rows, as one-dimensional scans and gathers.  Plain torch on
either device; none of these functions is a kernel."""

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
    count table, with a zero row in front.  The columns, each behind a zero,
    are laid end to end and summed in one 1-D cumsum (PyTorch's CUDA scan
    of a 1-D tensor is one device-wide scan; a scan down a narrow table
    walks each column in one thread block), and each column's start is
    subtracted in dtype.  The whole table's sum must fit dtype."""
    rows, ncol = cnts.shape
    x = torch.empty((ncol, rows + 1), dtype=dtype, device=cnts.device)
    x[:, 0] = 0
    x[:, 1:] = cnts.t()
    t = torch.cumsum(x.view(-1), 0, dtype=dtype).view(ncol, rows + 1)
    out = torch.empty((rows + 1, ncol), dtype=dtype, device=cnts.device)
    return torch.sub(t.t(), t[:, 0], out=out)


def flagged_rows(flag, after=False, none=-1):
    """For each row m of a bool[M] flag vector, the last row at or before m
    whose flag is set (the first at or after m when ``after``), ``none``
    where there is no such row.  One 1-D cumsum numbers the flagged rows,
    a scatter puts each flagged row at its number (the other rows go to a
    spare slot), and a gather reads, at each row, the row stored at the
    number of the last flagged row at or before it (of the next one)."""
    m = flag.shape[0]
    k = torch.cumsum(flag, 0)  # from 1 (inclusive count)
    if after:
        k = k.add(flag, alpha=-1)  # from 0 (exclusive; a bool takes no -)
    pos = torch.full((m + 2,), none, dtype=torch.int64, device=flag.device)
    pos.index_put_((torch.where(flag, k, m + 1),),
                   torch.arange(m, device=flag.device))
    return pos[k]


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
