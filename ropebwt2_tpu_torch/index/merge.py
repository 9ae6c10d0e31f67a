"""Coalesced batched insertion into the flat BWT buffer (counterpart of
ropebwt2_tpu/index/merge.py) — the plain PyTorch version of the merge
kernel (merge_cuda.py).

Contract: insertions are given per string as (pos, sym, stream) where
``pos`` is the insertion point in OLD (start-of-round) coordinates and
``stream`` the tie-break rank among this round's insertions (consistent with
non-decreasing pos).  Insertion i lands at pos[i] + stream[i]; old element j
moves to j + |{i : pos[i] <= j}|.
"""

import torch

from .flat import PAD


def apply_insertions(bwt, n, pos, sym, stream, valid):
    """Return the new flat buffer with all valid insertions applied.

    bwt: int8[CAP] (content past n unspecified); pos/stream: int[M];
    sym: int[M]; valid: bool[M].  ``n`` is unused (the whole buffer moves)
    and kept for the kernel wrapper's signature.  Masked lanes and
    elements shifted past CAP scatter into one trash slot at index CAP,
    which is sliced off (the torch form of JAX's mode="drop")."""
    del n
    cap = bwt.shape[0]
    dev = bwt.device
    pos = pos.long()
    trash = torch.full_like(pos, cap)
    mark = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    mark.index_add_(0, torch.where(valid, pos, trash),
                    torch.ones_like(pos))
    shift = torch.cumsum(mark[:cap], dim=0)
    dest_old = torch.arange(cap, device=dev) + shift
    dest_old = torch.where(dest_old < cap, dest_old, cap)
    new = torch.full((cap + 1,), PAD, dtype=bwt.dtype, device=dev)
    new.scatter_(0, dest_old, bwt)
    ins_dest = torch.where(valid, pos + stream.long(), trash)
    new.scatter_(0, ins_dest, sym.to(bwt.dtype))
    return new[:cap]
