"""Carry an index across from the JAX package: its state, as numpy arrays,
becomes the port's state on a chosen device.  The layouts match (the flat
buffer keeps its PAD_TAIL slack, the packed one its vertical plane pairs
and two-level tables, the run tier its slots, block tables and sentinel,
a sharded index its windows and global-valued tables, one row a rank), so
the conversion copies the arrays and widens what the port keeps in
int64."""

import numpy as np
import torch

from .index.flat import PAD, PAD_TAIL, FlatBwt, table_dtype
from .index.packed import LANE, PPAD_ROWS, PackedFlatBwt
from .index.pending import INF, PendingIndex
from .index.runs import KR, RunBwt


def flat_from_numpy(bwt, n, psize, pcounts, blk_prefix, device) -> FlatBwt:
    """FlatBwt from the fields of the JAX package's FlatBwt: bwt
    int8[cap + PAD_TAIL], n, psize int[6], pcounts int[6, 6] and the rank
    table blk_prefix int[(cap + PAD_TAIL) // K + 1, 6]."""
    bwt = np.asarray(bwt, dtype=np.int8)
    cap = bwt.shape[0] - PAD_TAIL
    if cap <= 0:
        raise ValueError(f"buffer of {bwt.shape[0]} symbols has no capacity")

    return FlatBwt(
        bwt=_tensor(bwt, np.int8, device),
        n=_tensor(n, np.int64, device),
        psize=_tensor(psize, np.int64, device),
        pcounts=_tensor(pcounts, np.int64, device),
        blk_prefix=_tensor(blk_prefix, np.int64, device).to(table_dtype(cap)),
    )


def packed_from_numpy(pbwt, n, psize, pcounts, blkA, blkB,
                      device) -> PackedFlatBwt:
    """PackedFlatBwt from the fields of the JAX package's PackedFlatBwt:
    pbwt uint8[cap // 2 + PPAD_ROWS * 128], n, psize int[6], pcounts
    int[6, 6] and the two-level tables blkA int64[ceil(cap / 2^24) + 1, 6]
    and blkB int32[2 * (cap // 256) + 2, 6]."""
    pbwt = np.asarray(pbwt, dtype=np.uint8)
    cap = (pbwt.shape[0] - PPAD_ROWS * LANE) * 2
    if cap <= 0 or cap % 256:
        raise ValueError(f"packed buffer of {pbwt.shape[0]} bytes has no "
                         "capacity that is a multiple of 256")
    return PackedFlatBwt(
        pbwt=_tensor(pbwt, np.uint8, device),
        n=_tensor(n, np.int64, device),
        psize=_tensor(psize, np.int64, device),
        pcounts=_tensor(pcounts, np.int64, device),
        blkA=_tensor(blkA, np.int64, device),
        blkB=_tensor(blkB, np.int32, device),
    )


def runs_from_numpy(rsym, rend, bstart, bocc, nslot, n, psize, pcounts,
                    overflow, device) -> RunBwt:
    """RunBwt from the fields of the JAX package's RunBwt: rsym int8[rcap],
    rend int32[rcap], bstart and bocc in its table dtype (int32 or int64,
    kept), nslot, n, psize int[6], pcounts int[6, 6] and overflow."""
    rsym = np.asarray(rsym, dtype=np.int8)
    bstart = np.asarray(bstart)
    if rsym.shape[0] % KR or bstart.shape[0] * KR != rsym.shape[0]:
        raise ValueError(f"{rsym.shape[0]} slots do not make "
                         f"{bstart.shape[0]} blocks of {KR}")
    return RunBwt(
        rsym=_tensor(rsym, np.int8, device),
        rend=_tensor(rend, np.int32, device),
        bstart=_tensor(bstart, bstart.dtype, device),
        bocc=_tensor(bocc, bstart.dtype, device),
        nslot=_tensor(nslot, np.int64, device),
        n=_tensor(n, np.int64, device),
        psize=_tensor(psize, np.int64, device),
        pcounts=_tensor(pcounts, np.int64, device),
        overflow=_tensor(overflow, np.int32, device),
    )


def pending_from_numpy(vp, psym, blk_prefix, p, device) -> PendingIndex:
    """PendingIndex from the fields of the JAX package's PendingIndex.  Its
    vp may be int32, with the int32 sentinel on empty rows: rows at or past
    p take the port's int64 sentinel."""
    vp = np.array(vp, dtype=np.int64)
    vp[int(p):] = INF
    return PendingIndex(
        vp=_tensor(vp, np.int64, device),
        psym=_tensor(psym, np.int8, device),
        blk_prefix=_tensor(blk_prefix, np.int32, device),
        p=_tensor(p, np.int64, device),
    )


def sharded_from_numpy(bwt, blk_prefix, n, psize, pcounts, rank,
                       device):
    """Rank ``rank``'s ShardedBwt from the fields of the JAX package's
    ShardedBwt: its row of bwt int8[D, lcap] (PAD_TAIL of PAD appended)
    and of blk_prefix int[D, lcap // K + 1, 6] (global values), and the
    replicated n, psize int[6] and pcounts int[6, 6]."""
    from .parallel.sharded import ShardedBwt

    bwt = np.asarray(bwt, dtype=np.int8)
    d, lcap = bwt.shape
    window = np.full(lcap + PAD_TAIL, PAD, dtype=np.int8)
    window[:lcap] = bwt[rank]
    return ShardedBwt(
        bwt=_tensor(window, np.int8, device),
        blk_prefix=_tensor(np.asarray(blk_prefix)[rank], np.int64,
                           device).to(table_dtype(lcap * d)),
        n=_tensor(n, np.int64, device),
        psize=_tensor(psize, np.int64, device),
        pcounts=_tensor(pcounts, np.int64, device),
    )


def _tensor(x, dtype, device):
    """A copy of x (array or scalar) as a tensor of numpy dtype on device."""
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)
