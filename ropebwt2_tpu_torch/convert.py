"""Carry an index across from the JAX package: its state, as numpy arrays,
becomes the port's state on a chosen device.  The layouts match (the flat
buffer keeps its PAD_TAIL slack), so the conversion copies the arrays and
widens what the port keeps in int64."""

import numpy as np
import torch

from .index.flat import PAD_TAIL, FlatBwt, table_dtype
from .index.pending import INF, PendingIndex


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


def _tensor(x, dtype, device):
    """A copy of x (array or scalar) as a tensor of numpy dtype on device."""
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)
