"""Flat, array-packed BWT state (counterpart of ropebwt2_tpu/index/flat.py).

The whole BWT lives in ONE int8 buffer of capacity ``cap``, the concatenation
of the six next-symbol partitions B_0..B_5 (mrope.h:10-14).  Alongside it:

* ``psize``      int64[6]    partition sizes (offsets = exclusive cumsum)
* ``pcounts``    int64[6,6]  per-partition per-symbol counts
* ``blk_prefix`` int[NB+1,6] per-symbol counts at every K-symbol block
                             boundary (int32 while cap < 2^31)
* ``n``          int64 0-dim total symbols

The buffer keeps the JAX package's PAD_TAIL symbols of tail slack, so a JAX
state converts 1:1 (convert.py).  Content beyond ``n`` is unspecified and
never read: every consumer bounds reads to pos <= n.
"""

import dataclasses

import numpy as np
import torch

from ..alphabet import NSYM

PAD = 6  # fill value for fresh capacity; outside the 6-symbol alphabet
PAD_TAIL = 2048  # tail slack symbols (same layout as the JAX state)


def resolve_device(device, who: str):
    """The device an index lives on: None means the card, and raises when
    there is none (pass device="cpu" for the plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: no CUDA device; pass device='cpu' to build on the "
                "CPU with the plain versions of the kernels")
        device = "cuda"
    return torch.device(device)


def table_dtype(cap: int):
    """blk_prefix dtype rule: int32 while every count fits."""
    return torch.int32 if cap < (1 << 31) else torch.int64


@dataclasses.dataclass
class FlatBwt:
    bwt: torch.Tensor  # int8[cap + PAD_TAIL]
    n: torch.Tensor  # int64 0-dim
    psize: torch.Tensor  # int64[6]
    pcounts: torch.Tensor  # int64[6, 6]
    blk_prefix: torch.Tensor  # int[(cap + PAD_TAIL) // K + 1, 6]

    @property
    def cap(self) -> int:
        return self.bwt.shape[0] - PAD_TAIL


def empty_state(cap: int, K: int, device) -> FlatBwt:
    if cap % K or PAD_TAIL % K:
        raise ValueError(f"cap {cap} and PAD_TAIL must be multiples of K {K}")
    return FlatBwt(
        bwt=torch.full((cap + PAD_TAIL,), PAD, dtype=torch.int8,
                       device=device),
        n=torch.zeros((), dtype=torch.int64, device=device),
        psize=torch.zeros(NSYM, dtype=torch.int64, device=device),
        pcounts=torch.zeros((NSYM, NSYM), dtype=torch.int64, device=device),
        blk_prefix=torch.zeros(
            ((cap + PAD_TAIL) // K + 1, NSYM), dtype=table_dtype(cap),
            device=device,
        ),
    )


def grow_state(state: FlatBwt, new_cap: int, K: int) -> FlatBwt:
    """Re-plan to a larger capacity (between batches).  The appended region
    is PAD, so the rank table extends by repeating its row at the old
    capacity boundary instead of recounting the buffer."""
    old_cap = state.cap
    if new_cap % K or new_cap < old_cap:
        raise ValueError(f"bad new capacity {new_cap} (cap {old_cap}, K {K})")
    if new_cap == old_cap:
        return state
    bwt = torch.cat([
        state.bwt[:old_cap],
        torch.full((new_cap + PAD_TAIL - old_cap,), PAD, dtype=torch.int8,
                   device=state.bwt.device),
    ])
    old_rows = old_cap // K + 1  # rows covering [0, old_cap]
    kept = state.blk_prefix[:old_rows].to(table_dtype(new_cap))
    extra = (new_cap + PAD_TAIL) // K + 1 - old_rows
    blk = torch.cat([kept, kept[-1:].expand(extra, NSYM)])
    return dataclasses.replace(state, bwt=bwt, blk_prefix=blk)


def state_from_partition_runs(partition_runs, K: int, cap: int = None,
                              device=None) -> FlatBwt:
    """Build the state from six per-partition run lists [(symbol, length),
    ...] (the FMR restore path, -i), on ``device`` (None: the card)."""
    from .rank import build_block_tables

    device = resolve_device(device, "state_from_partition_runs")
    parts = []
    psize = np.zeros(NSYM, dtype=np.int64)
    pcounts = np.zeros((NSYM, NSYM), dtype=np.int64)
    for b in range(NSYM):
        runs = np.asarray(partition_runs[b], dtype=np.int64).reshape(-1, 2)
        parts.append(np.repeat(runs[:, 0].astype(np.int8), runs[:, 1]))
        psize[b] = parts[-1].shape[0]
        np.add.at(pcounts[b], runs[:, 0], runs[:, 1])
    flat = np.concatenate(parts)
    n = flat.shape[0]
    if cap is None:
        cap = max(K, -(-n // K) * K)
    if cap % K or cap < n:
        raise ValueError(f"capacity {cap} does not hold {n} symbols in "
                         f"blocks of {K}")
    buf = np.full(cap + PAD_TAIL, PAD, dtype=np.int8)
    buf[:n] = flat
    bwt = torch.from_numpy(buf).to(device)
    return FlatBwt(
        bwt=bwt,
        n=torch.tensor(n, dtype=torch.int64, device=device),
        psize=torch.from_numpy(psize).to(device),
        pcounts=torch.from_numpy(pcounts).to(device),
        blk_prefix=build_block_tables(bwt, K, dtype=table_dtype(cap)),
    )
