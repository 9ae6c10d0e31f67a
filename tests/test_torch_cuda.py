"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the port's build on the card against its build on the CPU.

These tests need an NVIDIA GPU and skip without one.  They import neither
JAX nor the test helpers in conftest.py, so they also run where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every comparison is exact (integers): the live prefix and its table rows
for the merge, every row for the pending merge."""

import numpy as np
import pytest
import torch

from ropebwt2_tpu_torch.engine import TorchBwt
from ropebwt2_tpu_torch.index import merge_cuda, pending_cuda
from ropebwt2_tpu_torch.index.flat import PAD_TAIL, table_dtype
from ropebwt2_tpu_torch.index.merge import apply_insertions
from ropebwt2_tpu_torch.index.pending import (
    INF, KP, PendingIndex, merge_rows, new_rows,
)
from ropebwt2_tpu_torch.index.rank import build_block_tables

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("K,case", [(128, "random"), (256, "random"),
                                    (128, "dense"), (128, "empty"),
                                    (128, "small_cap")])
def test_merge_kernel_matches_plain(dev, K, case):
    rng = np.random.default_rng(K + len(case))
    cap, m = (1 << 20, 4096) if case != "small_cap" else (128, 16)
    n = cap - m - (7 if case != "small_cap" else 0)
    buf = rng.integers(-128, 128, cap + PAD_TAIL).astype(np.int8)
    buf[:n] = rng.integers(0, 6, n)
    a = {"empty": 0, "dense": m - 10}.get(case, m)
    pos = np.zeros(m, np.int64)
    pos[:a] = np.sort(rng.integers(0, n + 1, a))
    if case == "dense":
        pos[: a // 2] = n // 2
        pos[:a] = np.sort(pos[:a])
    stream = np.where(np.arange(m) < a, np.arange(m), 0)
    bwt, pos, sym, stream, valid, nt = [torch.from_numpy(x).to(dev) for x in (
        buf, pos, rng.integers(0, 6, m), stream, np.arange(m) < a,
        np.asarray(n))]
    launches = merge_cuda.LAUNCHES
    got, got_blk = merge_cuda.merge(bwt, pos, sym, stream, valid, nt, K)
    torch.cuda.synchronize()
    assert merge_cuda.LAUNCHES == launches + 1
    want = apply_insertions(bwt, nt, pos, sym, stream, valid)
    want_blk = build_block_tables(want, K, dtype=table_dtype(cap))
    live = n + a
    assert torch.equal(got[:live], want[:live])
    assert got_blk.dtype == want_blk.dtype
    assert torch.equal(got_blk[: live // K + 1], want_blk[: live // K + 1])


@pytest.mark.parametrize("frac", [0.0, 0.3, 0.9])
def test_pending_kernel_matches_plain(dev, frac):
    rng = np.random.default_rng(int(frac * 10))
    pcap, m, nmax = 1 << 16, 1 << 13, 1 << 26
    pfill = int(pcap * frac)
    vp = np.full(pcap, INF, np.int64)
    vp[:pfill] = np.sort(rng.integers(0, nmax - pfill, pfill)) \
        + np.arange(pfill)
    psym = np.full(pcap, 6, np.int8)
    psym[:pfill] = rng.integers(0, 6, pfill)
    ps = torch.from_numpy(psym).to(dev)
    pend = PendingIndex(
        vp=torch.from_numpy(vp).to(dev), psym=ps,
        blk_prefix=build_block_tables(ps, KP, dtype=torch.int32),
        p=torch.tensor(pfill, device=dev))
    a = min(m, pcap - pfill)
    gX = np.sort(rng.integers(0, nmax, m))
    stream = np.where(np.arange(m) < a, np.arange(m), 0)
    row = [torch.from_numpy(x).to(dev) for x in (
        gX, rng.integers(0, 6, m), stream, np.arange(m) < a)]
    args = (pend.vp, pend.psym, *new_rows(pend, *row))
    launches = pending_cuda.LAUNCHES
    got = pending_cuda.merge(*args)
    torch.cuda.synchronize()
    assert pending_cuda.LAUNCHES == launches + 1
    for g, w in zip(got, merge_rows(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("so", [0, 1, 2])
@pytest.mark.parametrize("defer_r", [0, 4])
def test_build_on_the_card_matches_the_cpu(dev, so, defer_r):
    rng = np.random.default_rng(so + 3 * defer_r)
    batches = [[rng.integers(1, 6, int(k)).astype(np.int8)
                for k in rng.integers(1, 60, 300)] for _ in range(2)]
    batches.append(rng.integers(1, 5, (200, 101)).astype(np.int8))
    engines = [TorchBwt(so=so, defer_r=defer_r, device=d)
               for d in (dev, "cpu")]
    merges, pendings = merge_cuda.LAUNCHES, pending_cuda.LAUNCHES
    for eng in engines:
        for b in batches:
            eng.insert_multi(b)
    assert merge_cuda.LAUNCHES > merges
    assert (pending_cuda.LAUNCHES > pendings) == (defer_r > 0)
    assert np.array_equal(engines[0].bwt_array(), engines[1].bwt_array())
    assert np.array_equal(engines[0].counts(), engines[1].counts())
