"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the port's build on the card against its build on the CPU.

These tests need an NVIDIA GPU and skip without one.  The last ones hold
the probe suite's kernels (ropebwt2_tpu_torch/probes) against their plain
versions.  They import neither
JAX nor the test helpers in conftest.py, so they also run where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every comparison is exact (integers): the live prefix and its table rows
for the flat and the packed merge, every row for the pending merge."""

import numpy as np
import pytest
import torch

from ropebwt2_tpu_torch.engine import TorchBwt
from ropebwt2_tpu_torch.index import merge_cuda, merge_packed_cuda, \
    pending_cuda
from ropebwt2_tpu_torch.index.flat import PAD_TAIL, table_dtype
from ropebwt2_tpu_torch.index.merge import apply_insertions
from ropebwt2_tpu_torch.index.packed import (
    LANE, PPAD_ROWS, apply_insertions_packed, blkb_row,
    build_two_level_tables, pack_bwt_np, unpack_bwt,
)
from ropebwt2_tpu_torch.index.pending import (
    INF, KP, PendingIndex, merge_rows, new_rows,
)
from ropebwt2_tpu_torch.index.rank import build_block_tables
from ropebwt2_tpu_torch.probes import (
    _timing, kernel_features, kernel_stages, merge_phases, warmup_build,
)

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


def _absolute(blkA, blkB, cap, nblk):
    """int64 per-symbol prefix at symbol rows 0..nblk-1 of two-level
    tables: anchor + anchor-relative row."""
    blks = torch.arange(nblk, device=blkA.device)
    return blkA[(blks * LANE) >> 24] + blkB[blkb_row(blks, cap // 256)]


@pytest.mark.parametrize("case", ["random", "dense", "garbage", "masked"])
def test_merge_packed_kernel_matches_plain(dev, case):
    """Kernel C against apply_insertions_packed + build_two_level_tables;
    the garbage case also has a capacity that is not a multiple of the
    CTA's 4096 symbols, so its last CTA is ragged, and the masked case
    leaves three lanes in four inactive, as a flush of a part-filled
    pending set does."""
    rng = np.random.default_rng(50 + len(case))
    cap, m = (1 << 20) + (768 if case == "garbage" else 0), 4096
    n = cap - m - 7
    syms = np.full(cap + 2 * LANE * PPAD_ROWS, 6, np.int8)
    syms[:n] = rng.integers(0, 6, n)
    if case == "garbage":
        syms[n:] = rng.integers(0, 16, syms.shape[0] - n)
    a = {"dense": m - 10, "masked": m // 4}.get(case, m)
    pos = np.zeros(m, np.int64)
    pos[:a] = np.sort(rng.integers(0, n + 1, a))
    if case == "dense":
        pos[: a // 2] = n // 2
        pos[:a] = np.sort(pos[:a])
    stream = np.where(np.arange(m) < a, np.arange(m), 0)
    pb, pos, sym, stream, valid, nt = [torch.from_numpy(x).to(dev) for x in (
        pack_bwt_np(syms), pos, rng.integers(0, 6, m), stream,
        np.arange(m) < a, np.asarray(n))]
    launches = merge_packed_cuda.LAUNCHES
    got, gA, gB = merge_packed_cuda.merge_packed(pb, pos, sym, stream, valid,
                                                 nt, 128)
    torch.cuda.synchronize()
    assert merge_packed_cuda.LAUNCHES == launches + 1
    want = apply_insertions_packed(pb, nt, pos, sym, stream, valid)
    wA, wB = build_two_level_tables(want, cap)
    live = n + a
    assert got.shape == want.shape
    assert gA.dtype == wA.dtype and gB.dtype == wB.dtype
    assert torch.equal(unpack_bwt(got)[:live], unpack_bwt(want)[:live])
    nblk = live // LANE + 1
    assert torch.equal(_absolute(gA, gB, cap, nblk),
                       _absolute(wA, wB, cap, nblk))


@pytest.mark.parametrize("defer_r", [0, 4])
def test_packed_build_on_the_card_matches_the_cpu(dev, defer_r):
    rng = np.random.default_rng(60 + defer_r)
    batches = [[rng.integers(1, 6, int(k)).astype(np.int8)
                for k in rng.integers(1, 60, 300)] for _ in range(2)]
    engines = [TorchBwt(so=1, defer_r=defer_r, device=d, pack4=1)
               for d in (dev, "cpu")]
    packs, pendings = merge_packed_cuda.LAUNCHES, pending_cuda.LAUNCHES
    for eng in engines:
        for b in batches:
            eng.insert_multi(b)
    assert merge_packed_cuda.LAUNCHES > packs
    assert (pending_cuda.LAUNCHES > pendings) == (defer_r > 0)
    assert np.array_equal(engines[0].bwt_array(), engines[1].bwt_array())
    assert np.array_equal(engines[0].counts(), engines[1].counts())


@pytest.mark.parametrize("stage", kernel_stages.STAGES)
def test_stage_kernel_matches_plain(dev, stage):
    """One of kernel A's stages looped (csrc/probes/stages.cu): its last
    pass against the plain version, on 64 CTAs and on one."""
    for g in (64, 1):
        d = kernel_stages.make_inputs(g, 20 + g, dev)
        launches = kernel_stages.LAUNCHES[stage]
        got = kernel_stages.run_stage(stage, d, iters=50)
        torch.cuda.synchronize()
        assert kernel_stages.LAUNCHES[stage] == launches + 1
        assert torch.equal(got, kernel_stages.PLAIN[stage](d))


def test_toy_kernel_matches_plain(dev):
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).view(8, 128) - 7
    launches = warmup_build.LAUNCHES
    assert torch.equal(warmup_build.toy(x), x * 2 + 1)
    assert warmup_build.LAUNCHES == launches + 1


def test_graph_capture_and_replay_count_no_launch(dev):
    """A CUDA graph's capture launches nothing and its replays do not call
    the wrappers: only the eager warm-up call counts, and the replayed
    graph computes the toy result."""
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).view(8, 128)
    out = []
    launches = warmup_build.LAUNCHES
    g = _timing._graph(lambda i: out.append(warmup_build.toy(x)), 3)
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    assert warmup_build.LAUNCHES == launches + 1
    assert all(torch.equal(y, x * 2 + 1) for y in out)


@pytest.mark.parametrize("name", kernel_features.KERNELS)
def test_feature_kernel_matches_plain(dev, name):
    """Every feature probe that compiles is exact; one that does not is
    reported by kernel_features.check and skipped here."""
    head = kernel_features.compiled(name)
    if head is not None:
        pytest.skip(f"{name} did not compile: {head}")
    args = kernel_features.inputs(name, "tiny", dev, seed=30)
    got = kernel_features.run(name, *args)
    torch.cuda.synchronize()
    want = kernel_features._plain(name, *args)
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("K", [128, 256])
def test_merge_steps_on_the_card_equal_merge(dev, K):
    """merge_cuda's four steps called one by one equal merge(), one launch
    each, and run_kernel equals its plain version merge_blocks."""
    cap, m = 1 << 20, 4096
    n = cap - m - 99
    args = merge_phases.lanes(cap, m, n, 40, dev)
    launches = merge_cuda.LAUNCHES
    a, ta = merge_cuda.merge(*args, K)
    b, tb = merge_phases.composed(*args, K)
    torch.cuda.synchronize()
    assert merge_cuda.LAUNCHES == launches + 2
    live = n + m
    assert torch.equal(a[:live], b[:live])
    assert torch.equal(ta[: live // K + 1], tb[: live // K + 1])
    bwt, pos, sym, stream, valid, nt = args
    nb = -(-bwt.shape[0] // merge_cuda.BS)
    dest, insmap = merge_cuda.insertion_map(pos, sym, stream, valid, nb)
    start = merge_cuda.block_prefix(dest, nb)
    got, grows = merge_cuda.run_kernel(bwt, insmap, start, nt)
    want, wrows = merge_cuda.merge_blocks(bwt, insmap, start, nt)
    assert torch.equal(got[:live], want[:live])
    assert torch.equal(grows, wrows)
