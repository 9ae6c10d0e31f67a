"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the port's build on the card against its build on the CPU.

These tests need an NVIDIA GPU and skip without one.  Later ones hold
the probe suite's kernels (ropebwt2_tpu_torch/probes) against their plain
versions, and the queries, the run export, the CLI and the sharded
engine (a world of one over NCCL) on the card against the CPU.  They
import neither JAX nor the test helpers in conftest.py, so they also run
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every comparison is exact (integers): the live prefix and its table rows
for the flat and the packed merge, every row for the pending merge."""

import numpy as np
import pytest
import torch

from ropebwt2_tpu_torch import cli
from ropebwt2_tpu_torch.engine import TorchBwt
from ropebwt2_tpu_torch.engine import query
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


def _pending_inputs(rng, dev, pcap, pfill, m, a, nmax=1 << 26, run_at=None):
    """A pending index of pfill rows and one round of m lanes, the first a
    active; ``run_at``: every lane inserts at the virtual position of that
    pending row, so the new slots are one run of a rows from there."""
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
    gX = np.sort(rng.integers(0, nmax, m))
    if run_at is not None:
        gX[:] = vp[run_at]
    stream = np.where(np.arange(m) < a, np.arange(m), 0)
    row = [torch.from_numpy(x).to(dev) for x in (
        gX, rng.integers(0, 6, m), stream, np.arange(m) < a)]
    return pend, row


# pcap 2^16, 2^13 lanes; name: (rows held, active lanes, run_at)
_PENDING_CASES = {
    "0.0": (0, 1 << 13, None),  # both CTAs all new
    "0.3": (19660, 1 << 13, None),
    "0.9": (58982, (1 << 16) - 58982, None),  # fills up: p_after == pcap
    "nothing": (0, 0, None),  # p_after == 0: the launched CTAs are all dead
    "ragged": (10000, 1234, None),  # p_after % 4096 != 0, far below pcap
    "all_new_cta": (30000, 1 << 13, 12345),  # a run of 8192 new slots
}


@pytest.mark.parametrize("case", list(_PENDING_CASES))
def test_pending_kernel_matches_plain(dev, case):
    """Kernel B against merge_rows through the ping-pong interface: both
    write into the same garbage-filled planes with the engine's bound, must
    agree on every row, and must leave the rows past the written blocks
    untouched."""
    rng = np.random.default_rng(len(case) + sum(map(ord, case)))
    pcap, m = 1 << 16, 1 << 13
    pfill, a, run_at = _PENDING_CASES[case]
    pend, row = _pending_inputs(rng, dev, pcap, pfill, m, a, run_at=run_at)
    args = (pend.vp, pend.psym, *new_rows(pend, *row))
    bound = min(pcap, pfill + m)
    hi = pending_cuda.n_blocks(pcap, bound) * pending_cuda.BS
    junk = (torch.from_numpy(rng.integers(0, 1 << 40, pcap)).to(dev),
            torch.from_numpy(rng.integers(0, 6, pcap).astype(np.int8)).to(dev))
    launches = pending_cuda.LAUNCHES
    got = pending_cuda.merge(*args, tuple(x.clone() for x in junk), bound)
    torch.cuda.synchronize()
    assert pending_cuda.LAUNCHES == launches + 1
    want = merge_rows(*args, tuple(x.clone() for x in junk), bound)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(args[-1]) == pfill + a
    assert torch.equal(got[0][hi:], junk[0][hi:])
    assert torch.equal(got[1][hi:], junk[1][hi:])
    assert not got[2][hi // KP:].any()
    # without planes or a bound: fresh INF/PAD planes, every block written
    for g, w in zip(pending_cuda.merge(*args), merge_rows(
            *args, pending_cuda.fresh_planes(pcap, dev))):
        assert torch.equal(g, w)


def test_pending_ping_pong_on_the_card_matches_the_cpu(dev):
    """pending_add chained over 5 rounds, a reset and 5 more on the card
    (kernel B, two plane pairs in turn) against the same chain on the CPU
    (the plain version): every row of both planes, the prefix table and p
    after every round, and one launch a round."""
    from ropebwt2_tpu_torch.index.pending import (
        empty_pending, pending_add, reset_pending,
    )

    rng = np.random.default_rng(77)
    pcap, m, rounds = 5 * 4096 + 256, 4096, 5
    pends = [empty_pending(pcap, d) for d in (dev, "cpu")]
    launches = pending_cuda.LAUNCHES
    for r in range(2 * rounds):
        if r == rounds:
            pends = [reset_pending(p) for p in pends]
        a = int(rng.integers(m // 2, m + 1))
        gX = np.sort(rng.integers(0, 1 << 26, m))
        stream = np.where(np.arange(m) < a, np.arange(m), 0)
        lanes = (gX, rng.integers(0, 6, m), stream, np.arange(m) < a)
        pends = [pending_add(p, *(torch.from_numpy(x).to(p.vp.device)
                                  for x in lanes)) for p in pends]
        torch.cuda.synchronize()
        g, w = pends
        assert g.bound == w.bound == min(pcap, (r % rounds + 1) * m)
        assert int(g.p) == int(w.p)
        assert torch.equal(g.vp.cpu(), w.vp)
        assert torch.equal(g.psym.cpu(), w.psym)
        assert torch.equal(g.blk_prefix.cpu(), w.blk_prefix)
        assert (w.vp[int(w.p):] == INF).all() and (w.psym[int(w.p):] == 6).all()
    assert pending_cuda.LAUNCHES == launches + 2 * rounds


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


@pytest.mark.parametrize("case", ["random", "dense", "garbage", "masked",
                                  "mixed", "aligned"])
def test_merge_packed_kernel_matches_plain(dev, case):
    """Kernel C against apply_insertions_packed + build_two_level_tables;
    the garbage case also has a capacity that is not a multiple of the
    CTA's 4096 symbols, so its last CTA is ragged, and the masked case
    leaves three lanes in four inactive, as a flush of a part-filled
    pending set does.  The mixed case has CTAs with no insertion (every
    thread copies its window), 6000 insertions at one position (CTAs that
    are all insertions) and sparse ones after them, so old runs start at
    symbol 0, inside a packed row (17 rows staged) and on a row boundary;
    the aligned case inserts 256 at a time, so every old run starts on a
    packed row."""
    rng = np.random.default_rng(50 + len(case))
    cap = (1 << 20) + (768 if case == "garbage" else 0)
    m = 8192 if case == "mixed" else 4096
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
    elif case == "mixed":
        pos[:6000] = 40 * 4096 + 77
        pos[6000:a] = np.sort(rng.integers(n // 2, n + 1, a - 6000))
    elif case == "aligned":
        pos[:a] = np.sort(rng.integers(0, n // 256, a // 256)).repeat(256) \
            * 256
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
    got, gpre = merge_cuda.run_kernel(bwt, insmap, start, nt, torch.int32)
    want, wpre = merge_cuda.merge_blocks(bwt, insmap, start, nt, torch.int32)
    assert torch.equal(got[:live], want[:live])
    assert torch.equal(gpre[: live // 128 + 1], wpre[: live // 128 + 1])


def _kernel_inputs(dev, cap, n, pos, seed):
    """A buffer of n random symbols and random int8 past them, and the
    insertion map and block prefix of sorted insertions at ``pos``."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(-128, 128, cap + PAD_TAIL).astype(np.int8)
    buf[:n] = rng.integers(0, 6, n)
    m = len(pos)
    bwt, pos, sym, nt = [torch.from_numpy(np.asarray(x)).to(dev) for x in (
        buf, pos, rng.integers(0, 6, m), n)]
    nb = -(-bwt.shape[0] // merge_cuda.BS)
    dest, insmap = merge_cuda.insertion_map(
        pos, sym, torch.arange(m, device=dev),
        torch.ones(m, dtype=torch.bool, device=dev), nb)
    return bwt, insmap, merge_cuda.block_prefix(dest, nb), nt


def _held_against_plain(args, live, dtype):
    """run_kernel against merge_blocks on the live prefix and its rows."""
    launches = merge_cuda.LAUNCHES
    got, gpre = merge_cuda.run_kernel(*args, dtype)
    torch.cuda.synchronize()
    assert merge_cuda.LAUNCHES == launches + 1
    want, wpre = merge_cuda.merge_blocks(*args, dtype)
    rows = live // 128 + 1
    assert gpre.dtype == dtype
    assert torch.equal(got[:live], want[:live])
    assert torch.equal(gpre[:rows], wpre[:rows])
    return got, gpre


def test_merge_kernel_look_back_across_waves(dev):
    """cap 2^25 + 2^20: 8,449 CTAs against 1,056 resident, so the
    look-back chain runs across several waves of CTAs; merge() against
    apply_insertions + build_block_tables at K = 128."""
    rng = np.random.default_rng(90)
    cap, m = (1 << 25) + (1 << 20), 1 << 16
    n = cap - m - 4321
    args = _kernel_inputs(dev, cap, n, np.sort(rng.integers(0, n + 1, m)),
                          91)
    assert args[2].shape[0] - 1 >= 8 * 1056
    _held_against_plain(args, n + m, torch.int32)
    bwt, _, _, nt = args
    pos = torch.from_numpy(np.sort(rng.integers(0, n + 1, m))).to(dev)
    sym = torch.from_numpy(rng.integers(0, 6, m)).to(dev)
    stream = torch.arange(m, device=dev)
    valid = torch.ones(m, dtype=torch.bool, device=dev)
    got, got_blk = merge_cuda.merge(bwt, pos, sym, stream, valid, nt, 128)
    want = apply_insertions(bwt, nt, pos, sym, stream, valid)
    want_blk = build_block_tables(want, 128, dtype=torch.int32)
    rows = (n + m) // 128 + 1
    assert torch.equal(got[: n + m], want[: n + m])
    assert torch.equal(got_blk[:rows], want_blk[:rows])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_merge_kernel_int64_prefix_at_a_small_cap(dev, dtype):
    """run_kernel with int64 and int32 prefix rows, a ragged last CTA."""
    rng = np.random.default_rng(92)
    cap, m = 5 * 4096 + 1280, 700
    n = cap - m - 33
    args = _kernel_inputs(dev, cap, n, np.sort(rng.integers(0, n + 1, m)),
                          93)
    _, pre = _held_against_plain(args, n + m, dtype)
    assert not pre[0].any()


def test_merge_kernel_cta_mix(dev):
    """CTAs with no insertion (every thread copies its window), CTAs that
    are all insertions, insertions at symbol 0, and runs of 16 insertions
    at 16-byte boundaries of the old run, so that old runs start at
    offsets 0 and 1-15 of a 16-byte chunk: both gather paths, every
    alignment of the staging."""
    rng = np.random.default_rng(94)
    cap, n = 1 << 22, (1 << 22) - 60_000
    pos = np.concatenate([
        np.zeros(5, np.int64),                        # at symbol 0
        np.full(9000, 40 * 4096 + 77),                # all-insertion CTAs
        np.repeat(rng.integers(200 * 16, 300 * 16, 40) // 16 * 16, 16),
        np.sort(rng.integers(n // 2, n + 1, 3000)),   # sparse, any offset
    ])
    pos = np.sort(pos)
    args = _kernel_inputs(dev, cap, n, pos, 95)
    start = args[2].cpu().numpy()
    o0 = np.arange(start.shape[0] - 1) * 4096 - start[:-1]
    live = n + len(pos)
    live_o0 = o0[: -(-live // 4096)]
    assert (live_o0 % 16 == 0).any() and (live_o0 % 16 != 0).any()
    ins = (args[1][: start.shape[0] * 4096 - 4096] != 0).view(-1, 4096)
    per_cta = ins.sum(1).cpu().numpy()[: -(-live // 4096)]
    assert (per_cta == 0).any() and (per_cta == 4096).any()
    _held_against_plain(args, live, torch.int32)


def test_merge_kernel_in_a_cuda_graph(dev):
    """One CUDA graph of two launches (the status words and the ticket are
    reset inside it), replayed twice: each replay equals the eager
    result."""
    rng = np.random.default_rng(96)
    cap, m = 1 << 22, 1 << 13
    n = cap - m - 999
    args = _kernel_inputs(dev, cap, n, np.sort(rng.integers(0, n + 1, m)),
                          97)
    live, rows = n + m, (n + m) // 128 + 1
    want, wpre = merge_cuda.run_kernel(*args, torch.int32)
    outs = []
    g = _timing._graph(lambda i: outs.append(merge_cuda.run_kernel(
        *args, torch.int32)), 2)
    for _ in range(2):
        for o, pre in outs[1:]:  # outs[0]: the eager warm-up call's
            o.zero_()
            pre.fill_(-1)
        g.replay()
        torch.cuda.synchronize()
        for got, gpre in outs[1:]:
            assert torch.equal(got[:live], want[:live])
            assert torch.equal(gpre[:rows], wpre[:rows])


@pytest.mark.parametrize("pack4", [0, 1])
def test_queries_and_run_arrays_on_the_card_match_the_cpu(dev, pack4):
    rng = np.random.default_rng(70 + pack4)
    reads = [rng.integers(1, 6, int(k)).astype(np.int8)
             for k in rng.integers(1, 120, 2000)]
    reads += [np.full(int(k), 2, np.int8) for k in rng.integers(1, 500, 50)]
    engines = [TorchBwt(so=1, device=d, pack4=pack4) for d in (dev, "cpu")]
    for eng in engines:
        eng.insert_multi(reads)
    card, cpu = (e.state for e in engines)
    n = engines[0].n
    pos = np.sort(rng.integers(0, n + 1, 5000))
    y = np.minimum(pos + rng.integers(0, 300, pos.size), n)
    c = rng.integers(0, 6, pos.size)
    for fn, args in ((query.rank1a, (pos,)), (query.rank2a, (pos, y)),
                     (query.rank11, (pos, c)), (query.rank21, (pos, y, c))):
        got, want = fn(card, *args), fn(cpu, *args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.device.type == dev.type and torch.equal(g.cpu(), w)
    ik = np.stack([pos, np.zeros_like(pos), y - pos], axis=1)
    for back in (True, False):
        assert torch.equal(query.extend(card, ik, is_back=back).cpu(),
                           query.extend(cpu, ik, is_back=back))
    pats = rng.integers(1, 5, (3000, 12))
    lens = rng.integers(1, 13, 3000)
    for g, w in zip(query.backward_search(card, pats, lens),
                    query.backward_search(cpu, pats, lens)):
        assert torch.equal(g.cpu(), w)
    offs = np.concatenate([[0], np.cumsum(cpu.psize.numpy())])
    for bounds in (None, offs):
        for chunk in (256, 1 << 28):
            got = engines[0].run_arrays(bounds=bounds, chunk=chunk)
            want = engines[1].run_arrays(bounds=bounds, chunk=chunk)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_cli_builds_on_the_card_by_default(dev, tmp_path, capsys):
    """main() with no device builds on the card; its FMD equals the CPU's."""
    rng = np.random.default_rng(72)
    lut = np.frombuffer(b"$ACGTN", np.uint8)
    p = tmp_path / "in.txt"
    p.write_bytes(b"".join(lut[r].tobytes() + b"\n"
                           for r in rng.integers(1, 5, (3000, 60))))
    outs = []
    for device in (None, "cpu"):
        out = tmp_path / f"{device}.fmd"
        assert cli.main(["-Ls", "-d", "-o", str(out), str(p)],
                        device=device) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    assert "[M::main] device cuda" in capsys.readouterr().err


@pytest.mark.parametrize("defer_r", [0, 4])
def test_run_tier_build_on_the_card_matches_the_cpu(dev, defer_r):
    """TorchBwt(runs=1) on the card: the same state, field by field, BWT,
    run arrays and queries as on the CPU; deferred, kernel B launches."""
    rng = np.random.default_rng(80 + defer_r)
    batches = [[rng.integers(1, 6, int(k)).astype(np.int8)
                for k in rng.integers(1, 60, 300)] for _ in range(2)]
    batches.append(rng.integers(1, 5, (200, 101)).astype(np.int8))
    engines = [TorchBwt(so=1, defer_r=defer_r, device=d, runs=1)
               for d in (dev, "cpu")]
    pendings = pending_cuda.LAUNCHES
    for eng in engines:
        for b in batches:
            eng.insert_multi(b)
    assert (pending_cuda.LAUNCHES > pendings) == (defer_r > 0)
    card, cpu = (e.state for e in engines)
    assert type(card).__name__ == "RunBwt"
    for f in ("rsym", "rend", "bstart", "bocc", "nslot", "overflow", "n",
              "psize", "pcounts"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    assert np.array_equal(engines[0].bwt_array(), engines[1].bwt_array())
    offs = np.concatenate([[0], np.cumsum(cpu.psize.numpy())])
    for got, want in zip(engines[0].run_arrays(bounds=offs),
                         engines[1].run_arrays(bounds=offs)):
        assert np.array_equal(got, want)
    pos = np.sort(rng.integers(0, engines[0].n + 1, 3000))
    assert torch.equal(query.rank1a(card, pos).cpu(),
                       query.rank1a(cpu, pos))


def test_run_tier_overflow_raises_on_the_card(dev):
    """A batch that outgrows a fixed slot capacity raises after it, and
    the corrupt index exports nothing."""
    rng = np.random.default_rng(82)
    eng = TorchBwt(so=1, device=dev, runs=1, runs_margin=0.35,
                   runs_rcap=16384)
    with pytest.raises(RuntimeError, match="outgrew"):
        eng.insert_multi(rng.integers(1, 5, (600, 40)).astype(np.int8))
    with pytest.raises(RuntimeError, match="corrupt"):
        eng.bwt_array()


@pytest.mark.parametrize("s_lo", [0, 7, 3000])
def test_stitched_merge_kernel_matches_plain(dev, s_lo):
    """Kernel A on one rank's stitched buffer (parallel/sharded.py): the
    window and its rebased table rows against merge_blocks on the same
    arguments, a phantom drift of s_lo and 2^12 routed insertions."""
    from ropebwt2_tpu_torch.parallel.sharded import (
        stitched_args, stitched_window,
    )

    rng = np.random.default_rng(90 + s_lo)
    lcap, m, a = 1 << 20, 1 << 14, 1 << 12
    rv = np.zeros(m, bool)
    rv[rng.choice(m, a, replace=False)] = True
    ldest = np.full(m, lcap)
    ldest[rv] = np.sort(rng.choice(lcap, a, replace=False))
    bwt, tail, ldest, rsym, rv = (torch.from_numpy(x).to(dev) for x in (
        rng.integers(0, 6, lcap + PAD_TAIL).astype(np.int8),
        rng.integers(0, 6, m).astype(np.int8), ldest,
        rng.integers(0, 6, m), rv))
    args = stitched_args(bwt, tail, ldest, rsym, rv,
                         torch.tensor(s_lo, device=dev), lcap)
    launches = merge_cuda.LAUNCHES
    got = stitched_window(*merge_cuda.run_kernel(*args), m, lcap, 256)
    torch.cuda.synchronize()
    assert merge_cuda.LAUNCHES == launches + 1
    want = stitched_window(*merge_cuda.merge_blocks(*args), m, lcap, 256)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("defer_r", [0, 4])
def test_sharded_world_of_one_on_the_card_matches_the_cpu(dev, defer_r):
    """ShardedTorchBwt with no device: a world of one over NCCL on the
    card, which builds the BWT TorchBwt builds on the CPU; kernel A
    launches, and kernel B when deferred; the group ends with the mesh."""
    import torch.distributed as dist
    from ropebwt2_tpu_torch.parallel.sharded import ShardedTorchBwt

    rng = np.random.default_rng(84 + defer_r)
    batches = [[rng.integers(1, 6, int(k)).astype(np.int8)
                for k in rng.integers(1, 60, 300)] for _ in range(2)]
    ref = TorchBwt(so=1, defer_r=defer_r, device="cpu")
    eng = ShardedTorchBwt(so=1, defer_r=defer_r)
    try:
        assert dist.get_backend() == "nccl" and eng.device.type == "cuda"
        merges, pendings = merge_cuda.LAUNCHES, pending_cuda.LAUNCHES
        for b in batches:
            ref.insert_multi(b)
            eng.insert_multi(b)
        assert merge_cuda.LAUNCHES > merges
        assert (pending_cuda.LAUNCHES > pendings) == (defer_r > 0)
        assert np.array_equal(eng.bwt_array(), ref.bwt_array())
        assert np.array_equal(eng.counts(), ref.counts())
        for got, want in zip(eng.run_arrays(), ref.run_arrays()):
            assert np.array_equal(got, want)
    finally:
        eng.mesh.close()
    assert not dist.is_initialized()
