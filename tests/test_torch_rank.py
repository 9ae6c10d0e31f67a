"""The rank wrappers (ropebwt2_tpu_torch/index/rank_cuda.py) and their
kernels (csrc/rank.cu).

On the CPU a wrapper runs its plain version: each is held here to the JAX
package's rank_global, rank_global_packed, pending_rank, rank_virtual and
rank_virtual_base over rank_global_packed on the same numpy-seeded inputs
(int32 and int64 prefixes, K 128 and 256; positions 0, n and every
multiple of 128 +- 1; a pending index empty, half full, full, and queried
at its INF rows, at its rows and next to them; packed buffers with PAD or
any nibble past n, and base positions on both sides of an anchor row's
edge).  The call sites of the engine, the queries and the sharded engine
are held to reach the wrappers, so that on the card they take the kernels
and not the plain count: a deferred flat round ranks through
rank_virtual_flat, a deferred packed round through rank_virtual_packed
(one launch each).
prefix_rows, which builds the rank tables, is held to numpy's cumsum of
each column (int32, and int64 past 2^31).

The tests marked ``cuda`` hold each kernel to its plain version on the
card at 2^16 queries (K 128 to 1024 for the flat and the virtual rank;
the packed kernels with n past 2^31), and skip without a card.  They
import no JAX (the CPU tests import it inside), so they run where JAX is
not installed, with ``python -m pytest --noconftest -p no:cacheprovider
-m cuda`` on this file.

Every comparison is exact (integers)."""

import numpy as np
import pytest
import torch

from ropebwt2_tpu_torch.index import flat, packed, pending, rank, rank_cuda
from ropebwt2_tpu_torch.index.pending import INF, KP, PendingIndex

LANE = 128


def _buffer(rng, cap, n):
    """int8[cap + PAD_TAIL]: symbols on [0, n), any byte past n (content
    past n after a merge is unspecified)."""
    buf = rng.integers(-128, 128, cap + flat.PAD_TAIL).astype(np.int8)
    buf[:n] = rng.integers(0, 6, n)
    return buf


def _positions(rng, n, q):
    """0, n, every multiple of 128 +- 1 in [0, n], and random ones."""
    m = np.arange(0, n + 1, LANE)
    edge = np.concatenate([[0, n], m - 1, m, m + 1])
    edge = edge[(edge >= 0) & (edge <= n)]
    return np.concatenate([edge, rng.integers(0, n + 1, q)]).astype(np.int64)


def _pending_np(rng, pcap, pfill):
    """(vp, psym, blk_prefix) of a pending index with pfill live rows:
    strictly increasing vp, INF past them."""
    vp = np.full(pcap, INF, np.int64)
    vp[:pfill] = np.sort(rng.integers(0, (1 << 24) - pfill, pfill)) \
        + np.arange(pfill)
    psym = np.full(pcap, flat.PAD, np.int8)
    psym[:pfill] = rng.integers(0, 6, pfill)
    counts = rank.block_counts(torch.from_numpy(psym), KP)
    return vp, psym, rank.prefix_rows(counts, torch.int32).numpy()


def _pending_queries(rng, vp, pfill, q=1024):
    """q queries: the INF rows, the live rows' first and last 64 and their
    successors, and random ones."""
    live = vp[:pfill]
    g = np.concatenate([[0, 1 << 24, INF - 1, INF, INF + 1], live[:64],
                        live[:64] + 1, live[-64:], live[-64:] + 1])
    return np.concatenate([g, rng.integers(0, 1 << 24, q - g.shape[0])])


def _pend(vp, psym, prefix, pfill, device="cpu"):
    return PendingIndex(
        vp=torch.as_tensor(vp, device=device),
        psym=torch.as_tensor(psym, device=device),
        blk_prefix=torch.as_tensor(prefix, device=device),
        p=torch.tensor(pfill, device=device))


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("wide", [False, True])
def test_rank_flat_matches_jax(K, wide):
    """rank_cuda.rank_flat == the JAX rank_global, at positions in any
    order and at the sorted positions the engine gives it."""
    import jax.numpy as jnp
    from ropebwt2_tpu.index import rank as jrank

    rng = np.random.default_rng(K + wide)
    cap, n = 1 << 14, 12345
    buf = _buffer(rng, cap, n)
    pos = _positions(rng, n, 400)
    dt, jdt = (torch.int64, jnp.int64) if wide else (torch.int32, jnp.int32)
    tb = torch.from_numpy(buf)
    tab = rank.build_block_tables(tb, K, dtype=dt)
    got = rank_cuda.rank_flat(tb, tab, torch.from_numpy(pos), K)
    jb = jnp.asarray(buf)
    jtab = jrank.build_block_tables(jb, K, dtype=jdt)
    want = jrank.rank_global(jb, jtab, jnp.asarray(pos), K)
    assert got.dtype == dt
    assert np.array_equal(got.numpy(), np.asarray(want))

    pos = np.sort(pos)
    got = rank_cuda.rank_flat(tb, tab, torch.from_numpy(pos), K)
    want = jrank.rank_global(jb, jtab, jnp.asarray(pos), K)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _packed_np(rng, cap, n, garbage):
    """A packed buffer of cap symbols (n of them live; past n PAD, or any
    nibble 0..15 when ``garbage``) with its tail rows."""
    syms = np.full(cap + packed.PPAD_ROWS * 2 * LANE, flat.PAD, np.int8)
    syms[:n] = rng.integers(0, 6, n)
    if garbage:
        syms[n:] = rng.integers(0, 16, syms.shape[0] - n)
    return packed.pack_bwt_np(syms)


@pytest.mark.parametrize("garbage", [False, True])
def test_rank_packed_matches_jax(garbage):
    """rank_cuda.rank_packed == the JAX rank_global_packed over a packed
    buffer with PAD or any nibble past n."""
    import jax.numpy as jnp
    from ropebwt2_tpu.index import packed as jpacked

    rng = np.random.default_rng(20 + garbage)
    cap = 1 << 16
    n = cap - 300
    pb = _packed_np(rng, cap, n, garbage)
    pos = _positions(rng, n, 400)
    tpb = torch.from_numpy(pb)
    blkA, blkB = packed.build_two_level_tables(tpb, cap)
    got = rank_cuda.rank_packed(tpb, blkA, blkB, torch.from_numpy(pos))
    jpb = jnp.asarray(pb)
    jA, jB = jpacked.build_two_level_tables(jpb, cap)
    want = np.asarray(jpacked.rank_global_packed(jpb, jA, jB,
                                                 jnp.asarray(pos)))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("fill", ["empty", "half", "full"])
def test_pending_rank_matches_jax(fill):
    """rank_cuda.pending_rank == the JAX pending_rank: p and occ, on an
    empty, a half full and a full index, queried at live rows, next to
    them and at the INF rows."""
    import jax.numpy as jnp
    from ropebwt2_tpu.index import pending as jp

    rng = np.random.default_rng(30 + len(fill))
    pcap = 1 << 12
    pfill = {"empty": 0, "half": pcap // 2 + 77, "full": pcap}[fill]
    vp, psym, prefix = _pending_np(rng, pcap, pfill)
    g = _pending_queries(rng, vp, pfill)
    jpend = jp.PendingIndex(vp=jnp.asarray(vp), psym=jnp.asarray(psym),
                            blk_prefix=jnp.asarray(prefix),
                            p=jnp.asarray(pfill, jnp.int32))
    jpos, jocc = jp.pending_rank(jpend, jnp.asarray(g))
    p, occ = rank_cuda.pending_rank(_pend(vp, psym, prefix, pfill),
                                    torch.from_numpy(g))
    assert p.dtype == torch.int64 and occ.dtype == torch.int32
    assert np.array_equal(p.numpy(), np.asarray(jpos))
    assert np.array_equal(occ.numpy(), np.asarray(jocc))


def _virtual_case(rng, K, wide, fill, pcap=1 << 12):
    """A flat base (n symbols, any byte past n) with its K-block table,
    and _virtual_pending's index and queries over it."""
    cap, n = 1 << 14, 12345
    buf = _buffer(rng, cap, n)
    pend, g = _virtual_pending(rng, n, fill, pcap)
    dt = torch.int64 if wide else torch.int32
    tab = rank.build_block_tables(torch.from_numpy(buf), K, dtype=dt)
    return buf, tab, pend, g


def _virtual_pending(rng, n, fill, pcap=1 << 12):
    """A pending index of pcap rows at ``fill`` over a base of n symbols,
    and queries in [0, n_virtual]: 0, n_virtual, every live row's position
    and its neighbours, the live range's end (the INF rows follow it),
    random."""
    pfill = {"empty": 0, "half": pcap // 2 + 77, "full": pcap}[fill]
    vp = np.full(pcap, INF, np.int64)
    vp[:pfill] = np.sort(rng.integers(0, n, pfill)) + np.arange(pfill)
    psym = np.full(pcap, flat.PAD, np.int8)
    psym[:pfill] = rng.integers(0, 6, pfill)
    prefix = rank.prefix_rows(rank.block_counts(torch.from_numpy(psym), KP),
                              torch.int32).numpy()
    nv = n + pfill
    live = vp[:pfill]
    g = np.concatenate([[0, nv, nv - 1], live, live + 1, live - 1,
                        live[-1:] + 2, rng.integers(0, nv + 1, 500)])
    g = g[(g >= 0) & (g <= nv)].astype(np.int64)
    return (vp, psym, prefix, pfill), g


def _at_base(vp, pfill, x):
    """The virtual positions g whose base position g - p(g) is x: base
    symbol x follows the pending rows inserted at or before it, those
    with vp[i] - i <= x."""
    below = vp[:pfill] - np.arange(pfill)
    return (x + np.searchsorted(below, x, side="right")).astype(np.int64)


@pytest.mark.parametrize("fill", ["empty", "half", "full"])
@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("wide", [False, True])
def test_rank_virtual_flat_matches_jax(fill, K, wide):
    """rank_cuda.rank_virtual_flat == the JAX rank_virtual (the pending
    count, then the flat rank at g - p, plus the pending counts) on an
    empty, a half full and a full pending index; the clamped form ==
    rank_global at clamp(g - p) plus the JAX pending counts."""
    import jax.numpy as jnp
    from ropebwt2_tpu.index import pending as jp
    from ropebwt2_tpu.index import rank as jrank

    rng = np.random.default_rng(70 + K + wide + len(fill))
    buf, tab, (vp, psym, prefix, pfill), g = _virtual_case(rng, K, wide,
                                                           fill)
    pend = _pend(vp, psym, prefix, pfill)
    got = rank_cuda.rank_virtual_flat(torch.from_numpy(buf), tab, pend,
                                      torch.from_numpy(g), K)
    jb = jnp.asarray(buf)
    jtab = jrank.build_block_tables(
        jb, K, dtype=jnp.int64 if wide else jnp.int32)
    jpend = jp.PendingIndex(vp=jnp.asarray(vp), psym=jnp.asarray(psym),
                            blk_prefix=jnp.asarray(prefix),
                            p=jnp.asarray(pfill, jnp.int32))
    want = np.asarray(jp.rank_virtual(jb, jtab, jpend, jnp.asarray(g), K))
    assert got.dtype == tab.dtype
    assert np.array_equal(got.numpy(), want)

    lo, hi = 100, 9000
    got = rank_cuda.rank_virtual_flat(torch.from_numpy(buf), tab, pend,
                                      torch.from_numpy(g), K, lo=lo, hi=hi)
    jpos, jocc = jp.pending_rank(jpend, jnp.asarray(g))
    x = np.clip(g - np.asarray(jpos), lo, hi)
    want = np.asarray(jrank.rank_global(jb, jtab, jnp.asarray(x), K)) \
        + np.asarray(jocc)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("fill,garbage,cap", [
    *[(f, gb, 1 << 16) for f in ("empty", "half", "full")
      for gb in (False, True)],
    ("half", True, 1 << 25)])
def test_rank_virtual_packed_matches_jax(fill, garbage, cap):
    """rank_cuda.rank_virtual_packed == the JAX rank_virtual_base over
    rank_global_packed (the pending count, then the packed rank at g - p,
    plus the pending counts) on an empty, a half full and a full pending
    index, over a packed buffer with PAD or any nibble past n; at cap 2^25
    (two anchor rows) also where the base position g - p is 2^24 - 1,
    2^24 and 2^24 + 1."""
    import jax.numpy as jnp
    from ropebwt2_tpu.index import packed as jpacked
    from ropebwt2_tpu.index import pending as jp

    rng = np.random.default_rng(90 + len(fill) + garbage + (cap >> 24))
    n = cap - 300
    pb = _packed_np(rng, cap, n, garbage)
    (vp, psym, prefix, pfill), g = _virtual_pending(rng, n, fill)
    edge = np.arange((1 << 24) - 1, (1 << 24) + 2)
    if cap > 1 << 24:
        g = np.concatenate([g, _at_base(vp, pfill, edge)])
    tpb = torch.from_numpy(pb)
    blkA, blkB = packed.build_two_level_tables(tpb, cap)
    got = rank_cuda.rank_virtual_packed(tpb, blkA, blkB,
                                        _pend(vp, psym, prefix, pfill),
                                        torch.from_numpy(g))
    jpb = jnp.asarray(pb)
    jA, jB = jpacked.build_two_level_tables(jpb, cap)
    jpend = jp.PendingIndex(vp=jnp.asarray(vp), psym=jnp.asarray(psym),
                            blk_prefix=jnp.asarray(prefix),
                            p=jnp.asarray(pfill, jnp.int32))
    jg = jnp.asarray(g)
    want = np.asarray(jp.rank_virtual_base(
        lambda x: jpacked.rank_global_packed(jpb, jA, jB, x), jpend, jg))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    if cap > 1 << 24:  # the anchor edge was reached
        jpos, _ = jp.pending_rank(jpend, jg)
        assert set(edge) <= set((g - np.asarray(jpos)).tolist())


def _counting(monkeypatch):
    """Count the calls of every wrapper and of every plain version (the
    wrappers reach the plain versions through their modules on the CPU)."""
    calls = {}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)

    for name in ("rank_flat", "rank_packed", "pending_rank",
                 "rank_virtual_flat", "rank_virtual_packed"):
        wrap(rank_cuda, name, name)
    wrap(rank, "rank_global", "plain flat")
    wrap(packed, "rank_global_packed", "plain packed")
    wrap(pending, "pending_rank", "plain pending")
    wrap(pending, "rank_virtual", "plain virtual")
    wrap(pending, "rank_virtual_packed", "plain virtual packed")
    return calls


def _reads(seed, m):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 5, int(rng.integers(20, 40))).astype(np.int8)
            for _ in range(m)]


@pytest.mark.parametrize("tier", ["flat", "packed"])
def test_engine_and_queries_reach_the_wrappers(tier, monkeypatch):
    """_state_rank_fn (a batch merged every round), the deferred rank and
    engine/query.py's _base_rank call the wrappers, and the plain counts
    run only from inside them.  A deferred round ranks through
    rank_virtual_flat on the flat tier and through rank_virtual_packed on
    the packed tier (one call a rank, never pending_rank + the base
    rank); the queries rank through rank_flat or rank_packed."""
    from ropebwt2_tpu_torch.engine import TorchBwt, query

    calls = _counting(monkeypatch)
    wrapper = "rank_flat" if tier == "flat" else "rank_packed"
    plain = f"plain {tier}"
    tiers = {} if tier == "flat" else {"pack4": 1}
    e = TorchBwt(so=1, K=128, defer_r=0, device="cpu", **tiers)
    e.insert_multi(_reads(1, 64))  # defer_r 0: the base rank every round
    assert calls[wrapper] > 0 and "pending_rank" not in calls
    assert "rank_virtual_flat" not in calls
    assert "rank_virtual_packed" not in calls
    before = dict(calls)
    eng = TorchBwt(so=1, K=128, defer_r=4, device="cpu", **tiers)
    eng.insert_multi(_reads(2, 64))  # deferred
    virtual, other = ("rank_virtual_flat", "rank_virtual_packed")[
        ::1 if tier == "flat" else -1]
    plain_virtual = "plain virtual" + ("" if tier == "flat" else " packed")
    assert calls[virtual] > 0
    assert calls[virtual] == calls[plain_virtual]
    assert "pending_rank" not in calls and other not in calls
    assert calls[wrapper] == before[wrapper]
    n = calls[wrapper]
    query.rank1a(eng.state, [0, 5, 17])
    assert calls[wrapper] == n + 1
    assert calls[wrapper] == calls[plain]


@pytest.mark.parametrize("defer_r", [0, 4])
def test_sharded_rank_functions_reach_the_wrappers(defer_r, monkeypatch):
    """Both routed rank functions of parallel/sharded.py (merged every
    round: rank_flat; deferred: rank_virtual_flat with the base clamped to
    the rank's window) call the wrappers, on a world of one."""
    from ropebwt2_tpu_torch.engine import TorchBwt
    from ropebwt2_tpu_torch.parallel.sharded import ShardedTorchBwt

    calls = _counting(monkeypatch)
    reads = _reads(3, 96)
    ref = TorchBwt(so=1, K=128, defer_r=defer_r, device="cpu")
    ref.insert_multi(reads)
    before = dict(calls)
    eng = ShardedTorchBwt(so=1, K=128, defer_r=defer_r, device="cpu")
    try:
        eng.insert_multi(reads)
        assert np.array_equal(eng.bwt_array(), ref.bwt_array())
    finally:
        eng.mesh.close()
    key = "rank_virtual_flat" if defer_r else "rank_flat"
    assert calls.get(key, 0) > before.get(key, 0), key
    assert calls.get("rank_flat", 0) == calls.get("plain flat", 0)
    assert calls.get("rank_virtual_flat", 0) == calls.get("plain virtual", 0)
    assert "pending_rank" not in calls


# ----------------------------------------------------------------- card

@pytest.mark.parametrize("dtype,rows,hi", [
    (torch.int32, 300, 100),
    (torch.int64, 300, 1 << 28),  # every column's sum passes 2^31
    (torch.int32, 0, 1),
])
def test_prefix_rows_is_a_cumsum_down_each_column(dtype, rows, hi):
    """prefix_rows (one 1-D scan of the columns laid end to end, less each
    column's start) against numpy's cumsum of each column on its own."""
    rng = np.random.default_rng(5)
    cnts = rng.integers(0, hi, size=(rows, 6)).astype(np.int32)
    got = rank.prefix_rows(torch.from_numpy(cnts), dtype)
    want = np.zeros((rows + 1, 6), np.int64)
    for s in range(6):
        want[1:, s] = np.cumsum(cnts[:, s].astype(np.int64))
    assert got.dtype == dtype and got.shape == (rows + 1, 6)
    assert np.array_equal(got.numpy(), want)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


Q_CARD = 1 << 16


def _card_positions(rng, n, alloc, dev):
    """Q_CARD positions: multiples of 128 +- 1, random ones in [0, n], and
    a few out of range (negative, past n, past the buffer)."""
    edge = np.arange(0, n + 1, LANE)[: Q_CARD // 4]
    pos = np.concatenate([
        edge + rng.integers(-1, 2, edge.shape[0]),
        rng.integers(0, n + 1, Q_CARD // 2),
        [0, n, -1, -129, n + 1, alloc, alloc + 1000, 1 << 40, -(1 << 40)],
    ])
    pos = np.concatenate([pos, rng.integers(0, n + 1,
                                            Q_CARD - pos.shape[0])])
    return torch.from_numpy(pos.astype(np.int64)).to(dev)


def _card_packed(cap, dev):
    """A packed buffer of cap symbols with any nibble anywhere (the counts
    take symbols 0..5 only), its tail rows and its two-level tables."""
    g = torch.Generator(device=dev).manual_seed(50)
    pb = torch.randint(0, 256, (cap // 2 + packed.PPAD_ROWS * LANE,),
                       dtype=torch.uint8, device=dev, generator=g)
    return (pb, *packed.build_two_level_tables(pb, cap))


def _anchor_edges(n):
    """Every anchor row's first position +- 1 up to n, and 2^31 +- 1."""
    a = np.arange(1, n // packed.ACHUNK + 1) * packed.ACHUNK
    x = np.concatenate([a - 1, a, a + 1, [(1 << 31) - 1, 1 << 31,
                                          (1 << 31) + 1]])
    return x[x <= n]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [128, 256, 512, 1024])
@pytest.mark.parametrize("wide", [False, True])
def test_rank_flat_kernel_matches_plain(dev, K, wide):
    rng = np.random.default_rng(40 + K + wide)
    cap, n = 1 << 20, (1 << 20) - 777
    buf = torch.from_numpy(_buffer(rng, cap, n)).to(dev)
    tab = rank.build_block_tables(buf, K, torch.int64 if wide
                                  else torch.int32)
    pos = _card_positions(rng, n, buf.shape[0], dev)
    before = rank_cuda.LAUNCHES["rank_flat"]
    got = rank_cuda.rank_flat(buf, tab, pos, K)
    want = rank.rank_global(buf, tab, pos, K)
    torch.cuda.synchronize()
    assert rank_cuda.LAUNCHES["rank_flat"] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)
    pos = torch.sort(pos).values  # as the engine gives them
    assert torch.equal(rank_cuda.rank_flat(buf, tab, pos, K),
                       rank.rank_global(buf, tab, pos, K))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1 << 22, (1 << 31) + (1 << 25)])
def test_rank_packed_kernel_matches_plain(dev, cap):
    """Any nibble anywhere (the counts take symbols 0..5 only); at the
    larger cap, positions past 2^31 and anchor rows past the first, each
    anchor row's edge +- 1; sorted as the engine gives them too."""
    rng = np.random.default_rng(50)
    n = cap - 1000
    pb, blkA, blkB = _card_packed(cap, dev)
    pos = _card_positions(rng, n, cap, dev)
    pos[:4096] = torch.from_numpy(rng.integers(max(0, n - (1 << 30)), n + 1,
                                               4096)).to(dev)
    edges = _anchor_edges(n)
    pos[4096:4096 + edges.shape[0]] = torch.from_numpy(edges).to(dev)
    before = rank_cuda.LAUNCHES["rank_packed"]
    got = rank_cuda.rank_packed(pb, blkA, blkB, pos)
    want = packed.rank_global_packed(pb, blkA, blkB, pos)
    torch.cuda.synchronize()
    assert rank_cuda.LAUNCHES["rank_packed"] == before + 1
    assert got.dtype == torch.int64 and torch.equal(got, want)
    pos = torch.sort(pos).values
    assert torch.equal(rank_cuda.rank_packed(pb, blkA, blkB, pos),
                       packed.rank_global_packed(pb, blkA, blkB, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1 << 22, (1 << 31) + (1 << 25)])
@pytest.mark.parametrize("fill", ["empty", "half", "full"])
def test_rank_virtual_packed_kernel_matches_plain(dev, cap, fill):
    """rank_virtual_packed_kernel == pending.rank_virtual_packed over a
    packed buffer with any nibble anywhere, at queries in [0, n_virtual],
    at the pending index's own edges, and where the base position g - p
    is an anchor row's edge +- 1 or 2^31 +- 1."""
    rng = np.random.default_rng(100 + len(fill) + (cap >> 30))
    pcap = 1 << 20
    pfill = {"empty": 0, "half": pcap // 2 + 77, "full": pcap}[fill]
    n = cap - 1000
    pb, blkA, blkB = _card_packed(cap, dev)
    vp = np.full(pcap, INF, np.int64)
    vp[:pfill] = np.sort(rng.integers(0, n, pfill)) + np.arange(pfill)
    psym = np.full(pcap, flat.PAD, np.int8)
    psym[:pfill] = rng.integers(0, 6, pfill)
    prefix = rank.prefix_rows(rank.block_counts(torch.from_numpy(psym), KP),
                              torch.int32).numpy()
    pend = _pend(vp, psym, prefix, pfill, dev)
    nv = n + pfill
    live = vp[:pfill]
    g = np.concatenate([[0, nv], _at_base(vp, pfill, _anchor_edges(n)),
                        live[:4096], live[-4096:] + 1,
                        rng.integers(0, nv + 1, Q_CARD)])[:Q_CARD]
    g = torch.from_numpy(g.astype(np.int64)).to(dev)
    before = rank_cuda.LAUNCHES["rank_virtual_packed"]
    got = rank_cuda.rank_virtual_packed(pb, blkA, blkB, pend, g)
    want = pending.rank_virtual_packed(pb, blkA, blkB, pend, g)
    torch.cuda.synchronize()
    assert rank_cuda.LAUNCHES["rank_virtual_packed"] == before + 1
    assert got.dtype == torch.int64 and torch.equal(got, want)
    g = torch.sort(g).values  # as the engine gives them
    assert torch.equal(rank_cuda.rank_virtual_packed(pb, blkA, blkB, pend, g),
                       pending.rank_virtual_packed(pb, blkA, blkB, pend, g))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["empty", "half", "full"])
def test_rank_pend_kernel_matches_plain(dev, fill):
    rng = np.random.default_rng(60 + len(fill))
    pcap = 1 << 20
    pfill = {"empty": 0, "half": pcap // 2 + 77, "full": pcap}[fill]
    vp, psym, prefix = _pending_np(rng, pcap, pfill)
    pend = _pend(vp, psym, prefix, pfill, dev)
    g = _pending_queries(rng, vp, pfill, Q_CARD)
    g[-1000:] = rng.integers(-5, 0, 1000)
    g = torch.from_numpy(g.astype(np.int64)).to(dev)
    before = rank_cuda.LAUNCHES["rank_pend"]
    p, occ = rank_cuda.pending_rank(pend, g)
    wp, wocc = pending.pending_rank(pend, g)
    torch.cuda.synchronize()
    assert rank_cuda.LAUNCHES["rank_pend"] == before + 1
    assert p.dtype == torch.int64 and occ.dtype == torch.int32
    assert torch.equal(p, wp) and torch.equal(occ, wocc)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [128, 256, 512, 1024])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("fill", ["empty", "half", "full"])
def test_rank_virtual_kernel_matches_plain(dev, K, wide, fill):
    """rank_virtual_kernel == pending.rank_virtual: unclamped at queries in
    [0, n_virtual] and at the pending index's own edges, and clamped to a
    window (the sharded engine's form) at positions -2^40..2^40."""
    rng = np.random.default_rng(80 + K + wide + len(fill))
    pcap = 1 << 20
    pfill = {"empty": 0, "half": pcap // 2 + 77, "full": pcap}[fill]
    cap, n = 1 << 22, (1 << 22) - 777
    buf = torch.from_numpy(_buffer(rng, cap, n)).to(dev)
    tab = rank.build_block_tables(buf, K, torch.int64 if wide
                                  else torch.int32)
    vp = np.full(pcap, INF, np.int64)
    vp[:pfill] = np.sort(rng.integers(0, n, pfill)) + np.arange(pfill)
    psym = np.full(pcap, flat.PAD, np.int8)
    psym[:pfill] = rng.integers(0, 6, pfill)
    prefix = rank.prefix_rows(rank.block_counts(torch.from_numpy(psym), KP),
                              torch.int32).numpy()
    pend = _pend(vp, psym, prefix, pfill, dev)
    nv = n + pfill
    live = vp[:pfill]
    g = np.concatenate([[0, nv], live[:4096], live[-4096:] + 1,
                        rng.integers(0, nv + 1, Q_CARD)])[:Q_CARD]
    g = torch.from_numpy(g.astype(np.int64)).to(dev)
    before = rank_cuda.LAUNCHES["rank_virtual"]
    got = rank_cuda.rank_virtual_flat(buf, tab, pend, g, K)
    want = pending.rank_virtual(buf, tab, pend, g, K)
    torch.cuda.synchronize()
    assert rank_cuda.LAUNCHES["rank_virtual"] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)
    g = _card_positions(rng, nv, buf.shape[0], dev)
    lo, hi = 1000, n - 5000
    got = rank_cuda.rank_virtual_flat(buf, tab, pend, g, K, lo=lo, hi=hi)
    want = pending.rank_virtual(buf, tab, pend, g, K, lo=lo, hi=hi)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    buf = torch.full((1 << 12,), flat.PAD, dtype=torch.int8, device=dev)
    tab = rank.build_block_tables(buf, 128, torch.int32)
    pos = torch.arange(10, device=dev)
    with pytest.raises(ValueError, match="K"):
        rank_cuda.rank_flat(buf, tab, pos, 96)
    with pytest.raises(ValueError, match="K"):
        rank_cuda.rank_flat(buf, tab, pos, 2048)
    with pytest.raises(ValueError, match="pos"):
        rank_cuda.rank_flat(buf, tab, pos.int(), 128)
    with pytest.raises(ValueError, match="prefix"):
        rank_cuda.rank_flat(buf, tab.cpu(), pos, 128)
    with pytest.raises(ValueError, match="prefix dtype"):
        rank_cuda.rank_flat(buf, tab.short(), pos, 128)
    with pytest.raises(ValueError, match="aligned"):
        rank_cuda.rank_flat(buf[1:1 + 2048], tab[:17], pos, 128)
    pend = _pend(*_pending_np(np.random.default_rng(1), 1 << 12, 100), 100,
                 dev)
    with pytest.raises(ValueError, match="g"):
        rank_cuda.pending_rank(pend, pos.cpu())
    with pytest.raises(ValueError, match="K"):
        rank_cuda.rank_virtual_flat(buf, tab, pend, pos, 96)
    with pytest.raises(ValueError, match="clamp"):
        rank_cuda.rank_virtual_flat(buf, tab, pend, pos, 128, lo=5, hi=4)
    shifted_vp = torch.empty(pend.cap + 1, dtype=torch.int64, device=dev)
    shifted_vp[1:] = pend.vp  # 8-byte aligned only
    with pytest.raises(ValueError, match="aligned"):
        rank_cuda.rank_virtual_flat(
            buf, tab, PendingIndex(vp=shifted_vp[1:], psym=pend.psym,
                                   blk_prefix=pend.blk_prefix, p=pend.p),
            pos, 128)
    pb = torch.full((1 << 12,), 0x66, dtype=torch.uint8, device=dev)
    blkA, blkB = packed.build_two_level_tables(pb, 1 << 13)
    with pytest.raises(ValueError, match="g"):
        rank_cuda.rank_virtual_packed(pb, blkA, blkB, pend, pos.cpu())
    with pytest.raises(ValueError, match="blkA"):
        rank_cuda.rank_virtual_packed(pb, blkA.int(), blkB, pend, pos)
    with pytest.raises(ValueError, match="whole packed rows"):
        rank_cuda.rank_virtual_packed(pb[:1000], blkA, blkB, pend, pos)
    with pytest.raises(ValueError, match="aligned"):
        rank_cuda.rank_virtual_packed(pb[1:1 + 2048], blkA, blkB, pend, pos)
    with pytest.raises(ValueError, match="capacity"):
        rank_cuda.rank_virtual_packed(
            pb, blkA, blkB, PendingIndex(vp=pend.vp[:100],
                                         psym=pend.psym[:100],
                                         blk_prefix=pend.blk_prefix,
                                         p=pend.p), pos)
