"""The rank wrappers (ropebwt2_tpu_torch/index/rank_cuda.py) and their
kernels (csrc/rank.cu).

On the CPU a wrapper runs its plain version: each is held here to the JAX
package's rank_global, rank_global_packed and pending_rank on the same
numpy-seeded inputs (int32 and int64 prefixes, K 128 and 256; positions 0,
n and every multiple of 128 +- 1; a pending index empty, half full, full,
and queried at its INF rows).  The call sites of the engine, the queries
and the sharded engine are held to reach the wrappers, so that on the card
they take the kernels and not the plain count.

The tests marked ``cuda`` hold each kernel to its plain version on the
card at 2^16 queries, and skip without a card.  They import no JAX (the
CPU tests import it inside), so they run where JAX is not installed, with
``python -m pytest --noconftest -p no:cacheprovider -m cuda`` on this
file.

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
    """rank_cuda.rank_flat == the JAX rank_global, with sub and extra too:
    rank(pos - sub) + extra."""
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

    sub = rng.integers(0, 50, pos.shape[0]).clip(max=pos)
    extra = rng.integers(0, 1000, (pos.shape[0], 6)).astype(np.int32)
    got = rank_cuda.rank_flat(tb, tab, torch.from_numpy(pos), K,
                              sub=torch.from_numpy(sub),
                              extra=torch.from_numpy(extra))
    want = np.asarray(jrank.rank_global(jb, jtab, jnp.asarray(pos - sub), K))
    assert got.dtype == dt
    assert np.array_equal(got.numpy(), want + extra)


@pytest.mark.parametrize("garbage", [False, True])
def test_rank_packed_matches_jax(garbage):
    """rank_cuda.rank_packed == the JAX rank_global_packed over a packed
    buffer with PAD or any nibble past n, with sub and extra too."""
    import jax.numpy as jnp
    from ropebwt2_tpu.index import packed as jpacked

    rng = np.random.default_rng(20 + garbage)
    cap = 1 << 16
    n = cap - 300
    syms = np.full(cap + packed.PPAD_ROWS * 2 * LANE, flat.PAD, np.int8)
    syms[:n] = rng.integers(0, 6, n)
    if garbage:
        syms[n:] = rng.integers(0, 16, syms.shape[0] - n)
    pb = packed.pack_bwt_np(syms)
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

    sub = rng.integers(0, 50, pos.shape[0]).clip(max=pos)
    extra = rng.integers(0, 1000, (pos.shape[0], 6)).astype(np.int32)
    got = rank_cuda.rank_packed(tpb, blkA, blkB, torch.from_numpy(pos),
                                sub=torch.from_numpy(sub),
                                extra=torch.from_numpy(extra))
    want = np.asarray(jpacked.rank_global_packed(jpb, jA, jB,
                                                 jnp.asarray(pos - sub)))
    assert np.array_equal(got.numpy(), want + extra)


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

    for name in ("rank_flat", "rank_packed", "pending_rank"):
        wrap(rank_cuda, name, name)
    wrap(rank, "rank_global", "plain flat")
    wrap(packed, "rank_global_packed", "plain packed")
    wrap(pending, "pending_rank", "plain pending")
    return calls


def _reads(seed, m):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 5, int(rng.integers(20, 40))).astype(np.int8)
            for _ in range(m)]


@pytest.mark.parametrize("tier", ["flat", "packed"])
def test_engine_and_queries_reach_the_wrappers(tier, monkeypatch):
    """_state_rank_fn (a batch merged every round), rank_virtual_base (a
    deferred batch) and engine/query.py's _base_rank call the wrappers, and
    the plain counts run only from inside them."""
    from ropebwt2_tpu_torch.engine import TorchBwt, query

    calls = _counting(monkeypatch)
    wrapper = "rank_flat" if tier == "flat" else "rank_packed"
    plain = f"plain {tier}"
    tiers = {} if tier == "flat" else {"pack4": 1}
    e = TorchBwt(so=1, K=128, defer_r=0, device="cpu", **tiers)
    e.insert_multi(_reads(1, 64))  # defer_r 0: the base rank every round
    assert calls[wrapper] > 0 and "pending_rank" not in calls
    eng = TorchBwt(so=1, K=128, defer_r=4, device="cpu", **tiers)
    eng.insert_multi(_reads(2, 64))  # deferred: pending, then base
    assert calls["pending_rank"] > 0
    assert calls["pending_rank"] == calls["plain pending"]
    n = calls[wrapper]
    query.rank1a(eng.state, [0, 5, 17])
    assert calls[wrapper] == n + 1
    assert calls[wrapper] == calls[plain]


@pytest.mark.parametrize("defer_r", [0, 4])
def test_sharded_rank_functions_reach_the_wrappers(defer_r, monkeypatch):
    """Both routed rank functions of parallel/sharded.py (merged every
    round; deferred: pending and base) call the wrappers, on a world of
    one."""
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
    for key in (("rank_flat", "pending_rank") if defer_r else
                ("rank_flat",)):
        assert calls[key] > before.get(key, 0), key
    assert calls["rank_flat"] == calls["plain flat"]
    assert calls.get("pending_rank", 0) == calls.get("plain pending", 0)


# ----------------------------------------------------------------- card

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


def _sub_extra(rng, pos, dev):
    sub = torch.from_numpy(rng.integers(0, 300, pos.shape[0])).to(dev)
    extra = torch.from_numpy(rng.integers(-1000, 1000, (pos.shape[0], 6))
                             .astype(np.int32)).to(dev)
    return sub, extra


@pytest.mark.cuda
@pytest.mark.parametrize("K", [128, 256])
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
    sub, extra = _sub_extra(rng, pos, dev)
    got = rank_cuda.rank_flat(buf, tab, pos, K, sub=sub, extra=extra)
    want = rank.rank_global(buf, tab, pos - sub, K) + extra.to(tab.dtype)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1 << 22, (1 << 31) + (1 << 25)])
def test_rank_packed_kernel_matches_plain(dev, cap):
    """Any nibble anywhere (the counts take symbols 0..5 only); at the
    larger cap, positions past 2^31 and anchor rows past the first."""
    rng = np.random.default_rng(50)
    n = cap - 1000
    g = torch.Generator(device=dev).manual_seed(50)
    pb = torch.randint(0, 256, (cap // 2 + packed.PPAD_ROWS * LANE,),
                       dtype=torch.uint8, device=dev, generator=g)
    blkA, blkB = packed.build_two_level_tables(pb, cap)
    pos = _card_positions(rng, n, cap, dev)
    pos[:4096] = torch.from_numpy(rng.integers(max(0, n - (1 << 30)), n + 1,
                                               4096)).to(dev)
    before = rank_cuda.LAUNCHES["rank_packed"]
    got = rank_cuda.rank_packed(pb, blkA, blkB, pos)
    want = packed.rank_global_packed(pb, blkA, blkB, pos)
    torch.cuda.synchronize()
    assert rank_cuda.LAUNCHES["rank_packed"] == before + 1
    assert got.dtype == torch.int64 and torch.equal(got, want)
    sub, extra = _sub_extra(rng, pos, dev)
    got = rank_cuda.rank_packed(pb, blkA, blkB, pos, sub=sub, extra=extra)
    want = packed.rank_global_packed(pb, blkA, blkB, pos - sub) + extra
    assert torch.equal(got, want)


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
