"""The port's pending side index (ropebwt2_tpu_torch.index.pending) against
the JAX package's on the same numpy-seeded inputs, on the CPU: the XLA
formulation (int64 positions) and the Pallas kernel in interpret mode
(int32 positions, as tests/test_pending_pallas.py runs it).

Every comparison is exact (integers).  Empty rows hold each package's own
sentinel, so vp is compared on the live rows and checked to be INF past
them.

The port keeps two plane pairs and writes them in turn, only the
4096-row blocks that can hold live rows (pending.py's module docstring);
the chained tests hold that against the JAX package's functional
pending_add on every row of the capacity, across a flush."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ropebwt2_tpu.index import pending as jp
from ropebwt2_tpu.index.rank import build_block_tables as jbuild

from ropebwt2_tpu_torch.convert import pending_from_numpy
from ropebwt2_tpu_torch.index import pending as tp
from ropebwt2_tpu_torch.index import pending_cuda

NMAX = 1 << 24  # virtual positions drawn below this


def _pending_np(rng, pcap, pfill, dtype):
    vp = np.full(pcap, np.asarray(jp._inf(dtype)), dtype)
    vp[:pfill] = np.sort(rng.integers(0, NMAX - pfill, pfill)) \
        + np.arange(pfill)  # strictly increasing
    psym = np.full(pcap, 6, np.int8)
    psym[:pfill] = rng.integers(0, 6, pfill)
    return vp, psym


def _jax_pending(vp, psym, pfill):
    j = jnp.asarray(psym)
    return jp.PendingIndex(vp=jnp.asarray(vp), psym=j,
                           blk_prefix=jbuild(j, jp.KP, dtype=jnp.int32),
                           p=jnp.asarray(pfill, jnp.int32))


def _torch_pending(jpend):
    return pending_from_numpy(np.asarray(jpend.vp), np.asarray(jpend.psym),
                              np.asarray(jpend.blk_prefix), int(jpend.p),
                              "cpu")


def _round(rng, m, a, dtype):
    """m lanes, the first a active: sorted insertion points, tie ranks."""
    gX = np.zeros(m, dtype)
    gX[:a] = np.sort(rng.integers(0, NMAX, a))
    stream = np.zeros(m, dtype)
    stream[:a] = np.arange(a)
    sym = rng.integers(0, 6, m).astype(np.int32)
    return gX, sym, stream, np.arange(m) < a


def _assert_same(got, want, live_rows):
    p = int(want.p)
    assert int(got.p) == p
    assert np.array_equal(got.vp.numpy()[:p], np.asarray(want.vp)[:p])
    assert (got.vp.numpy()[p:] == tp.INF).all()
    assert np.array_equal(got.psym.numpy(), np.asarray(want.psym))
    assert np.array_equal(got.blk_prefix.numpy()[:live_rows],
                          np.asarray(want.blk_prefix)[:live_rows])


def _add_both(jpend, gX, sym, stream, active):
    want = jp.pending_add(jpend, jnp.asarray(gX), jnp.asarray(sym),
                          jnp.asarray(stream), jnp.asarray(active))
    got = tp.pending_add(
        _torch_pending(jpend), torch.from_numpy(gX.astype(np.int64)),
        torch.from_numpy(sym.astype(np.int64)),
        torch.from_numpy(stream.astype(np.int64)), torch.from_numpy(active))
    return got, want


@pytest.mark.parametrize("frac", [0.0, 0.3, 0.9])
def test_pending_add_matches_jax(frac):
    rng = np.random.default_rng(int(frac * 10))
    pcap, m = 1 << 14, 2048
    pfill = int(pcap * frac)
    jpend = _jax_pending(*_pending_np(rng, pcap, pfill, np.int64), pfill)
    a = min(m - 100, pcap - pfill)
    got, want = _add_both(jpend, *_round(rng, m, a, np.int64))
    _assert_same(got, want, pcap // tp.KP + 1)  # every row is exact here


@pytest.mark.parametrize("seed,frac", [(0, 0.3), (1, 0.0), (2, 0.9)])
def test_pending_add_matches_pallas_interpret(seed, frac):
    """The port's pending_add on CPU tensors (the plain ladder behind the
    kernel wrapper) against the TPU kernel path run in interpret mode."""
    rng = np.random.default_rng(seed)
    pcap, m = 1 << 17, 4096  # one kernel super-block
    pfill = int(pcap * frac)
    jpend = _jax_pending(*_pending_np(rng, pcap, pfill, np.int32), pfill)
    a = int(rng.integers(m // 2, m))
    gX, sym, stream, active = _round(rng, m, a, np.int32)

    ja = jnp.asarray(active)
    k = jp.searchsorted_blocked(
        jpend.vp, jnp.where(ja, jnp.asarray(gX), jp._inf(jnp.int32)))
    slot = jnp.where(ja, jnp.asarray(stream) + k, pcap)
    sarr = jnp.zeros((pcap,), jnp.int8).at[slot].set(
        jnp.asarray((sym + 1).astype(np.int8)), mode="drop",
        unique_indices=True)
    varr = jnp.zeros((pcap,), jnp.int32).at[slot].set(
        jnp.asarray(gX + stream, dtype=jnp.int32), mode="drop",
        unique_indices=True)
    want = jp._pending_add_pallas(jpend, varr, sarr, ja, interpret=True)

    got = tp.pending_add(
        _torch_pending(jpend), torch.from_numpy(gX.astype(np.int64)),
        torch.from_numpy(sym.astype(np.int64)),
        torch.from_numpy(stream.astype(np.int64)), torch.from_numpy(active))
    _assert_same(got, want, (pfill + a) // tp.KP + 1)


def test_pending_rank_matches_jax():
    rng = np.random.default_rng(5)
    pcap, pfill = 1 << 14, 5000
    jpend = _jax_pending(*_pending_np(rng, pcap, pfill, np.int64), pfill)
    vp = np.asarray(jpend.vp)
    g = np.concatenate([[0, NMAX], vp[:50], vp[:50] + 1,
                        rng.integers(0, NMAX, 500)]).astype(np.int64)
    jpos, jocc = jp.pending_rank(jpend, jnp.asarray(g))
    tpos, tocc = tp.pending_rank(_torch_pending(jpend), torch.from_numpy(g))
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    assert np.array_equal(tocc.numpy(), np.asarray(jocc))


def test_pending_flush_args_match_jax():
    rng = np.random.default_rng(6)
    pcap, pfill = 1 << 12, 1234
    jpend = _jax_pending(*_pending_np(rng, pcap, pfill, np.int64), pfill)
    want = jp.pending_flush_args(jpend)
    got = tp.pending_flush_args(_torch_pending(jpend))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_pending_from_numpy_carries_an_int32_index():
    """A JAX pending index with int32 positions (its int32 sentinel on the
    empty rows) carried into the port goes on exactly as in JAX."""
    rng = np.random.default_rng(8)
    pcap, m = 1 << 13, 1024
    jpend = _jax_pending(*_pending_np(rng, pcap, 3000, np.int32), 3000)
    jpend = jp.pending_add(jpend, *map(jnp.asarray,
                                       _round(rng, m, 900, np.int32)))
    got, want = _add_both(jpend, *_round(rng, m, 1000, np.int32))
    _assert_same(got, want, pcap // tp.KP + 1)


@pytest.mark.parametrize("m,R", [(16, 4), (1 << 10, 8), (1 << 17, 8),
                                 (1 << 17, 3)])
def test_pending_cap_matches_jax(m, R):
    assert tp.pending_cap(m, R) == jp.pending_cap(m, R)


def _lanes(rng, m, a):
    gX, sym, stream, active = _round(rng, m, a, np.int64)
    return gX, sym.astype(np.int64), stream, active


def _chain(rng, pcap, m, R, reset=tp.reset_pending):
    """R rounds, a flush (both packages' reset_pending), R more rounds:
    after every round the port's index equals the JAX package's on all
    pcap rows (vp as int64, psym, blk_prefix, p), its tail holds INF/PAD,
    and its bound is rows per round times rounds since the flush."""
    want = jp.empty_pending(pcap, jnp.int64)
    got = tp.empty_pending(pcap, "cpu")
    assert got.bound == 0 and got.spare is not None
    for r in range(2 * R):
        if r == R:
            want, got = jp.reset_pending(want), reset(got)
            assert int(got.p) == 0 and not got.blk_prefix.any()
        lanes = _lanes(rng, m, int(rng.integers(m // 2, m + 1)))
        want = jp.pending_add(want, *map(jnp.asarray, lanes))
        got = tp.pending_add(got, *map(torch.from_numpy, lanes))
        assert got.bound == min(pcap, (r % R + 1) * m)
        assert int(got.p) <= got.bound
        _assert_same(got, want, pcap // tp.KP + 1)
        assert (got.psym.numpy()[int(got.p):] == 6).all()


@pytest.mark.parametrize("pcap,m,R", [(4 * 4096, 1024, 6),
                                      (2 * 4096 + 256, 512, 5),
                                      (3 * 4096, 4096, 3)])
def test_pending_ping_pong_matches_jax(pcap, m, R):
    _chain(np.random.default_rng(pcap + R), pcap, m, R)


def test_pending_chain_catches_a_reset_that_forgets_the_spare_planes():
    """The chained comparison is what guards the ping-pong hygiene: with a
    reset that refills only the planes that hold the rows, the first merge
    after the flush writes into a spare pair whose rows past the written
    block (here over 5000 rows were live, and one block is written) still
    hold the rows of before the flush."""
    def forgetful(pend):
        kept = tuple(x.clone() for x in pend.spare)
        new = tp.reset_pending(pend)
        for dst, src in zip(new.spare, kept):
            dst.copy_(src)
        return new

    with pytest.raises(AssertionError):
        _chain(np.random.default_rng(3), 4 * 4096, 1024, 8, reset=forgetful)


def test_pending_add_without_spare_planes_takes_fresh_ones():
    """An index carried in without spare planes or a bound (convert.py):
    the first merge writes every block of fresh planes, the next ones turn
    between those and the carried planes."""
    rng = np.random.default_rng(12)
    pcap, m = 2 * 4096, 512
    want = _jax_pending(*_pending_np(rng, pcap, 3000, np.int64), 3000)
    got = _torch_pending(want)
    assert got.spare is None and got.bound is None
    carried = got.vp
    for r in range(3):
        lanes = _lanes(rng, m, m - 7)
        want = jp.pending_add(want, *map(jnp.asarray, lanes))
        got = tp.pending_add(got, *map(torch.from_numpy, lanes))
        assert got.bound == pcap
        assert (got.vp is carried) == (r == 1)
        _assert_same(got, want, pcap // tp.KP + 1)


@pytest.mark.parametrize("bound", [0, 1, 4096, 4097, 3 * 4096, None])
def test_merge_rows_with_a_bound_leaves_the_rows_past_its_blocks(bound):
    """merge_rows (and pending_cuda.merge on the CPU) writes the blocks
    below ceil(bound / 4096) * 4096 of the planes it is given and nothing
    past them; the count rows past them are 0."""
    rng = np.random.default_rng(21)
    pcap, m, pfill, a = 4 * 4096, 512, 300, 400
    pend = _torch_pending(_jax_pending(
        *_pending_np(rng, pcap, pfill, np.int64), pfill))
    args = (pend.vp, pend.psym,
            *tp.new_rows(pend, *map(torch.from_numpy, _lanes(rng, m, a))))
    full = tp.merge_rows(*args, pending_cuda.fresh_planes(pcap, "cpu"))
    junk = (torch.from_numpy(rng.integers(0, 1 << 40, pcap)),
            torch.from_numpy(rng.integers(0, 6, pcap).astype(np.int8)))
    hi = pcap if bound is None else -(-bound // 4096) * 4096
    for fn in (tp.merge_rows, pending_cuda.merge):
        planes = tuple(x.clone() for x in junk)
        vp, psym, rows = fn(*args, planes, bound)
        assert vp is planes[0] and psym is planes[1]
        assert torch.equal(vp[:hi], full[0][:hi])
        assert torch.equal(psym[:hi], full[1][:hi])
        assert torch.equal(vp[hi:], junk[0][hi:])
        assert torch.equal(psym[hi:], junk[1][hi:])
        assert torch.equal(rows[: hi // tp.KP], full[2][: hi // tp.KP])
        assert not rows[hi // tp.KP:].any()


def test_pending_wrapper_refuses_other_devices():
    dev = torch.device("meta")
    v = torch.empty(1024, dtype=torch.int64, device=dev)
    s = torch.empty(1024, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        pending_cuda.merge(v, s, v, s, torch.empty(2, dtype=torch.int64,
                                                   device=dev),
                           torch.empty((), dtype=torch.int64, device=dev))
