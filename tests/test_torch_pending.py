"""The port's pending side index (ropebwt2_tpu_torch.index.pending) against
the JAX package's on the same numpy-seeded inputs, on the CPU: the XLA
formulation (int64 positions) and the Pallas kernel in interpret mode
(int32 positions, as tests/test_pending_pallas.py runs it).

Every comparison is exact (integers).  Empty rows hold each package's own
sentinel, so vp is compared on the live rows and checked to be INF past
them."""

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


def test_pending_wrapper_refuses_other_devices():
    dev = torch.device("meta")
    v = torch.empty(1024, dtype=torch.int64, device=dev)
    s = torch.empty(1024, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        pending_cuda.merge(v, s, v, s, torch.empty(2, dtype=torch.int64,
                                                   device=dev),
                           torch.empty((), dtype=torch.int64, device=dev))
