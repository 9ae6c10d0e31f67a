"""The port's FM-index queries (ropebwt2_tpu_torch.engine.query) on the
CPU: the cases of tests/test_query.py on the port's own builds (rank
against numpy, backward-search counts against a brute-force count, extend
against search, forward symmetry), and every query function against its
JAX counterpart on the same index, carried over with convert.py, on the
flat tier at K = 16, 128 and 256 and on the packed tier, at so 0, 1 and 2.

Tolerance: exact (integers).  The JAX functions return int32 below 2^31
and the port int64, so values are compared, not dtypes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ropebwt2_tpu.engine import TpuBwt
from ropebwt2_tpu.engine import query as jq

from ropebwt2_tpu_torch.convert import flat_from_numpy, packed_from_numpy
from ropebwt2_tpu_torch.engine import TorchBwt
from ropebwt2_tpu_torch.engine import query as tq

from conftest import random_reads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's many small torch ops on one thread: with every
    core busy (the suite runs on parallel workers) the intra-op pool's
    spinning threads slow each op by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(reads, so=0, K=16, pack4=0):
    eng = TorchBwt(so=so, K=K, device="cpu", pack4=pack4)
    eng.insert_multi(reads)
    return eng


def _carry(jstate):
    """The port's state of a JAX index (flat or packed)."""
    if hasattr(jstate, "pbwt"):
        return packed_from_numpy(
            np.asarray(jstate.pbwt), int(jstate.n), np.asarray(jstate.psize),
            np.asarray(jstate.pcounts), np.asarray(jstate.blkA),
            np.asarray(jstate.blkB), "cpu")
    return flat_from_numpy(
        np.asarray(jstate.bwt), int(jstate.n), np.asarray(jstate.psize),
        np.asarray(jstate.pcounts), np.asarray(jstate.blk_prefix), "cpu")


def _patterns(rng, q, lmax):
    """(q, lmax) right-aligned random ACGT patterns and their lengths."""
    lens = rng.integers(1, lmax + 1, q)
    mat = np.zeros((q, lmax), np.int32)
    for i, ln in enumerate(lens):
        mat[i, lmax - ln:] = rng.integers(1, 5, ln)
    return mat, lens.astype(np.int32)


def _count_occurrences(reads, pat):
    pat = list(pat)
    k = len(pat)
    return sum(list(r[i: i + k]) == pat
               for r in reads for i in range(len(r) - k + 1))


def _eq(t, j):
    assert np.array_equal(t.numpy(), np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("pack4", [0, 1])
def test_rank_matches_numpy(rng, pack4):
    reads = random_reads(rng, n=30, with_n=True)
    eng = _port(reads, K=128 if pack4 else 16, pack4=pack4)
    bwt = eng.bwt_array()
    pos = np.sort(rng.integers(0, len(bwt) + 1, size=40))
    occ = tq.rank1a(eng.state, pos).numpy()
    want = np.stack([(bwt[None, :] == s).cumsum(1)[0] for s in range(6)], 1)
    want = np.concatenate([np.zeros((1, 6), np.int64), want])
    assert np.array_equal(occ, want[pos])
    ox, oy = tq.rank2a(eng.state, pos, pos)
    assert torch.equal(ox, oy)
    c = rng.integers(0, 6, len(pos))
    assert np.array_equal(tq.rank11(eng.state, pos, c).numpy(),
                          want[pos, c])


@pytest.mark.parametrize("pack4", [0, 1])
def test_backward_search_counts(rng, pack4):
    reads = random_reads(rng, n=40, lo=8, hi=20)
    eng = _port(reads, K=128 if pack4 else 16, pack4=pack4)
    mat, lens = _patterns(rng, 25, 4)
    lo, hi = tq.backward_search(eng.state, mat, lens)
    for i in range(len(lens)):
        p = mat[i, mat.shape[1] - lens[i]:]
        assert int(hi[i] - lo[i]) == _count_occurrences(reads, p), p


def test_extend_backward_matches_search(rng):
    """One extend step from the whole-BWT interval is one backward-search
    step: the interval of pattern 'a'."""
    reads = random_reads(rng, n=30)
    eng = _port(reads)
    n = eng.n
    ok = tq.extend(eng.state, [[0, 0, n]], is_back=True)[0].numpy()
    bwt = eng.bwt_array()
    csum = np.concatenate([[0], np.cumsum(np.bincount(bwt, minlength=6))])
    assert np.array_equal(ok[:, 0], csum[:6])
    assert np.array_equal(ok[:, 2], np.diff(csum))
    assert ok[:, 2].sum() == n
    # and the backward search of every single symbol gives the same rows
    lo, hi = tq.backward_search(eng.state, np.arange(6)[:, None], [1] * 6)
    assert np.array_equal(lo.numpy(), ok[:, 0])
    assert np.array_equal((hi - lo).numpy(), ok[:, 2])


def test_extend_forward_symmetry(rng):
    """Forward extension sizes on a both-strands index mirror backward
    extension (the bidirectional FM property)."""
    reads = random_reads(rng, n=20)
    both = []
    for r in reads:
        both.append(r)
        both.append([5 - c if 1 <= c <= 4 else c for c in reversed(r)])
    eng = _port(both)
    ik = [[0, 0, eng.n]]
    okb = tq.extend(eng.state, ik, is_back=True)[0].numpy()
    okf = tq.extend(eng.state, ik, is_back=False)[0].numpy()
    assert np.array_equal(okb[:, 2], okf[:, 2])
    assert okf[0, 1] == 0


def test_run_tier_waits_for_its_port():
    """The run tier is ported: its index answers rank as the flat one
    does.  A state of no tier raises TypeError."""
    rng = np.random.default_rng(5)
    reads = random_reads(rng, 40, lo=3, hi=30)
    runs = TorchBwt(so=1, device="cpu", runs=1)
    runs.insert_multi(reads)
    flat = _port(reads, so=1)
    pos = np.arange(0, flat.n + 1)
    assert torch.equal(tq.rank1a(runs.state, pos), tq.rank1a(flat.state, pos))

    class RunBwt:
        n = torch.zeros((), dtype=torch.int64)
        pcounts = torch.zeros((6, 6), dtype=torch.int64)

    with pytest.raises(TypeError, match="not an index state"):
        tq.rank1a(RunBwt(), [0])


@pytest.mark.parametrize("so", [0, 1, 2])
@pytest.mark.parametrize("K", [16, 128, 256])
def test_flat_queries_match_jax(K, so):
    check_against_jax(K, so, pack4=False)


def check_against_jax(K, so, pack4, monkeypatch=None):
    """Every query function of the port against the JAX one on the same
    index (a TpuBwt build carried over), at random positions, intervals,
    bi-intervals and patterns."""
    rng = np.random.default_rng(100 * K + so)
    reads = random_reads(rng, 120, lo=5, hi=40, with_n=True)
    if pack4:
        monkeypatch.setenv("ROPEBWT2_TPU_PACK4", "1")
    jeng = TpuBwt(so=so, K=K, defer_r=0)
    jeng.insert_multi(reads)
    js = jeng.state
    assert hasattr(js, "pbwt") == bool(pack4)
    ts = _carry(js)
    n = jeng.n
    Kq = None if pack4 else K  # the JAX packed tier derives its own K

    pos = np.sort(rng.integers(0, n + 1, 300))
    jpos = jnp.asarray(pos)
    _eq(tq.rank1a(ts, pos), jq.rank1a(js, jpos, K=Kq))
    y = np.minimum(pos + rng.integers(0, 200, pos.size), n)
    for t, j in zip(tq.rank2a(ts, pos, y),
                    jq.rank2a(js, jpos, jnp.asarray(y), K=Kq)):
        _eq(t, j)
    c = rng.integers(0, 6, pos.size)
    _eq(tq.rank11(ts, pos, c), jq.rank11(js, jpos, jnp.asarray(c), K=Kq))
    for t, j in zip(tq.rank21(ts, pos, y, c),
                    jq.rank21(js, jpos, jnp.asarray(y), jnp.asarray(c),
                              K=Kq)):
        _eq(t, j)

    # bi-intervals: the root, and the children of two backward steps
    ik = np.array([[0, 0, n]], np.int64)
    for _ in range(2):
        ok = tq.extend(ts, ik, is_back=True).numpy()
        _eq(torch.from_numpy(ok), jq.extend(js, jnp.asarray(ik), is_back=True,
                                            K=Kq))
        ik = ok.reshape(-1, 3)
    for back in (True, False):
        _eq(tq.extend(ts, ik, is_back=back),
            jq.extend(js, jnp.asarray(ik), is_back=back, K=Kq))

    mat, lens = _patterns(rng, 200, 9)
    # and substrings of the reads, which occur
    for i, r in enumerate(reads[:100]):
        ln = min(len(r), int(lens[i]))
        mat[i] = 0
        mat[i, 9 - ln:] = r[:ln]
        lens[i] = ln
    lo, hi = tq.backward_search(ts, mat, lens)
    jlo, jhi = jq.backward_search(js, jnp.asarray(mat), jnp.asarray(lens),
                                  K=Kq)
    _eq(lo, jlo)
    _eq(hi, jhi)
    assert ((hi - lo)[:100] >= 1).all()
