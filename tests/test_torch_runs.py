"""The port's run-length tier (ropebwt2_tpu_torch.index.runs) against the
JAX package's (ropebwt2_tpu.index.runs) on the same numpy-seeded inputs,
on the CPU: the cases of tests/test_runs.py, each compared field by field
(rsym, rend, bstart, bocc, nslot, overflow) with tolerance 0, and against
the plain-sequence oracle.

The chunked expand is forced on both sides by small chunks: the JAX
package's RUNS_BIG / RUNS_CHUNK and the port's EXPAND_CHUNK."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ropebwt2_tpu.index import runs as J

from ropebwt2_tpu_torch.convert import runs_from_numpy
from ropebwt2_tpu_torch.index import runs as T

FIELDS = ("rsym", "rend", "bstart", "bocc", "nslot", "overflow")
# one slot capacity, lane count and query count for every case, so that the
# JAX package's eager operations compile once for the whole module
RCAP, LANES, QUERIES = 3 * J.RCAP_ALIGN, 512, 256


def jstate(seq, rcap=RCAP, bound=1 << 20):
    """The JAX RunBwt of a symbol sequence (its maximal runs)."""
    seq = np.asarray(seq, np.int8)
    if seq.size == 0:
        return J.empty_runs_state(rcap, bound)
    syms, lens = maximal_runs(seq)
    return J.runs_from_arrays(syms, lens, rcap, bound, seq.size,
                              np.zeros(6), np.zeros((6, 6)))


def maximal_runs(seq):
    change = np.flatnonzero(np.diff(seq)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [seq.size]])
    return seq[starts], (ends - starts).astype(np.int64)


def carry(js):
    """The port's RunBwt of a JAX one (convert.runs_from_numpy)."""
    return runs_from_numpy(*(np.asarray(getattr(js, f.name))
                             for f in dataclasses.fields(js)), "cpu")


def assert_same(ts, js):
    for f in FIELDS:
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert got.dtype == want.dtype, f
        assert np.array_equal(got, want), f


def brute_rank(seq, g):
    return np.stack([np.bincount(seq[:q], minlength=6)[:6] for q in g]) \
        if len(g) else np.zeros((0, 6), np.int64)


def oracle_insert(seq, pos, sym, stream, valid):
    """Plain-sequence insertion (the contract of index/merge.py)."""
    order = sorted(np.flatnonzero(valid), key=lambda i: stream[i])
    out = list(seq)
    for k, i in enumerate(order):
        out.insert(int(pos[i]) + k, int(sym[i]))
    return np.asarray(out, np.int8)


def apply_both(js, ts, pos, sym, stream, valid):
    pad = LANES - pos.shape[0]  # invalid lanes up to the common count
    pos, sym, stream = (np.pad(x, (0, pad)) for x in (pos, sym, stream))
    valid = np.pad(valid, (0, pad))
    upd = J.apply_insertions_runs(js, jnp.asarray(pos),
                                  jnp.asarray(sym, jnp.int32),
                                  jnp.asarray(stream), jnp.asarray(valid))
    js = dataclasses.replace(js, n=js.n + int(valid.sum()), **upd)
    upd = T.apply_insertions_runs(
        ts, *(torch.from_numpy(x) for x in (pos, sym, stream, valid)))
    ts = dataclasses.replace(ts, n=ts.n + int(valid.sum()), **upd)
    return js, ts


def check(js, ts, seq):
    """Both states equal field by field, spell ``seq`` and rank it."""
    assert_same(ts, js)
    syms, lens = T.runs_to_host(ts)
    jsyms, jlens = J.runs_to_host(js)
    assert np.array_equal(syms, jsyms) and np.array_equal(lens, jlens)
    assert lens.dtype == jlens.dtype and (lens > 0).all()
    assert np.array_equal(np.repeat(syms, lens), seq)
    assert int(ts.overflow) == 0
    g = np.linspace(0, seq.size, QUERIES).astype(np.int64)
    occ = T.rank_global_runs(ts.rend, ts.rsym, ts.bstart, ts.bocc,
                             torch.from_numpy(g))
    assert np.array_equal(occ.numpy(), brute_rank(seq, g))


def lanes(rng, m, a, n, scattered=True, lo=0):
    """m lanes with a valid ones (scattered over the batch, or first):
    sorted points in [lo, n], tie ranks in order, random symbols."""
    rows = np.sort(rng.choice(m, a, replace=False)) if scattered \
        else np.arange(a)
    pos, sym, stream = (np.zeros(m, np.int64) for _ in range(3))
    valid = np.zeros(m, bool)
    pos[rows] = np.sort(rng.integers(lo, n + 1, a))
    sym[rows] = rng.integers(0, 6, a)
    stream[rows] = np.arange(a)
    valid[rows] = True
    return pos, sym, stream, valid


def test_searchsorted_le_value_matches_torch():
    """The JAX descent, which the port's rank replaces by one
    torch.searchsorted: the same counts, and the value at each."""
    rng = np.random.default_rng(0)
    arr = np.sort(rng.integers(0, 1000, J.RCAP_ALIGN).astype(np.int32))
    arr[-100:] = np.iinfo(np.int32).max - (1 << 28)
    g = rng.integers(-5, 1100, 257).astype(np.int32)
    jcnt, jval = J.searchsorted_le_value(jnp.asarray(arr), jnp.asarray(g))
    want = torch.searchsorted(torch.from_numpy(arr), torch.from_numpy(g),
                              right=True).numpy()
    assert np.array_equal(np.asarray(jcnt), want)
    nz = want > 0
    assert np.array_equal(np.asarray(jval)[nz], arr[want[nz] - 1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_parity(seed):
    rng = np.random.default_rng(seed)
    seq = np.repeat(rng.integers(0, 6, 500),
                    rng.integers(1, 20, 500)).astype(np.int8)
    js = jstate(seq)
    ts = carry(js)
    g = np.concatenate([[0, 1, len(seq) - 1, len(seq)], rng.integers(
        0, len(seq) + 1, QUERIES - 4)]).astype(np.int64)
    got = T.rank_global_runs(ts.rend, ts.rsym, ts.bstart, ts.bocc,
                             torch.from_numpy(g))
    want = J.rank_global_runs(js.rend, js.rsym, js.bstart, js.bocc,
                              jnp.asarray(g))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), brute_rank(seq, g))


def test_rank_empty_state():
    js = J.empty_runs_state(RCAP, 1 << 20)
    ts = T.empty_runs_state(RCAP, 1 << 20, "cpu")
    assert_same(ts, js)
    g = torch.zeros(4, dtype=torch.int64)
    assert (T.rank_global_runs(ts.rend, ts.rsym, ts.bstart, ts.bocc,
                               g) == 0).all()


# each case: (the initial sequence, [round(rng, current sequence) ->
# (pos, sym, stream, valid), ...])
def _random_rounds(rng):
    seq = np.repeat(rng.integers(0, 6, 60),
                    rng.integers(1, 8, 60)).astype(np.int8)
    return seq, [lambda r, s: lanes(r, 64, int(r.integers(1, 64)), s.size)
                 ] * 4


def _empty_and_dups(rng):
    del rng
    first = (np.zeros(8, np.int64), np.array([3, 3, 3, 1, 1, 4, 4, 4]),
             np.arange(8), np.ones(8, bool))
    # end inserts and interior extends and splits on the 8 symbols
    second = (np.array([0, 1, 1, 3, 8, 8]), np.array([3, 3, 2, 1, 5, 5]),
              np.arange(6), np.ones(6, bool))
    return np.zeros(0, np.int8), [lambda r, s: first, lambda r, s: second]


def _heavy_extends(rng):
    del rng

    def extends(r, s):  # mostly the host run's own symbol
        pos = np.sort(r.integers(1, 199, 32))
        return pos, s[np.minimum(pos, s.size - 1)].astype(np.int64), \
            np.arange(32), np.ones(32, bool)

    return np.repeat([1, 2, 3, 4], 50).astype(np.int8), [extends]


def _growth_multiblock(rng):
    seq = rng.integers(0, 6, 700).astype(np.int8)  # many runs, 6 blocks
    return seq, [lambda r, s: lanes(r, 100, 100, s.size, False)] * 3


CASES = {
    **{f"random-{s}": (_random_rounds, s) for s in range(4)},
    "empty-and-dups": (_empty_and_dups, 0),
    "heavy-extends": (_heavy_extends, 5),
    "growth-multiblock": (_growth_multiblock, 9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_insertions_match_jax(case):
    """Rounds of insertions (the cases of tests/test_runs.py): after each,
    the port's state equals the JAX state field by field and spells the
    oracle's sequence."""
    make, seed = CASES[case]
    rng = np.random.default_rng(seed)
    seq, rounds = make(rng)
    js = jstate(seq)
    ts = carry(js)
    for make_round in rounds:
        ins = [np.asarray(x, dtype=bool if i == 3 else np.int64)
               for i, x in enumerate(make_round(rng, seq))]
        js, ts = apply_both(js, ts, *ins)
        seq = oracle_insert(seq, *ins)
        check(js, ts, seq)
    if case == "heavy-extends":  # extends make no slots beyond splits
        assert int(ts.nslot) <= int(jstate(np.repeat([1, 2, 3, 4], 50))
                                    .nslot) + 64


@pytest.mark.parametrize("chunk", [4096, 6000])
def test_chunked_expand_matches_jax(chunk, monkeypatch):
    """The expand in chunks (the port's EXPAND_CHUNK, ragged when it does
    not divide rcap) against the JAX package's chunked in-place ladder and
    the oracle, with items clustered at the top chunk in one trial."""
    monkeypatch.setattr(J, "RUNS_BIG", 1)
    monkeypatch.setattr(J, "RUNS_CHUNK", J.RCAP_ALIGN)
    monkeypatch.setattr(T, "EXPAND_CHUNK", chunk)
    rng = np.random.default_rng(17)
    for trial, nseq in enumerate((200, 2000, 16000, 40000)):
        seq = np.repeat(rng.integers(0, 6, nseq),
                        rng.integers(1, 4, nseq)).astype(np.int8)
        js = jstate(seq)
        ts = carry(js)
        m = LANES
        ins = lanes(rng, m, int(rng.integers(m // 2, m)), seq.size,
                    scattered=False, lo=seq.size - 50 if trial == 2 else 0)
        js, ts = apply_both(js, ts, *ins)
        check(js, ts, oracle_insert(seq, *ins))


@pytest.mark.parametrize("bound", [1 << 20, 1 << 32])
def test_runs_from_arrays_grow_and_to_host(bound):
    """runs_from_arrays (int32 and int64 tables), grow_runs_state and
    runs_to_host against the JAX functions; rank over the int64 tables."""
    rng = np.random.default_rng(bound & 7)
    seq = np.repeat(rng.integers(0, 6, 3000),
                    rng.integers(1, 9, 3000)).astype(np.int8)
    syms, lens = maximal_runs(seq)
    psize = rng.integers(0, 100, 6)
    pcounts = rng.integers(0, 100, (6, 6))
    js = J.runs_from_arrays(syms, lens, J.RCAP_ALIGN, bound, seq.size,
                            psize, pcounts)
    ts = T.runs_from_arrays(syms, lens, T.RCAP_ALIGN, bound, seq.size,
                            psize, pcounts, device="cpu")
    assert_same(ts, js)
    assert ts.bstart.dtype == (torch.int32 if bound < 1 << 30
                               else torch.int64)
    assert ts.cap == js.cap and ts.rcap == js.rcap
    for f in ("n", "psize", "pcounts"):
        assert np.array_equal(getattr(ts, f).numpy(),
                              np.asarray(getattr(js, f)))
    js = J.grow_runs_state(js, 3 * J.RCAP_ALIGN)
    ts = T.grow_runs_state(ts, 3 * T.RCAP_ALIGN)
    assert_same(ts, js)
    for got, want in zip(T.runs_to_host(ts), J.runs_to_host(js)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    g = torch.from_numpy(np.sort(rng.integers(0, seq.size + 1, 300)))
    assert np.array_equal(
        T.rank_global_runs(ts.rend, ts.rsym, ts.bstart, ts.bocc, g).numpy(),
        brute_rank(seq, g.numpy()))
    assert T.gdt_for_symbols(bound) == (
        torch.int32 if J.gdt_for_symbols(bound) == jnp.int32 else torch.int64)
    with pytest.raises(ValueError):
        T.runs_from_arrays(syms, np.where(lens > 4, T.RUN_LEN_MAX, lens),
                           T.RCAP_ALIGN, bound, seq.size, psize, pcounts,
                           device="cpu")


def test_constants_and_sentinel_match_jax():
    assert (T.KR, T.RUN_LEN_MAX, T.RCAP_ALIGN) == \
        (J.KR, J.RUN_LEN_MAX, J.RCAP_ALIGN)
    for tdt, jdt in ((torch.int32, jnp.int32), (torch.int64, jnp.int64)):
        assert T._inf(tdt) == int(J._inf(jdt))
    assert (T.RCAP_BIG, T.RCAP_BIG_ALIGN) == (1 << 26, J.RUNS_CHUNK)
