"""TorchBwt (the port's driver, on the CPU) against TpuBwt on the same
numpy-seeded reads: byte-identical bwt_array() and equal counts(), for
every sorting order, merging every round and deferred, over several
batches and every input form.  Exact comparisons (integers)."""

import os
import sys

import numpy as np
import pytest
import torch

from ropebwt2_tpu.engine import TpuBwt

from ropebwt2_tpu_torch.engine import TorchBwt, bcr
from ropebwt2_tpu_torch.index.rank import build_block_tables

from conftest import random_reads

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from readgen import ReadGen  # noqa: E402


def _both(so, defer_r, batches, insert="insert_multi"):
    """Run the same batches through both engines; assert they agree."""
    jax_eng = TpuBwt(so=so, defer_r=defer_r)
    torch_eng = TorchBwt(so=so, defer_r=defer_r, device="cpu")
    for batch in batches:
        getattr(jax_eng, insert)(batch)
        getattr(torch_eng, insert)(batch)
    want = jax_eng.bwt_array()
    got = torch_eng.bwt_array()
    assert got.dtype == np.int8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(torch_eng.counts(), jax_eng.counts())
    assert torch_eng.n == jax_eng.n
    assert torch_eng.runs() == jax_eng.runs()
    return torch_eng


@pytest.mark.parametrize("so", [0, 1, 2])
@pytest.mark.parametrize("defer_r", [0, 4])
def test_ragged_and_uniform_batches_match_jax(so, defer_r):
    """Ragged reads with N in two batches, then a uniform ACGT matrix."""
    rng = np.random.default_rng(so * 10 + defer_r)
    ragged = [np.asarray(r, np.int8)
              for r in random_reads(rng, 300, lo=1, hi=40, with_n=True)]
    uniform = rng.integers(1, 5, size=(120, 33)).astype(np.int8)
    _both(so, defer_r, [ragged[:170], ragged[170:], uniform])


@pytest.mark.parametrize("so,defer_r", [(1, 0), (1, 8), (2, 4)])
def test_coverage_reads_match_jax(so, defer_r):
    """Coverage-shaped reads (shared suffixes keep intervals wide): the
    shape of the benchmark's data, at 3 batches of 200 x 101."""
    gen = ReadGen(seed=so, nreads=600, L=101, mode="coverage", cov=47.0,
                  err=0.01)
    _both(so, defer_r, [gen.batch(200).view(np.int8) for _ in range(3)])


@pytest.mark.parametrize("defer_r", [0, 4])
def test_insert_nul_batch_matches_jax(defer_r):
    rng = np.random.default_rng(21)
    batches = []
    for _ in range(2):
        reads = random_reads(rng, 150, lo=1, hi=30, with_n=True)
        batches.append(np.concatenate(
            [np.append(np.asarray(r, np.int8)[::-1], 0) for r in reads]))
    _both(1, defer_r, batches, insert="insert_nul_batch")


@pytest.mark.parametrize("as_matrix", [False, True])
def test_already_reversed_matches_jax(as_matrix):
    """Reads handed over already reversed, as a list or a matrix."""
    rng = np.random.default_rng(23)
    mat = rng.integers(1, 6, size=(90, 27)).astype(np.int8)[:, ::-1]
    batch = np.ascontiguousarray(mat) if as_matrix else list(mat)
    jax_eng = TpuBwt(so=1, defer_r=0)
    torch_eng = TorchBwt(so=1, defer_r=0, device="cpu")
    jax_eng.insert_multi(batch, already_reversed=True)
    torch_eng.insert_multi(batch, already_reversed=True)
    assert np.array_equal(torch_eng.bwt_array(), jax_eng.bwt_array())


def test_insert1_matches_jax():
    rng = np.random.default_rng(22)
    reads = [np.asarray(r, np.int8)
             for r in random_reads(rng, 6, lo=9, hi=12, with_n=True)]
    _both(2, 0, reads, insert="insert1")


@pytest.mark.parametrize("cap,mpad", [(1 << 10, 16), (1 << 24, 1 << 17),
                                      (147_062_784, 1 << 17),
                                      (1 << 28, 1 << 17), (1 << 31, 1 << 10)])
def test_choose_defer_matches_jax(cap, mpad):
    """Auto deferral picks the same (R, pcap) as the JAX package at every
    capacity, including the benchmark's two regimes (R = 0 at cap 2^24,
    R = 8 at the sustained plan's capacity)."""
    class _State:
        pass

    jax_eng = TpuBwt(so=1, defer_r=-1)
    torch_eng = TorchBwt(so=1, device="cpu")
    jax_eng.state = _State()
    jax_eng.state.cap = cap
    torch_eng.state = _State()
    torch_eng.state.cap = cap
    assert torch_eng._choose_defer(mpad) == jax_eng._choose_defer(mpad)


@pytest.mark.parametrize("extra", [1000, 5 * (1 << 24) + 123])
def test_plan_matches_jax(extra):
    """Incremental growth rounds to a power of two, an upfront plan
    linearly: the same capacities as the JAX package."""
    jax_eng = TpuBwt(so=1)
    torch_eng = TorchBwt(so=1, device="cpu")
    jax_eng._plan(extra)
    torch_eng._plan(extra)
    assert torch_eng.state.cap == jax_eng.state.cap
    assert tuple(torch_eng.state.blk_prefix.shape) == \
        tuple(jax_eng.state.blk_prefix.shape)


@pytest.mark.parametrize("so", [0, 1, 2])
@pytest.mark.parametrize("defer_r", [0, 8])
def test_no_consumer_reads_a_table_row_past_the_live_prefix(so, defer_r,
                                                             monkeypatch):
    """Kernel A leaves the rank table rows past the live end L = n +
    #insertions unspecified.  With every merge's rows past L // K
    overwritten by junk (-1 and 2^30 in turn), a build over four batches,
    each growing the capacity, must still equal the JAX package's byte for
    byte: no consumer (the rank, the pending set's virtual rank, a flush,
    grow_state) reads such a row."""
    real_merge, real_grow = bcr.merge, bcr.grow_state
    poisoned, grown = [], []

    def merge(bwt, pos, sym, stream, valid, n, K):
        out, blk = real_merge(bwt, pos, sym, stream, valid, n, K)
        first = (int(n) + int(valid.sum())) // K + 1
        blk = blk.clone()
        blk[first:] = -1
        blk[first::2] = 1 << 30
        poisoned.append(blk.shape[0] - first)
        return out, blk

    def grow_state(state, new_cap, K):
        grown.append(new_cap)
        return real_grow(state, new_cap, K)

    monkeypatch.setattr(bcr, "merge", merge)
    monkeypatch.setattr(bcr, "grow_state", grow_state)
    rng = np.random.default_rng(40 + so + defer_r)
    batches = [rng.integers(1, 5, (k, 41)).astype(np.int8)
               for k in (30, 70, 150, 300)]
    eng = _both(so, defer_r, batches)
    # a merge a round (42 a batch) or a flush every 8 rounds
    assert len(poisoned) == 4 * (42 if defer_r == 0 else -(-42 // 8))
    assert len(grown) == 4 and all(p > 0 for p in poisoned)
    live = eng.n // 128 + 1
    assert torch.equal(eng.state.blk_prefix[:live], build_block_tables(
        eng.state.bwt, 128, eng.state.blk_prefix.dtype)[:live])
