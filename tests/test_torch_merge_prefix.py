"""Kernel A's wrapper (ropebwt2_tpu_torch/index/merge_cuda.py) as its
steps, on the CPU, against the JAX package's merge_pallas run in interpret
mode on the same numpy-seeded inputs: insertion_map -> block_prefix ->
run_kernel (the kernel's plain version merge_blocks, which returns the
128-symbol rank prefix) -> tables (that prefix's rows at multiples of K),
and merge() itself.

Tolerance 0 (integers).  Both packages leave the buffer past the live end
L = n + #insertions and the table rows past L // K unspecified, so the
buffer is compared on [0, L) and the tables on rows 0 .. L // K."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ropebwt2_tpu.index import rank as jrank
from ropebwt2_tpu.index.merge_pallas import merge_pallas

from ropebwt2_tpu_torch.index import merge_cuda
from ropebwt2_tpu_torch.index.flat import PAD, PAD_TAIL

CAP, M = 131072, 512  # merge_pallas needs cap % 131072 == 0
BS = merge_cuda.BS


def _inputs(case, seed):
    """(buf, pos, sym, stream, valid, n) as numpy arrays: a live prefix of
    n symbols and garbage past it, and M sorted insertion lanes."""
    rng = np.random.default_rng(seed)
    n = {"n0": 0, "dense": 40_000}.get(case, CAP - M - 999)
    buf = rng.integers(-128, 128, CAP + PAD_TAIL).astype(np.int8)
    buf[n:] = np.where(rng.random(CAP + PAD_TAIL - n) < 0.5, PAD, buf[n:])
    buf[:n] = rng.integers(0, 6, n)
    a = M - 7
    pos = np.zeros(M, np.int64)
    pos[:a] = np.sort(rng.integers(0, n + 1, a))
    if case == "dense":  # CTAs that are all insertions, then a few spread
        pos[: a - 40] = 4096 * 3 + 5
        pos[:a] = np.sort(pos[:a])
    stream = np.where(np.arange(M) < a, np.arange(M), 0)
    valid = np.arange(M) < a
    return buf, pos, rng.integers(0, 6, M), stream, valid, n


def _composed(buf, pos, sym, stream, valid, n, K, dtype):
    """merge()'s steps one by one on CPU tensors."""
    t = [torch.from_numpy(np.asarray(x)) for x in (buf, pos, sym, stream,
                                                   valid, n)]
    bwt, pos, sym, stream, valid, nt = t
    nb = -(-bwt.shape[0] // BS)
    dest, insmap = merge_cuda.insertion_map(pos, sym, stream, valid, nb)
    start = merge_cuda.block_prefix(dest, nb)
    out, prefix = merge_cuda.run_kernel(bwt, insmap, start, nt, dtype)
    assert prefix.shape == (nb * merge_cuda.ROWS + 1, 6)
    assert prefix.dtype == dtype
    return out, merge_cuda.tables(prefix, bwt.shape[0], K), \
        merge_cuda.merge(bwt, pos, sym, stream, valid, nt, K)


def _jax(buf, pos, sym, stream, valid, n, K):
    return merge_pallas(
        jnp.asarray(buf), jnp.asarray(pos), jnp.asarray(sym.astype(np.int32)),
        jnp.asarray(stream), jnp.asarray(valid), n=jnp.asarray(n), K=K,
        interpret=True)


@pytest.mark.parametrize("K", [128, 256, 512])
@pytest.mark.parametrize("case", ["ragged", "n0", "dense"])
def test_composed_steps_and_merge_match_merge_pallas(K, case):
    """The live end is not a multiple of 4096 or of K ("ragged"), the old
    buffer is empty ("n0"), or most insertions fall at one point so that
    whole CTAs are insertions ("dense")."""
    args = _inputs(case, K + len(case))
    buf, pos, sym, stream, valid, n = args
    live = n + int(valid.sum())
    assert live % 4096 and live % K
    out, tab, (m_out, m_tab) = _composed(*args, K, torch.int32)
    want, want_blk = _jax(*args, K)
    want, want_blk = np.asarray(want), np.asarray(want_blk)
    rows = live // K + 1
    assert tab.shape == m_tab.shape == want_blk.shape
    assert tab.dtype == m_tab.dtype == torch.int32
    for buf_got, tab_got in ((out, tab), (m_out, m_tab)):
        assert np.array_equal(buf_got.numpy()[:live], want[:live])
        assert np.array_equal(tab_got.numpy()[:rows], want_blk[:rows])


@pytest.mark.parametrize("K", [128, 512])
def test_int64_prefix_matches_jax_tables(K):
    """run_kernel with int64 tables (through merge_blocks) against the JAX
    package's int64 rank tables of its merged buffer: the JAX merge gives
    int32 tables below 2^31."""
    args = _inputs("ragged", 7 * K)
    n, live = args[5], args[5] + int(args[4].sum())
    out, tab, _ = _composed(*args, K, torch.int64)
    want, _ = _jax(*args, K)
    want_blk = jrank.build_block_tables(want, K, dtype=jnp.int64)
    rows = live // K + 1
    assert tab.dtype == torch.int64 and tab.shape == want_blk.shape
    assert np.array_equal(out.numpy()[:live], np.asarray(want)[:live])
    assert np.array_equal(tab.numpy()[:rows], np.asarray(want_blk)[:rows])
    assert int(tab[rows - 1].sum()) == (rows - 1) * K and n > 0
