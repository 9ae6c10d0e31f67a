"""The port's index primitives (ropebwt2_tpu_torch.index) against the JAX
package on the same numpy-seeded inputs, on the CPU.

Every comparison is exact: the data are integers.  Content past the live
prefix is unspecified in both packages, so buffers are compared on
[0, n + #insertions) and rank tables on the rows at or below it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ropebwt2_tpu import alphabet as jax_alphabet
from ropebwt2_tpu import oracle as jax_oracle
from ropebwt2_tpu.index import flat as jflat
from ropebwt2_tpu.index import merge as jmerge
from ropebwt2_tpu.index import rank as jrank
from ropebwt2_tpu.index.merge_pallas import merge_pallas

from ropebwt2_tpu_torch import alphabet
from ropebwt2_tpu_torch.index import flat, merge_cuda, rank
from ropebwt2_tpu_torch.index.merge import apply_insertions


def test_alphabet_and_order_constants_match_jax():
    for name in ("SENT", "A", "C", "G", "T", "N", "NSYM", "SYM_CHARS"):
        assert getattr(alphabet, name) == getattr(jax_alphabet, name), name
    assert np.array_equal(alphabet.NT6_TABLE, jax_alphabet.NT6_TABLE)
    assert np.array_equal(alphabet.COMP6_TABLE, jax_alphabet.COMP6_TABLE)
    for name in ("SO_IO", "SO_RLO", "SO_RCLO"):
        assert getattr(alphabet, name) == getattr(jax_oracle, name), name
    assert flat.PAD == jflat.PAD and flat.PAD_TAIL == jflat.PAD_TAIL


def _buffer(rng, cap, n, garbage_tail=False):
    buf = np.full(cap + flat.PAD_TAIL, flat.PAD, np.int8)
    buf[:n] = rng.integers(0, 6, n)
    if garbage_tail:  # content past n after a kernel merge is unspecified
        buf[n:] = rng.integers(-128, 128, cap + flat.PAD_TAIL - n)
    return buf


def _insertions(rng, m, a, lo, hi, dtype=np.int64):
    """m lanes, the first a valid: sorted points in [lo, hi], tie ranks
    0..a-1, random symbols."""
    pos = np.zeros(m, dtype)
    pos[:a] = np.sort(rng.integers(lo, hi + 1, a))
    stream = np.zeros(m, dtype)
    stream[:a] = np.arange(a)
    sym = rng.integers(0, 6, m).astype(np.int64)
    valid = np.arange(m) < a
    return pos, sym, stream, valid


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)).long() if np.asarray(x).dtype
            != bool else torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("garbage_tail", [False, True])
def test_build_block_tables_matches_jax(K, garbage_tail):
    rng = np.random.default_rng(K + garbage_tail)
    buf = _buffer(rng, 1 << 14, 9000, garbage_tail)
    for dt, jdt in ((torch.int32, jnp.int32), (torch.int64, jnp.int64)):
        got = rank.build_block_tables(torch.from_numpy(buf), K, dtype=dt)
        want = jrank.build_block_tables(jnp.asarray(buf), K, dtype=jdt)
        assert got.dtype == dt
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("K", [128, 256])
def test_rank_global_matches_jax(K):
    rng = np.random.default_rng(10 + K)
    cap, n = 1 << 14, 12345
    buf = _buffer(rng, cap, n, garbage_tail=True)
    pos = np.concatenate([[0, n, K, K - 1, K + 1],
                          rng.integers(0, n + 1, 400)]).astype(np.int64)
    tb = torch.from_numpy(buf)
    tab = rank.build_block_tables(tb, K, dtype=torch.int32)
    got = rank.rank_global(tb, tab, torch.from_numpy(pos), K)
    jb = jnp.asarray(buf)
    want = jrank.rank_global(
        jb, jrank.build_block_tables(jb, K, dtype=jnp.int32),
        jnp.asarray(pos), K)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


CASES = ["sparse", "garbage_tail", "dense", "empty", "ends"]


@pytest.mark.parametrize("case", CASES)
def test_apply_insertions_matches_jax(case):
    rng = np.random.default_rng(CASES.index(case))
    cap, m = 1 << 15, 512
    n = 20000
    buf = _buffer(rng, cap, n, garbage_tail=case == "garbage_tail")
    if case == "dense":  # most insertions at one point, the rest close by
        pos, sym, stream, valid = _insertions(rng, m, m, 0, 60)
        pos[: m // 2] = 17
        pos = np.sort(pos)
    elif case == "empty":
        pos, sym, stream, valid = _insertions(rng, m, 0, 0, n)
    elif case == "ends":  # at 0 and at n only
        pos, sym, stream, valid = _insertions(rng, m, 300, 0, n)
        pos[:150], pos[150:300] = 0, n
    else:
        pos, sym, stream, valid = _insertions(rng, m, 400, 0, n)
    live = n + int(valid.sum())
    got = apply_insertions(torch.from_numpy(buf), None, *_t(pos, sym, stream,
                                                           valid))
    want = jmerge.apply_insertions(
        jnp.asarray(buf), jnp.asarray(n), jnp.asarray(pos),
        jnp.asarray(sym.astype(np.int32)), jnp.asarray(stream),
        jnp.asarray(valid))
    assert np.array_equal(got.numpy()[:live], np.asarray(want)[:live])


@pytest.mark.parametrize("K,case", [(128, "random"), (256, "dense"),
                                    (128, "garbage_tail")])
def test_plain_merge_matches_merge_pallas_interpret(K, case):
    """merge_cuda.merge on CPU tensors (the plain version) against the
    TPU kernel run in interpret mode, as tests/test_merge_pallas.py does."""
    rng = np.random.default_rng(K)
    cap, m = 131072, 256
    n = cap - m - 999
    buf = _buffer(rng, cap, n, garbage_tail=case == "garbage_tail")
    if case == "dense":
        pos, sym, stream, valid = _insertions(rng, m, m - 6, 0, 40)
        pos[: m // 2] = 0
        pos[:m - 6] = np.sort(pos[:m - 6])
    else:
        pos, sym, stream, valid = _insertions(rng, m, m - 20, 0, n)
    got, got_blk = merge_cuda.merge(
        torch.from_numpy(buf), *_t(pos, sym, stream, valid),
        torch.tensor(n), K)
    want, want_blk = merge_pallas(
        jnp.asarray(buf), jnp.asarray(pos),
        jnp.asarray(sym.astype(np.int32)), jnp.asarray(stream),
        jnp.asarray(valid), n=jnp.asarray(n), K=K, interpret=True)
    live = n + int(valid.sum())
    assert np.array_equal(got.numpy()[:live], np.asarray(want)[:live])
    assert got_blk.dtype == torch.int32 and got_blk.shape == want_blk.shape
    rows = live // K + 1
    assert np.array_equal(got_blk.numpy()[:rows], np.asarray(want_blk)[:rows])


def test_grow_state_matches_jax():
    rng = np.random.default_rng(7)
    K = 128
    st = flat.empty_state(1 << 12, K, "cpu")
    jst = jflat.empty_state(1 << 12, K)
    buf = _buffer(rng, 1 << 12, 3000)
    st.bwt = torch.from_numpy(buf)
    st.blk_prefix = rank.build_block_tables(st.bwt, K, dtype=torch.int32)
    jst.bwt = jnp.asarray(buf)
    jst.blk_prefix = jrank.build_block_tables(jst.bwt, K, dtype=jnp.int32)
    got = flat.grow_state(st, 1 << 14, K)
    want = jflat.grow_state(jst, 1 << 14, K)
    assert got.cap == want.cap == 1 << 14
    assert np.array_equal(got.bwt.numpy(), np.asarray(want.bwt))
    assert np.array_equal(got.blk_prefix.numpy(), np.asarray(want.blk_prefix))


def test_merge_wrapper_refuses_other_devices():
    """The kernel wrapper runs its plain version only for CPU tensors; any
    other device must launch the kernel or raise."""
    dev = torch.device("meta")
    bwt = torch.empty(4096, dtype=torch.int8, device=dev)
    m = torch.empty(8, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        merge_cuda.merge(bwt, m, m, m, m.bool(), torch.empty(
            (), dtype=torch.int64, device=dev), 128)
