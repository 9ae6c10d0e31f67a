"""The port's 4-bit packed capacity tier (ropebwt2_tpu_torch.index.packed,
kernel C's plain version, the tier switch of TorchBwt) against the JAX
package on the same numpy-seeded inputs, on the CPU.

Every comparison is exact (integers).  Content past the live prefix is
unspecified in both packages, so buffers are compared on [0, n +
#insertions) and rank tables on the symbol rows at or below it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ropebwt2_tpu.engine import TpuBwt
from ropebwt2_tpu.index import flat as jflat
from ropebwt2_tpu.index import packed as jpacked
from ropebwt2_tpu.index import rank as jrank
from ropebwt2_tpu.index.merge_pallas_packed import merge_pallas_packed

from ropebwt2_tpu_torch.convert import packed_from_numpy
from ropebwt2_tpu_torch.engine import TorchBwt
from ropebwt2_tpu_torch.index import flat, merge_packed_cuda, packed, rank

from conftest import random_reads

LANE = packed.LANE
SLACK = packed.PPAD_ROWS * 2 * LANE  # symbols of packed tail slack


def _syms(rng, total, n, garbage=False):
    """int8[total]: random symbols on [0, n), PAD past n, or any nibble
    past n when ``garbage`` (content past n after a merge is unspecified)."""
    s = np.full(total, flat.PAD, np.int8)
    s[:n] = rng.integers(0, 6, n)
    if garbage:
        s[n:] = rng.integers(0, 16, total - n)
    return s


def _insertions(rng, m, a, n):
    """m lanes, the first a valid: sorted points in [0, n], tie ranks
    0..a-1, random symbols."""
    pos = np.zeros(m, np.int64)
    pos[:a] = np.sort(rng.integers(0, n + 1, a))
    stream = np.where(np.arange(m) < a, np.arange(m), 0).astype(np.int64)
    return pos, rng.integers(0, 6, m).astype(np.int64), stream, \
        np.arange(m) < a


def _j(pos, sym, stream, valid):
    return (jnp.asarray(pos), jnp.asarray(sym.astype(np.int32)),
            jnp.asarray(stream), jnp.asarray(valid))


def _t(pos, sym, stream, valid):
    return [torch.from_numpy(x) for x in (pos, sym, stream, valid)]


def _absolute(blkA, blkB, cap, nblk):
    """int64 per-symbol prefix at symbol rows 0..nblk-1 from two-level
    tables (numpy): anchor + anchor-relative row."""
    blks = np.arange(nblk)
    a = np.asarray(blkA)[(blks * LANE) >> 24]
    return a + np.asarray(blkB)[np.asarray(
        jpacked.blkb_row(blks, cap // 256))]


def test_pack_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    syms = rng.integers(0, 16, 512 * LANE).astype(np.int8)
    want = jpacked.pack_bwt_np(syms)
    assert np.array_equal(np.asarray(jpacked.pack_bwt(jnp.asarray(syms))),
                          want)
    got = packed.pack_bwt(torch.from_numpy(syms))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(packed.pack_bwt_np(syms), want)
    back = packed.unpack_bwt(torch.from_numpy(want))
    assert back.dtype == torch.int8
    assert np.array_equal(back.numpy(), jpacked.unpack_bwt_np(want))
    assert np.array_equal(packed.unpack_bwt_np(want), syms)
    assert packed.PACKED_PAD_BYTE == jpacked.PACKED_PAD_BYTE
    assert (packed.LANE, packed.ACHUNK, packed.PPAD_ROWS) == \
        (jpacked.LANE, jpacked.ACHUNK, jpacked.PPAD_ROWS)


@pytest.mark.parametrize("garbage", [False, True])
def test_build_two_level_tables_matches_jax(garbage):
    rng = np.random.default_rng(1 + garbage)
    cap = 1 << 16
    pb = packed.pack_bwt_np(_syms(rng, cap + SLACK, cap - 300, garbage))
    blkA, blkB = packed.build_two_level_tables(torch.from_numpy(pb), cap)
    jA, jB = jpacked.build_two_level_tables(jnp.asarray(pb), cap)
    assert blkA.dtype == torch.int64 and blkB.dtype == torch.int32
    assert np.array_equal(blkA.numpy(), np.asarray(jA))
    assert np.array_equal(blkB.numpy(), np.asarray(jB))


def test_tables_from_plane_counts_across_anchors():
    """Synthetic per-plane counts at cap = 3 * 2^24 + 2^20 (no buffer):
    three anchor boundaries and a ragged last chunk.  Equal to the JAX
    tables, and anchor + relative row equals the int64 prefix at every
    symbol row."""
    rng = np.random.default_rng(3)
    cap = 3 * (1 << 24) + (1 << 20)
    nprows = cap // 256
    lo6 = rng.integers(0, 22, (nprows, 6)).astype(np.int32)
    hi6 = rng.integers(0, 22, (nprows, 6)).astype(np.int32)
    blkA, blkB = packed.tables_from_plane_counts(
        torch.from_numpy(lo6), torch.from_numpy(hi6), cap)
    jA, jB = jpacked.tables_from_plane_counts(jnp.asarray(lo6),
                                              jnp.asarray(hi6), cap)
    assert np.array_equal(blkA.numpy(), np.asarray(jA))
    assert np.array_equal(blkB.numpy(), np.asarray(jB))
    rows = np.stack([lo6, hi6], axis=1).reshape(-1, 6).astype(np.int64)
    want = np.concatenate([np.zeros((1, 6), np.int64), np.cumsum(rows, 0)])
    got = _absolute(blkA.numpy(), blkB.numpy(), cap, 2 * nprows + 1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("garbage", [False, True])
def test_rank_global_packed_matches_jax(garbage):
    rng = np.random.default_rng(4 + garbage)
    cap = 1 << 16
    n = cap - 300
    syms = _syms(rng, cap + SLACK, n, garbage)
    pb = packed.pack_bwt_np(syms)
    pos = np.concatenate([rng.integers(0, n + 1, 500),
                          [0, 1, 127, 128, 129, 255, 256, n]]).astype(np.int64)
    tpb = torch.from_numpy(pb)
    got = packed.rank_global_packed(
        tpb, *packed.build_two_level_tables(tpb, cap), torch.from_numpy(pos))
    jpb = jnp.asarray(pb)
    want = jpacked.rank_global_packed(
        jpb, *jpacked.build_two_level_tables(jpb, cap), jnp.asarray(pos))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(want))
    tsyms = torch.from_numpy(syms)
    flat_rank = rank.rank_global(
        tsyms, rank.build_block_tables(tsyms, LANE), torch.from_numpy(pos),
        LANE)
    assert np.array_equal(got.numpy(), flat_rank.numpy())


def test_apply_insertions_packed_matches_jax():
    rng = np.random.default_rng(5)
    cap = 1 << 15
    n = cap - 2048
    pb = packed.pack_bwt_np(_syms(rng, cap, n))
    ins = _insertions(rng, 128, 100, n)
    got = packed.apply_insertions_packed(torch.from_numpy(pb), None,
                                         *_t(*ins))
    want = jpacked.apply_insertions_packed(jnp.asarray(pb), jnp.asarray(n),
                                           *_j(*ins))
    live = n + 100
    assert got.dtype == torch.uint8
    assert np.array_equal(packed.unpack_bwt_np(got.numpy())[:live],
                          jpacked.unpack_bwt_np(np.asarray(want))[:live])


@pytest.mark.parametrize("garbage", [False, True])
def test_plain_packed_merge_matches_merge_pallas_packed_interpret(garbage):
    """merge_packed_cuda.merge_packed on CPU tensors (the plain version)
    against the TPU kernel run in interpret mode, as
    tests/test_packed.py::test_merge_pallas_packed_interpret does."""
    rng = np.random.default_rng(6 + garbage)
    cap, m = 131072, 96
    n = int(rng.integers(1, cap - m))
    pb = packed.pack_bwt_np(_syms(rng, cap + SLACK, n, garbage))
    a = int(rng.integers(1, m + 1))
    ins = _insertions(rng, m, a, n)
    got, gA, gB = merge_packed_cuda.merge_packed(
        torch.from_numpy(pb), *_t(*ins), torch.tensor(n), 128)
    want, wA, wB = merge_pallas_packed(jnp.asarray(pb), *_j(*ins),
                                       n=jnp.asarray(n), K=128,
                                       interpret=True)
    live = n + a
    assert got.shape == want.shape and gA.shape == wA.shape \
        and gB.shape == wB.shape
    assert np.array_equal(packed.unpack_bwt_np(got.numpy())[:live],
                          jpacked.unpack_bwt_np(np.asarray(want))[:live])
    nblk = live // LANE + 1
    rows = np.asarray(jpacked.blkb_row(np.arange(nblk), cap // 256))
    assert np.array_equal(gB.numpy()[rows], np.asarray(wB)[rows])
    assert np.array_equal(gA.numpy()[: (live >> 24) + 1],
                          np.asarray(wA)[: (live >> 24) + 1])
    assert np.array_equal(_absolute(gA.numpy(), gB.numpy(), cap, nblk),
                          _absolute(wA, wB, cap, nblk))


def test_grow_and_packed_from_flat_match_jax():
    """An empty packed state, and an int8 state -> packed at a larger
    capacity, then grown across an anchor boundary: every array equal to
    the JAX package's."""
    got = packed.empty_packed_state((1 << 24) + 256, "cpu")
    want = jpacked.empty_packed_state((1 << 24) + 256)
    assert got.cap == want.cap
    for name in ("pbwt", "n", "psize", "pcounts", "blkA", "blkB"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name
    rng = np.random.default_rng(7)
    cap, K = 1 << 12, 128
    buf = _syms(rng, cap + flat.PAD_TAIL, 3000)
    st = flat.empty_state(cap, K, "cpu")
    st.bwt = torch.from_numpy(buf)
    st.blk_prefix = rank.build_block_tables(st.bwt, K, dtype=torch.int32)
    jst = jflat.empty_state(cap, K)
    jst.bwt = jnp.asarray(buf)
    jst.blk_prefix = jrank.build_block_tables(jst.bwt, K, dtype=jnp.int32)
    got = packed.packed_from_flat(st, 1 << 14)
    want = jpacked.packed_from_flat(jst, 1 << 14)
    for g, w in ((got, want),
                 (packed.grow_packed_state(got, (1 << 24) + (1 << 20)),
                  jpacked.grow_packed_state(want, (1 << 24) + (1 << 20)))):
        assert g.cap == w.cap
        for name in ("pbwt", "blkA", "blkB"):
            assert np.array_equal(getattr(g, name).numpy(),
                                  np.asarray(getattr(w, name))), name


@pytest.mark.parametrize("so", [0, 1, 2])
@pytest.mark.parametrize("defer_r", [0, 4])
def test_packed_engine_matches_jax(so, defer_r, monkeypatch):
    """TorchBwt(pack4=1) against TpuBwt with ROPEBWT2_TPU_PACK4=1 over two
    batches, as tests/test_packed_engine.py runs the JAX package."""
    monkeypatch.setenv("ROPEBWT2_TPU_PACK4", "1")
    rng = np.random.default_rng(10 * so + defer_r)
    reads = [np.asarray(r, np.int8)
             for r in random_reads(rng, 48, lo=4, hi=30, with_n=True)]
    jeng = TpuBwt(so=so, defer_r=defer_r)
    teng = TorchBwt(so=so, defer_r=defer_r, device="cpu", pack4=1)
    for batch in (reads[:24], reads[24:]):
        jeng.insert_multi(batch)
        teng.insert_multi(batch)
    assert isinstance(teng.state, packed.PackedFlatBwt)
    assert teng.state.cap == jeng.state.cap
    got = teng.bwt_array()
    assert got.dtype == np.int8
    assert np.array_equal(got, jeng.bwt_array())
    assert np.array_equal(teng.counts(), jeng.counts())


def test_threshold_crossing_matches_jax(monkeypatch):
    """pack4 set between the two batches' totals: flat after batch 1,
    packed after batch 2, and the BWT of
    tests/test_packed_engine.py::test_packed_convert_midway."""
    rng = np.random.default_rng(0)
    reads = [np.asarray(r, np.int8) for r in random_reads(rng, 60, 5, 25)]
    monkeypatch.setenv("ROPEBWT2_TPU_PACK4", "0")
    plain = TpuBwt(so=1)
    plain.insert_multi(reads)
    conv = TpuBwt(so=1)
    conv.insert_multi(reads[:20])
    monkeypatch.setenv("ROPEBWT2_TPU_PACK4", "1")
    conv.insert_multi(reads[20:])
    assert isinstance(conv.state, jpacked.PackedFlatBwt)

    eng = TorchBwt(so=1, device="cpu",
                   pack4=sum(len(r) + 1 for r in reads[:20]))
    eng.insert_multi(reads[:20])
    assert isinstance(eng.state, flat.FlatBwt)
    eng.insert_multi(reads[20:])
    assert isinstance(eng.state, packed.PackedFlatBwt)
    assert eng.state.cap == conv.state.cap
    assert np.array_equal(eng.bwt_array(), conv.bwt_array())
    assert np.array_equal(eng.bwt_array(), plain.bwt_array())


def test_packed_index_carried_into_the_port(monkeypatch):
    """A packed JAX build stopped after batch 1 and continued in the port
    gives the same BWT as a build done wholly in JAX."""
    monkeypatch.setenv("ROPEBWT2_TPU_PACK4", "1")
    rng = np.random.default_rng(42)
    batches = [[np.asarray(r, np.int8) for r in
                random_reads(rng, 120, lo=1, hi=30, with_n=True)]
               for _ in range(3)]
    whole = TpuBwt(so=2, defer_r=4)
    half = TpuBwt(so=2, defer_r=4)
    for b in batches:
        whole.insert_multi(b)
    half.insert_multi(batches[0])

    js = half.state
    eng = TorchBwt(so=2, defer_r=4, device="cpu", pack4=1)
    eng.state = packed_from_numpy(
        np.asarray(js.pbwt), int(js.n), np.asarray(js.psize),
        np.asarray(js.pcounts), np.asarray(js.blkA), np.asarray(js.blkB),
        "cpu")
    assert eng.state.cap == js.cap
    eng._n, eng._n_strings = half.n, half._n_strings
    for b in batches[1:]:
        eng.insert_multi(b)
    assert np.array_equal(eng.bwt_array(), whole.bwt_array())
    assert np.array_equal(eng.counts(), whole.counts())


def test_device_defaults_to_the_card(monkeypatch):
    """No device and no card: TorchBwt raises instead of building on the
    CPU unasked; device="cpu" builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchBwt(so=1)
    eng = TorchBwt(so=1, device="cpu")
    eng.insert_multi([np.array([1, 2, 3, 4], np.int8)] * 3)
    assert eng.counts().tolist() == [3, 3, 3, 3, 3, 0]


def test_pack4_and_packed_merge_refuse_bad_input():
    """pack4 takes "auto" or an int >= 0; the packed tier needs K = 128;
    kernel C's wrapper runs its plain version only for CPU tensors and
    raises on any other device."""
    for bad in ("1", -1, 2.5):
        with pytest.raises(ValueError):
            TorchBwt(so=1, device="cpu", pack4=bad)
    eng = TorchBwt(so=1, K=256, device="cpu", pack4=1)
    with pytest.raises(ValueError, match="K = 128"):
        eng.insert_multi([np.array([1, 2, 3], np.int8)])
    dev = torch.device("meta")
    pb = torch.empty(4096, dtype=torch.uint8, device=dev)
    m = torch.empty(8, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        merge_packed_cuda.merge_packed(pb, m, m, m, m.bool(), torch.empty(
            (), dtype=torch.int64, device=dev), 128)
