"""The sharded engine (ropebwt2_tpu_torch/parallel/sharded.py) on gloo
ranks on the CPU against the JAX package's ShardedTpuBwt on the same
number of devices of its 8-device CPU mesh, and against TpuBwt: the cases
of tests/test_sharded.py (sorting orders 0/1/2, incremental batches, the
restore from a single-device index, the 2-D (2, d / 2) mesh, deferred
merging with defer_r 4, K 256 and one case at K 128; the last four are in
tests/test_torch_sharded_deferred.py).  After every batch each
rank's window and global-valued table equal the JAX state's row for that
rank (convert.sharded_from_numpy), field by field, with lcap, (R, pcap),
n, psize, pcounts and counts; rank 0's bwt_array and run_arrays equal
TpuBwt's BWT.  This process computes the JAX side before it spawns
the ranks.
Exact comparisons (integers)."""

import pickle

import numpy as np
import pytest
import torch

from ropebwt2_tpu_torch.engine import TorchBwt
from ropebwt2_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
from ropebwt2_tpu_torch.parallel.sharded import ShardedTorchBwt

from test_torch_comm import join_world, start_world


def random_reads(seed, n, lo, hi, with_n=False):
    """The read lists of tests/conftest.py::random_reads, from a seed."""
    rng = np.random.default_rng(seed)
    hi_code = 5 if with_n else 4
    return [list(rng.integers(1, hi_code + 1, size=int(rng.integers(
        lo, hi + 1))).astype(int)) for _ in range(n)]


def case(name, so, reads, split, K=256, defer_r=None, restore=False,
         mesh2d=False):
    """One build: ``reads`` in batches cut at ``split``; with ``restore``
    the first batch goes into a single-device index that the sharded
    engine then adopts (from_single)."""
    cuts = [0, *split, len(reads)]
    return {"name": name, "so": so, "K": K, "defer_r": defer_r,
            "restore": restore, "mesh2d": mesh2d,
            "batches": [reads[a:b] for a, b in zip(cuts, cuts[1:])]}


def cases(group):
    """The cases of tests/test_sharded.py: "plain" (one batch in
    each sorting order, incremental batches, one case at K 128) or
    "deferred" (defer_r 4 in each sorting order, the (2, d / 2) mesh with
    and without deferral, and the restore from a single-device index)."""
    if group == "plain":
        return [case(f"so {so}", so, random_reads(so, 40, 4, 25, True), [])
                for so in (0, 1, 2)] + [
            case("incremental", 1, random_reads(3, 60, 4, 20), [25]),
            case("K 128", 1, random_reads(5, 50, 4, 24, True), [20],
                 K=128)]
    return [case(f"deferred so {so}", so, random_reads(6 + so, 72, 4, 24,
                                                        True), [40],
                 defer_r=4) for so in (0, 1, 2)] + [
        case("2-D mesh", 1, random_reads(9, 48, 4, 22, True), [20],
             mesh2d=True),
        case("2-D mesh deferred", 1, random_reads(10, 40, 5, 18), [],
             defer_r=4, mesh2d=True),
        case("from_single", 1, random_reads(4, 48, 4, 20), [24],
             restore=True)]


def _snapshot(eng, chosen, to_np):
    """The fields held after a batch: lcap, the (R, pcap) choices so far,
    counts and the state's arrays (to_np makes them numpy)."""
    st = eng.state
    return {"lcap": eng._lcap, "chosen": list(chosen),
            "counts": np.asarray(eng.counts()),
            **{f: to_np(getattr(st, f)) for f in
               ("bwt", "blk_prefix", "n", "psize", "pcounts")}}


def _recording(eng):
    """Record every (R, pcap) that the engine's _choose_defer returns."""
    chosen, choose = [], eng._choose_defer

    def rec(mpad):
        chosen.append(choose(mpad))
        return chosen[-1]

    eng._choose_defer = rec
    return chosen


def _port_case(c, d):
    """This rank's snapshots after every batch, and on rank 0 the BWT and
    its runs split at the partition offsets."""
    mesh = make_mesh2d(2, d // 2, device="cpu") if c["mesh2d"] else \
        make_mesh(device="cpu")
    batches = [[np.asarray(r, np.int8) for r in b] for b in c["batches"]]
    if c["restore"]:
        single = TorchBwt(so=c["so"], K=c["K"], device="cpu")
        single.insert_multi(batches[0])
        eng = ShardedTorchBwt.from_single(single, mesh=mesh)
        batches = batches[1:]
    else:
        eng = ShardedTorchBwt(so=c["so"], K=c["K"], mesh=mesh,
                              defer_r=c["defer_r"])
    chosen = _recording(eng)
    snaps = [_snapshot(eng, chosen, lambda t: t.numpy())] \
        if c["restore"] else []
    for b in batches:
        eng.insert_multi(b)
        snaps.append(_snapshot(eng, chosen, lambda t: t.numpy()))
    off = np.concatenate([[0], np.cumsum(eng.state.psize.numpy())])
    out = {"snaps": snaps, "bwt": eng.bwt_array(),
           "runs": eng.run_arrays(bounds=off)}
    mesh.close()  # the 2-D mesh's subgroups end here, the default group
    return out    # with the rank (test_torch_comm._rank_main)


def _ranks(rank, d, cases, out):
    res = [_port_case(c, d) for c in cases]
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _jax_case(c, d):
    """The JAX sharded engine's snapshots (whole arrays) and TpuBwt's BWT
    and counts on the same batches."""
    from ropebwt2_tpu.engine import TpuBwt
    from ropebwt2_tpu.parallel import mesh as jmesh
    from ropebwt2_tpu.parallel.sharded import ShardedTpuBwt

    mesh = jmesh.make_mesh2d(2, d // 2) if c["mesh2d"] else \
        jmesh.make_mesh(d)
    batches = c["batches"]
    if c["restore"]:
        single = TpuBwt(so=c["so"], K=c["K"])
        single.insert_multi(batches[0])
        eng = ShardedTpuBwt.from_single(single, mesh=mesh)
        batches = batches[1:]
    else:
        eng = ShardedTpuBwt(so=c["so"], K=c["K"], mesh=mesh,
                            defer_r=c["defer_r"])
    chosen = _recording(eng)
    snaps = [_snapshot(eng, chosen, np.asarray)] if c["restore"] else []
    for b in batches:
        eng.insert_multi(b)
        snaps.append(_snapshot(eng, chosen, np.asarray))
    ref = TpuBwt(so=c["so"], K=c["K"])
    for b in c["batches"]:
        ref.insert_multi(b)
    return {"snaps": snaps, "bwt": ref.bwt_array(), "counts": ref.counts(),
            "sharded_bwt": eng.bwt_array()}


def _held_to_jax(got_by_rank, want, d, name):
    from ropebwt2_tpu_torch.convert import sharded_from_numpy

    for b, w in enumerate(want["snaps"]):
        for rank in range(d):
            g = got_by_rank[rank]["snaps"][b]
            where = (name, "batch", b, "rank", rank)
            assert g["lcap"] == w["lcap"], where
            assert g["chosen"] == [tuple(x) for x in w["chosen"]], where
            assert np.array_equal(g["counts"], w["counts"]), where
            row = sharded_from_numpy(w["bwt"], w["blk_prefix"], w["n"],
                                     w["psize"], w["pcounts"], rank, "cpu")
            for f in ("bwt", "blk_prefix", "n", "psize", "pcounts"):
                want_f = getattr(row, f).numpy()
                assert g[f].dtype == want_f.dtype, (where, f)
                assert np.array_equal(g[f], want_f), (where, f)
    bwt = got_by_rank[0]["bwt"]
    assert np.array_equal(bwt, want["bwt"]), name
    assert np.array_equal(bwt, want["sharded_bwt"]), name
    assert np.array_equal(got_by_rank[-1]["snaps"][-1]["counts"],
                          want["counts"]), name
    sym, ln = got_by_rank[0]["runs"]
    assert np.array_equal(np.repeat(sym, ln), bwt.astype(np.uint8)), name
    for r in got_by_rank[1:]:
        assert r["bwt"] is None and r["runs"] is None, name


def held_to_jax(d, group, tmp_path):
    """Run ``group``'s cases on the JAX engine in this process, then on d
    gloo ranks, and hold every rank's fields to the JAX state's.  The JAX
    side runs first, before any rank is spawned: a worker once crashed
    (a segfault while JAX loaded an executable from its persistent cache)
    with four ranks alive beside it."""
    cs = cases(group)
    want = [_jax_case(c, d) for c in cs]
    join_world(start_world(_ranks, d, tmp_path, cs, str(tmp_path)),
               timeout=400)
    got = []
    for rank in range(d):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            got.append(pickle.load(f))
    for i, c in enumerate(cs):
        _held_to_jax([g[i] for g in got], want[i], d, c["name"])


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_engine_matches_jax(d, tmp_path):
    """ShardedTorchBwt on d gloo ranks == ShardedTpuBwt on d devices, field
    by field per rank after every batch, and == TpuBwt: one batch in each
    sorting order, incremental batches, K 128.  The deferred, 2-D and
    restore cases are in tests/test_torch_sharded_deferred.py."""
    held_to_jax(d, "plain", tmp_path)


def test_stitched_merge_matches_the_jax_kernel():
    """The port's stitched merge on the CPU (kernel A's plain version,
    merge_blocks) against stitched_kernel_merge(interpret=True) at
    tests/test_sharded.py:296's shape (lcap 98,304, m 32,768, K 256, s_lo
    0/5/700): the window where the JAX test compares it and its rebased
    table rows; and against the drift formula (the JAX package's plain
    path) over the whole window."""
    import jax.numpy as jnp

    from ropebwt2_tpu.parallel.sharded import stitched_kernel_merge
    from ropebwt2_tpu_torch.index.rank import build_block_tables
    from ropebwt2_tpu_torch.parallel.sharded import stitched_merge

    rng = np.random.default_rng(12)
    lcap, m, K = 131072 - 32768, 32768, 256
    for s_lo in (0, 5, 700):
        bwt_loc = rng.integers(0, 6, lcap).astype(np.int8)
        tail = rng.integers(0, 6, m).astype(np.int8)
        A = 90
        ldest = np.full(m, lcap, np.int64)
        ldest[:A] = np.sort(rng.choice(lcap - m, A, replace=False))
        rsym = np.zeros(m, np.int64)
        rsym[:A] = rng.integers(0, 6, A)
        rv = np.arange(m) < A

        insmap = np.zeros(lcap + 1, np.int8)
        insmap[ldest[:A]] = rsym[:A] + 1
        c = np.cumsum(insmap[:lcap] != 0)
        src = m + np.arange(lcap) - s_lo - c
        want = np.where(insmap[:lcap] != 0, insmap[:lcap] - 1,
                        np.concatenate([tail, bwt_loc])[src]).astype(np.int8)

        window, table = stitched_merge(
            torch.from_numpy(bwt_loc), torch.from_numpy(tail),
            torch.from_numpy(ldest), torch.from_numpy(rsym),
            torch.from_numpy(rv), torch.tensor(s_lo), lcap, K)
        assert window.shape[0] == lcap + 2048
        assert (window[lcap:] == 6).all()
        assert np.array_equal(window[:lcap].numpy(), want), s_lo
        wtab = build_block_tables(torch.from_numpy(want), K,
                                  dtype=torch.int32)
        assert torch.equal(table, wtab), s_lo

        got, blkp = stitched_kernel_merge(
            jnp.asarray(bwt_loc), jnp.asarray(tail), jnp.asarray(ldest),
            jnp.asarray(rsym.astype(np.int32)), jnp.asarray(rv),
            jnp.asarray(s_lo, np.int32), lcap, K, interpret=True)
        lim = lcap - m  # where the JAX test compares the kernel's window
        assert np.array_equal(np.asarray(got)[:lim], want[:lim]), s_lo
        mrow = m // K
        blkp = np.asarray(blkp)
        reb = blkp[mrow: mrow + lim // K + 1] - blkp[mrow: mrow + 1]
        assert np.array_equal(reb, table[: lim // K + 1].numpy()), s_lo


@pytest.mark.parametrize("defer_r", [0, 4])
def test_world_of_one_in_this_process(defer_r):
    """ShardedTorchBwt(device="cpu") at a world of one (gloo, started here
    and ended by the mesh) == TorchBwt, with more than one window of
    growth (lcap 4096, then 8192)."""
    reads = [np.asarray(r, np.int8) for r in random_reads(13, 400, 4, 20)]
    ref = TorchBwt(so=1, K=128, defer_r=defer_r, device="cpu")
    eng = ShardedTorchBwt(so=1, K=128, defer_r=defer_r, device="cpu")
    try:
        for lo in range(0, 400, 100):
            ref.insert_multi(reads[lo: lo + 100])
            eng.insert_multi(reads[lo: lo + 100])
            assert np.array_equal(eng.bwt_array(), ref.bwt_array())
            assert np.array_equal(eng.counts(), ref.counts())
        assert eng._lcap == 8192 and eng.mesh.d == 1
        for x, y in zip(eng.run_arrays(), ref.run_arrays()):
            assert np.array_equal(x, y)
    finally:
        eng.mesh.close()


def test_sharded_engine_needs_a_card_unless_told(monkeypatch):
    """With no device and no card the engine raises; nothing falls back to
    the CPU."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedTorchBwt(so=1)
    assert not dist.is_initialized()
