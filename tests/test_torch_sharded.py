"""The sharded engine (ropebwt2_tpu_torch/parallel/sharded.py) on gloo
ranks on the CPU against the JAX package's ShardedTpuBwt on the same
number of devices of its 8-device CPU mesh, and against TpuBwt: the cases
of tests/test_sharded.py (sorting orders 0/1/2, incremental batches, the
restore from a single-device index, the 2-D (2, d / 2) mesh, deferred
merging with defer_r 4, K 256 and one case at K 128; the last four are in
tests/test_torch_sharded_deferred.py), and a growth case that re-shards
twice at d = 2 and at d = 4.  After every batch each
rank's window and global-valued table equal the JAX state's row for that
rank (convert.sharded_from_numpy), field by field, with lcap, (R, pcap),
n, psize, pcounts and counts; rank 0's bwt_array and run_arrays equal
TpuBwt's BWT.  Every rank also records what each collective inside
ShardedTorchBwt._plan delivers to it: a re-shard receives exactly its new
window's live symbols, in one all_to_all, at most once a batch, and the
only other collective is the all_gather of the (d, 6) window totals.
The re-shard's split plan is held against numpy slicing without a world.
This process computes the JAX side before it spawns the ranks.
Exact comparisons (integers)."""

import pickle

import numpy as np
import pytest
import torch

from ropebwt2_tpu_torch.engine import TorchBwt
from ropebwt2_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
from ropebwt2_tpu_torch.parallel.sharded import (
    ShardedTorchBwt,
    plan_lcap,
    reshard_splits,
)

from test_torch_comm import join_world, start_world


def random_reads(seed, n, lo, hi, with_n=False):
    """The read lists of tests/conftest.py::random_reads, from a seed."""
    rng = np.random.default_rng(seed)
    hi_code = 5 if with_n else 4
    return [list(rng.integers(1, hi_code + 1, size=int(rng.integers(
        lo, hi + 1))).astype(int)) for _ in range(n)]


def random_batch(seed, n, lo, hi):
    """n reads of lo..hi random bases as a list of nt6 code arrays."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 5, size=int(k)).astype(np.int8)
            for k in rng.integers(lo, hi + 1, size=n)]


def growth_reads():
    """Three unplanned batches that re-shard twice at d = 2 and at d = 4
    (lcap 4096 -> 8192 -> 65,536 at d = 2, 4096 -> 16,384 -> 32,768 at
    d = 4) and end inside a window (n 67,281): 100 reads of 20-30 bp; 4,100
    reads of 1-2 bp, whose 8,192 padded rows trip the drift guard at d = 4
    (mpad > lcap 4096: the engine ends the batch on the JAX engine's second
    plan, its double count of n included); 2,600 reads of 15-25 bp.  At
    d = 2 no batch can trip the guard: the first plan's d windows already
    hold the batch's symbols, at least two a row."""
    return random_batch(21, 100, 20, 30) + random_batch(22, 4100, 1, 2) \
        + random_batch(23, 2600, 15, 25)


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
    each sorting order, incremental batches, one case at K 128, and the
    growth case, growth_reads) or
    "deferred" (defer_r 4 in each sorting order, the (2, d / 2) mesh with
    and without deferral, and the restore from a single-device index)."""
    if group == "plain":
        return [case(f"so {so}", so, random_reads(so, 40, 4, 25, True), [])
                for so in (0, 1, 2)] + [
            case("incremental", 1, random_reads(3, 60, 4, 20), [25]),
            case("K 128", 1, random_reads(5, 50, 4, 24, True), [20],
                 K=128),
            case("growth", 1, growth_reads(), [100, 4200])]
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
    """This rank's snapshots after every batch with the collectives of its
    plans (reshard_run.ReshardWatch), and on rank 0 the BWT and its runs
    split at the partition offsets."""
    from ropebwt2_tpu_torch.scripts.reshard_run import ReshardWatch

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
    plans, traffic = ReshardWatch(eng).plans, []
    for b in batches:
        eng.insert_multi(b)
        snaps.append(_snapshot(eng, chosen, lambda t: t.numpy()))
        traffic.append(plans[:])
        plans.clear()
    off = np.concatenate([[0], np.cumsum(eng.state.psize.numpy())])
    out = {"snaps": snaps, "bwt": eng.bwt_array(), "traffic": traffic,
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


def _plan_traffic(c, got_by_rank, d):
    """Every batch's plans (test c): a batch that grows an index of n > 0
    symbols re-shards once, in one all_to_all that delivers exactly the
    live symbols of the rank's new window; a batch that does not grow
    issues no collective in its plan; besides the all_to_all, a plan
    gathers the (d, 6) window totals and nothing else.  Returns, for the
    growth case's checks, (re-shards, batches whose drift guard raised
    lcap past the first plan's)."""
    snaps0 = got_by_rank[0]["snaps"]
    first = len(snaps0) - len(got_by_rank[0]["traffic"])  # 1 after restore
    reshards = drifts = 0
    for b, batch in enumerate(c["batches"][first:]):
        prev = snaps0[b + first - 1] if b + first else None
        n0, lcap0 = (int(prev["n"]), prev["lcap"]) if prev else (0, 0)
        lcap = snaps0[b + first]["lcap"]
        total = sum(len(r) + 1 for r in batch)
        drifts += plan_lcap(n0, total, lcap0, d, c["K"]) < lcap
        grew = lcap != lcap0
        reshards += grew and n0 > 0 and lcap0 > 0
        for rank in range(d):
            where = (c["name"], "batch", b + first, "rank", rank)
            calls = [x for p in got_by_rank[rank]["traffic"][b] for x in p]
            moved = [k for name, k, _ in calls
                     if name == "all_to_all_single"]
            rest = [(name, k) for name, k, _ in calls
                    if name != "all_to_all_single"]
            live = min(lcap, max(0, n0 - rank * lcap))
            assert moved == ([live] if grew and n0 and lcap0 else []), where
            assert rest == ([("all_gather", d * 6)] if grew else []), where
    return reshards, drifts


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
        reshards, drifts = _plan_traffic(c, [g[i] for g in got], d)
        if c["name"] == "growth":  # the case still does what it says
            assert reshards == 2 and drifts == (d == 4), (d, reshards,
                                                          drifts)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_engine_matches_jax(d, tmp_path):
    """ShardedTorchBwt on d gloo ranks == ShardedTpuBwt on d devices, field
    by field per rank after every batch, and == TpuBwt: one batch in each
    sorting order, incremental batches, K 128, and growth through two
    re-shards (one of them raised by the drift guard at d = 4); each
    re-shard delivers a rank its new window's live symbols and nothing
    more.  The deferred, 2-D and restore cases are in
    tests/test_torch_sharded_deferred.py."""
    held_to_jax(d, "plain", tmp_path)


def _n_grid(d, lcap):
    """n at 0, and at each window's end, one past it and its middle."""
    ns = {0}
    for w in range(d):
        ns |= {w * lcap + lcap // 2, (w + 1) * lcap, (w + 1) * lcap + 1}
    return sorted(x for x in ns if x <= d * lcap)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_reshard_splits_cut_windows_as_numpy_slices(d):
    """reshard_splits, run as all_to_all_single would run it (each rank's
    old live prefix cut by its send sizes, each rank's receives
    concatenated in rank order), re-cuts a numbered array's windows of lcap
    into its windows of lcap2, for lcap2 / lcap 1, 2, 4 and 16, at lcap
    4096 and at 4224 (K 384's rounding), over _n_grid's n; both ends of
    every pair agree on its size."""
    for lcap in (4096, 4224):
        for g in (1, 2, 4, 16):
            lcap2 = lcap * g
            for n in _n_grid(d, lcap):
                arr = np.arange(n)
                splits = [reshard_splits(n, lcap, lcap2, d, s)
                          for s in range(d)]
                pieces = []
                for s, (send, _) in enumerate(splits):
                    old = arr[s * lcap: (s + 1) * lcap]
                    assert sum(send) == old.size, (n, lcap2, s)
                    pieces.append(np.split(old, np.cumsum(send)[:-1]))
                for t, (_, recv) in enumerate(splits):
                    got = [pieces[s][t] for s in range(d)]
                    assert [x.size for x in got] == recv, (n, lcap2, t)
                    assert np.array_equal(
                        np.concatenate(got),
                        arr[t * lcap2: (t + 1) * lcap2]), (n, lcap2, t)


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


def test_reshard_run_grows_a_world_of_one_through_two_reshards(
        monkeypatch, tmp_path):
    """scripts/reshard_run.py at a world of one (gloo, in this process):
    3 unplanned batches of 512 reads x 30 grow lcap 16,384 -> 32,768 ->
    65,536; each re-shard receives exactly the n symbols built so far, in
    one all_to_all, and the (1, 6) int32 totals, as received_exactly says;
    the BWT's md5 equals TorchBwt's on the same reads, and the record
    names the CPU."""
    from ropebwt2_tpu_torch.scripts import reshard_run
    from ropebwt2_tpu_torch.scripts.scale_run import text_md5

    for k, v in (("RESHARD_MBATCH", "512"), ("RESHARD_L", "30"),
                 ("RESHARD_JSON", str(tmp_path / "r.json"))):
        monkeypatch.setenv(k, v)
    rec = reshard_run.main(device="cpu")
    syms = 512 * 31
    assert [b["lcap"] for b in rec["batch"]] == [16384, 32768, 65536]
    assert [b["n"] for b in rec["batch"]] == [syms, 2 * syms, 3 * syms]
    (rank,) = rec["ranks"]
    assert [(r["lcap_from"], r["lcap_to"], r["n_from"], r["recv_bytes"])
            for r in rank["reshards"]] == [
        (0, 16384, 0, 24), (16384, 32768, syms, syms + 24),
        (32768, 65536, 2 * syms, 2 * syms + 24)]
    assert [r["calls"] for r in rank["reshards"]] == [
        [("all_gather", 6, 24)]] + [
        [("all_to_all_single", k, k), ("all_gather", 6, 24)]
        for k in (syms, 2 * syms)]
    assert all(r["exact"] for r in rank["reshards"])
    wrong = dict(rank["reshards"][1], n_from=syms - 1)
    assert not reshard_run.received_exactly(wrong, 1, 0)
    assert rec["device"] == "cpu" and rec["counts_ok"] and rec["d"] == 1
    ref = TorchBwt(so=1, K=128, device="cpu")
    for bt in reshard_run.read_batches(512, 30):
        ref.insert_multi(bt)
    assert rec["bwt_md5"] == text_md5(ref.bwt_array())
    assert (tmp_path / "r.json").exists()
