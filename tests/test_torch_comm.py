"""The port's plan collectives (ropebwt2_tpu_torch/parallel/comm.py) on
gloo ranks on the CPU: ShardComm's primitives against numpy (the cases of
tests/test_sharded.py::test_shardcomm_primitives_vs_numpy, and skewed
routings: every row to one rank), plan_round through a ShardComm against
plan_round on one device, round after round, and LocalComm against the
default.  Worlds of 2 and 4 ranks are spawned processes over a file://
store under tmp_path; they import torch and the port only.  Exact
comparisons (integers)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ropebwt2_tpu_torch.engine import TorchBwt
from ropebwt2_tpu_torch.engine import bcr
from ropebwt2_tpu_torch.index.rank import rank_global
from ropebwt2_tpu_torch.parallel.comm import LocalComm, ShardComm
from ropebwt2_tpu_torch.parallel.mesh import local_block, make_mesh

K = 128


def start_world(worker, d, tmp_path, *args):
    """Start worker(rank, d, *args) on d gloo ranks, each a fresh process
    with one thread, over a file store in tmp_path; returns the context
    (join it with join_world)."""
    return mp.start_processes(
        _rank_main, args=(worker, d, str(tmp_path / "store"), args),
        nprocs=d, join=False, start_method="spawn")


def join_world(ctx, timeout=300):
    """Wait for every rank; raises if one failed or the wait timed out."""
    import time

    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > timeout:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks ran past {timeout} s")


def _rank_main(rank, worker, d, store, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=d)
    try:
        worker(rank, d, *args)
    finally:
        dist.destroy_process_group()


def _layout(reads, n_strings, so, mult):
    """(buf, l, u, pk) as the engines lay a batch out: padding rows first up
    to a power of two (>= 16, a multiple of ``mult``), 8-aligned reversed
    reads with a 0 terminator, the buffer a multiple of 8 * mult bytes."""
    m = len(reads)
    mpad = 16
    while mpad < m:
        mpad *= 2
    npad = mpad - m
    strides = np.array([(len(r) + 8) & ~7 for r in reads], np.int64)
    starts = np.concatenate([[0], np.cumsum(strides)[:-1]])
    size = -(-int(strides.sum()) // (8 * mult)) * 8 * mult
    buf = np.zeros(size, np.int8)
    for s, r in zip(starts, reads):
        buf[s: s + len(r)] = np.asarray(r, np.int8)[::-1]
    pk = np.full(mpad, -1, np.int64)
    pk[npad:] = starts
    l = np.zeros(mpad, np.int64)
    u = np.zeros(mpad, np.int64)
    if so == 0:
        l[npad:] = n_strings + np.arange(m)
        u[npad:] = l[npad:]
    else:
        u[npad:] = n_strings
    return buf, l, u, pk


def _reads(seed, n, lo=4, hi=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 6, size=int(rng.integers(lo, hi + 1))).astype(
        np.int8) for _ in range(n)]


def _plan_rounds(so, comm, mesh, rounds=8):
    """plan_round's outputs over ``rounds`` rounds of a second batch into a
    small index (frozen: the plan is a function of its inputs), through
    ``comm`` on this rank's blocks (mesh None: the whole batch)."""
    first, second = _reads(10 + so, 40), _reads(20 + so, 61)
    eng = TorchBwt(so=so, K=K, defer_r=0, device="cpu")
    eng.insert_multi(first)
    st = eng.state
    buf, l, u, pk = _layout(second, len(first), so, 1 if mesh is None
                            else mesh.d)
    if mesh is not None:
        buf, l, u, pk = (local_block(x, mesh) for x in (buf, l, u, pk))
    rd = bcr.ReadStates(*(torch.from_numpy(np.ascontiguousarray(x))
                          for x in (l, u, pk)))
    buf = torch.from_numpy(np.ascontiguousarray(buf))
    out = []
    psize, pcounts = st.psize, st.pcounts
    for r in range(rounds):
        rd, *rest = bcr.plan_round(
            psize, pcounts, rd, buf, r, r == 0,
            lambda g: rank_global(st.bwt, st.blk_prefix, g, K), so=so,
            comm=comm)
        out.append([rd.l, rd.u, rd.pk, *rest])
    return out


def _primitives(rank, d):
    """ShardComm's primitives against numpy on this rank's rows."""
    ml = 256
    m = d * ml
    rng = np.random.default_rng(2)
    x = rng.integers(0, 50, size=(m, 3))
    v = rng.integers(0, 40, size=m)
    dest = rng.permutation(m)
    q = rng.integers(0, m, size=m)
    key = rng.integers(0, 6, size=m)
    buf = rng.integers(-128, 128, size=8 * m).astype(np.int8)
    off = rng.integers(-10, 8 * m + 10, size=m)
    rows = slice(rank * ml, (rank + 1) * ml)

    def blk(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows]))

    def check(name, got, want):
        assert np.array_equal(got.numpy(), want[rows]), (name, rank)

    comm = ShardComm(None, ml, d)
    check("iota", comm.iota(ml, "cpu"), np.arange(m))
    check("cumsum", comm.scan(torch.cumsum, blk(x)), np.cumsum(x, 0))
    check("cumsum 1-D", comm.scan(torch.cumsum, blk(v)), np.cumsum(v))
    check("cummax", comm.scan(torch.cummax, blk(x)),
          np.maximum.accumulate(x, 0))
    check("cummin_rev", comm.scan(torch.cummin, blk(x), reverse=True),
          np.minimum.accumulate(x[::-1], 0)[::-1])
    want_roll = np.roll(v, 1)
    want_roll[0] = 0  # the first rank's first row has no left neighbour
    check("roll1", comm.roll1(blk(v)), want_roll)
    check("shift_up1", comm.shift_up1(blk(v > 20), True),
          np.concatenate([(v > 20)[1:], [True]]))
    want_perm = np.empty(m, np.int64)
    want_perm[dest] = v * 2 + 1
    perm = comm.permute(blk(dest), (blk(v), blk(v * 2 + 1)))
    check("permute", perm[1], want_perm)
    check("sort", torch.stack(comm.sort(blk(key), (blk(v), blk(x[:, 0]))),
                              1),
          np.stack([v, x[:, 0]], 1)[np.argsort(key, kind="stable")])
    check("fetch_syms", comm.fetch_syms(
        torch.from_numpy(buf[8 * ml * rank: 8 * ml * (rank + 1)]), blk(off)),
        buf[np.clip(off, 0, 8 * m - 1)].astype(np.int64))
    # routed answers land back at their rows: uniform, and skewed (every
    # row to the first or to the last rank, so that one pair fills all Q
    # slots)
    for name, tgt in (("uniform", q // ml), ("all to rank 0", 0 * q),
                      ("all to the last rank", 0 * q + d - 1)):
        rv, (rq,), route = comm.exchange(blk(tgt), None, [blk(q)])
        assert int(comm.sum_scalar(rv)) == m, name
        ans = torch.where(rv, rq * 2 + 7 + comm.s * 1000, -1)
        check(name, comm.reply(route, ans), q * 2 + 7 + tgt * 1000)
    # masked rows are not shipped
    valid = v % 3 != 0
    rv, (rq,), _ = comm.exchange(blk(q // ml), blk(valid), [blk(q)])
    mine = np.sort(q[valid & (q // ml == rank)])
    assert np.array_equal(np.sort(rq[rv].numpy()), mine), rank
    assert int(comm.sum_scalar(blk(v))) == int(v.sum())
    assert np.array_equal(comm.psum_array(blk(x).sum(0)).numpy(),
                          x.sum(0))


def _comm_world(rank, d):
    _primitives(rank, d)
    mesh = make_mesh(device="cpu")
    for so in (0, 1, 2):
        want = _plan_rounds(so, None, None)
        got = _plan_rounds(so, ShardComm(None, 64 // d, d), mesh)
        rows = slice(rank * 64 // d, (rank + 1) * 64 // d)
        for r, (g, w) in enumerate(zip(got, want)):
            for i, (a, b) in enumerate(zip(g, w)):
                b = b[rows] if i < 7 else b  # ins_bucket, n_ins: global
                assert torch.equal(a, b), (so, r, i, rank)


@pytest.mark.parametrize("d", [2, 4])
def test_shardcomm_matches_numpy_and_one_device(d, tmp_path):
    """ShardComm's primitives against numpy, and plan_round on d ranks'
    blocks against plan_round over the whole batch (so 0/1/2, 8 rounds:
    new read states, gX, sym, stream, active on each rank's rows, and the
    global ins_bucket and n_ins), on d gloo ranks."""
    join_world(start_world(_comm_world, d, tmp_path), timeout=240)


def test_local_comm_is_the_default():
    """plan_round(comm=LocalComm()) == plan_round(comm=None)."""
    for so in (0, 1, 2):
        got = _plan_rounds(so, LocalComm(), None)
        want = _plan_rounds(so, None, None)
        for g, w in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(g, w))


def test_shardcomm_at_a_world_of_one_is_local():
    """A ShardComm over a world of one (gloo, in this process) runs the
    same plan as LocalComm, round after round."""
    mesh = make_mesh(device="cpu")
    try:
        assert (mesh.s, mesh.d, mesh.owns_group) == (0, 1, True)
        for so in (0, 1, 2):
            got = _plan_rounds(so, ShardComm(None, 64, 1), mesh)
            want = _plan_rounds(so, None, None)
            for g, w in zip(got, want):
                assert all(torch.equal(a, b) for a, b in zip(g, w))
    finally:
        mesh.close()
    assert not dist.is_initialized()


def test_mesh_refuses_what_it_cannot_run(monkeypatch):
    """No card and no device: the mesh raises (no quiet move to the CPU);
    a world of one is not a mesh of two."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError, match="a mesh of 2 devices"):
        make_mesh(2, device="cpu")
    assert not dist.is_initialized()
