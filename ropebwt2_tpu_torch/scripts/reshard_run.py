"""The sharded engine grown without a plan: every rank inserts the same
BATCHES batches of uniform reads (seed SEED) into ShardedTorchBwt with no
up-front plan, so the index re-shards each time it outgrows its d windows
(ShardedTorchBwt._plan).  Each re-shard is timed on its own, with what its
collectives delivered to the rank and the device's peak while it ran.

    python -m ropebwt2_tpu_torch.scripts.reshard_run        # a world of one
    torchrun --standalone --nproc_per_node 4 \
        -m ropebwt2_tpu_torch.scripts.reshard_run

The ranks run on the cards (cuda:LOCAL_RANK over NCCL); with no card it
raises.  Rank 0 prints its record as the last line and writes it to
RESHARD_JSON (default smoke_out/reshard_run.json): per batch the wall,
lcap and n; per rank each re-shard (lcap before and after, n before it,
wall between barriers, each collective's elements and bytes received,
peak allocated during it, whether it received exactly its new window's
live symbols and the totals) and the run's peak; the md5 of the BWT in
the reference's text encoding.

Env: RESHARD_MBATCH (reads a batch, 2^20), RESHARD_L (read length, 101).
"""

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .common import device_label, out_path, power_limit, sync, timed_insert
from .readgen import ReadGen
from .scale_run import text_md5
from ..parallel import comm as comm_mod
from ..parallel.mesh import make_mesh
from ..parallel.sharded import ShardedTorchBwt

SEED, BATCHES = 15, 3

# the collectives of torch.distributed that a plan could issue; comm.py's
# all_gather is watched too, under the name "all_gather"
COLLECTIVES = ("all_to_all_single", "all_reduce", "broadcast", "recv",
               "all_gather_into_tensor", "batch_isend_irecv")


def read_batches(m, L):
    """The run's batches: BATCHES uniform (m, L) int8 read matrices, the
    same on every rank and for every engine."""
    gen = ReadGen(seed=SEED, nreads=BATCHES * m, L=L)
    for _ in range(BATCHES):
        yield gen.batch(m).view(np.int8)


def _received(name, args):
    """The tensors into which collective ``name`` called with ``args``
    receives."""
    if name == "batch_isend_irecv":
        return [op.tensor for op in args[0] if op.op is dist.irecv]
    return [args[0]]


class ReshardWatch:
    """Wraps eng._plan.  Every call appends to ``plans`` the collectives it
    issued, each as (name, elements received, bytes received): those of
    COLLECTIVES and comm.py's all_gather are wrapped while the call runs.
    A call that changes lcap also appends to ``records`` {lcap_from,
    lcap_to, n_from, wall_s, calls, recv_bytes, peak_b}.  The wall runs
    from a synchronisation and a barrier to a synchronisation and a
    barrier; recv_bytes sums the calls' bytes; peak_b is the device's peak
    allocated during the call (None on the CPU).  ``run_peak()`` is the
    peak of the whole run, the re-shards included."""

    def __init__(self, eng):
        self.eng, self.plans, self.records, self._peak = eng, [], [], 0
        self._cuda = eng.device.type == "cuda"
        plan = eng._plan

        def watched(*a, **k):
            got = []

            def tap(name, fn):
                def wrapped(*b, **kw):
                    ts = _received(name, b)
                    got.append((name, sum(t.numel() for t in ts),
                                sum(t.numel() * t.element_size()
                                    for t in ts)))
                    return fn(*b, **kw)
                return wrapped

            lcap0, n0 = eng._lcap, eng.n
            self._fence()
            if self._cuda:
                self._peak = max(self._peak, torch.cuda.max_memory_allocated(
                    eng.device))
                torch.cuda.reset_peak_memory_stats(eng.device)
            saved = {name: getattr(dist, name) for name in COLLECTIVES}
            saved_gather = comm_mod._ALL_GATHER
            for name, fn in saved.items():
                setattr(dist, name, tap(name, fn))
            comm_mod._ALL_GATHER = tap("all_gather", saved_gather)
            t0 = time.perf_counter()
            try:
                return plan(*a, **k)
            finally:
                for name, fn in saved.items():
                    setattr(dist, name, fn)
                comm_mod._ALL_GATHER = saved_gather
                self._fence()
                wall = time.perf_counter() - t0
                self.plans.append(got)
                if eng._lcap != lcap0:
                    self.records.append({
                        "lcap_from": lcap0, "lcap_to": eng._lcap,
                        "n_from": n0, "wall_s": wall, "calls": got,
                        "recv_bytes": sum(b for _, _, b in got),
                        "peak_b": torch.cuda.max_memory_allocated(eng.device)
                        if self._cuda else None})

        eng._plan = watched

    def _fence(self):
        sync(self.eng.device)
        if self.eng.d > 1:
            dist.barrier(group=self.eng.mesh.group)

    def run_peak(self):
        if not self._cuda:
            return None
        return max(self._peak, torch.cuda.max_memory_allocated(
            self.eng.device))


def received_exactly(r, d, s):
    """Whether re-shard record ``r`` of rank s of d received exactly the
    live symbols of its new window (in one all_to_all, where the index
    held symbols before it) and the (d, 6) window totals, nothing more."""
    live = min(r["lcap_to"], max(0, r["n_from"] - s * r["lcap_to"]))
    moved = [b for name, _, b in r["calls"] if name == "all_to_all_single"]
    rest = [(name, k) for name, k, _ in r["calls"]
            if name != "all_to_all_single"]
    return moved == ([live] if r["lcap_from"] and r["n_from"] else []) and \
        rest == [("all_gather", d * 6)]


def grow(eng, batches):
    """Insert ``batches`` into ``eng`` with no plan, each timed by
    common.timed_insert; returns (ReshardWatch, [(wall s, lcap, n) per
    batch])."""
    watch = ReshardWatch(eng)
    if watch._cuda:
        torch.cuda.reset_peak_memory_stats(eng.device)
    rows = []
    for reads in batches:
        wall, _ = timed_insert(eng, reads)
        rows.append((wall, eng._lcap, eng.n))
    return watch, rows


def main(device=None):
    """The run on this rank; returns rank 0's record (None elsewhere)."""
    m = int(os.environ.get("RESHARD_MBATCH", 1 << 20))
    L = int(os.environ.get("RESHARD_L", 101))
    mesh = make_mesh(device=device)
    try:
        eng = ShardedTorchBwt(so=1, K=128, mesh=mesh)
        t0 = time.perf_counter()
        watch, rows = grow(eng, read_batches(m, L))
        build_s = time.perf_counter() - t0
        mine = {"rank": mesh.s, "peak_b": watch.run_peak(),
                "reshards": [dict(r, exact=received_exactly(r, mesh.d,
                                                            mesh.s))
                             for r in watch.records]}
        ranks = [None] * mesh.d
        dist.all_gather_object(ranks, mine, group=mesh.group)
        bwt = eng.bwt_array()
        counts = eng.counts()
    finally:
        mesh.close()
    if mesh.s != 0:
        return None
    dev = mesh.device
    rec = {"device": device_label(dev), "power_limit": power_limit(dev),
           "d": mesh.d, "mbatch": m, "batches": BATCHES, "L": L,
           "seed": SEED, "n": int(counts.sum()),
           "counts_ok": int(counts[0]) == BATCHES * m
           and int(counts.sum()) == BATCHES * m * (L + 1),
           "build_s": build_s,
           "batch": [{"wall_s": w, "lcap": lc, "n": n} for w, lc, n in rows],
           "ranks": ranks, "bwt_md5": text_md5(bwt)}
    with open(out_path("RESHARD_JSON", "reshard_run.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    r = main()
    if r is not None:
        print(json.dumps(r))
