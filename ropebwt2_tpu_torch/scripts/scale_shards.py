"""Weak-scaling parity check of the port's sharded engine (counterpart of
scripts/scale_shards.py): fixed per-shard work (WEAK_M0 reads a rank),
worlds of D = 1, 2 and 4 ranks, one process a rank.

    python -m ropebwt2_tpu_torch.scripts.scale_shards

By default the ranks run on the cards, rank r on cuda:r over NCCL, in the
worlds of 1, 2 and 4 that the host's cards can hold; with no card it
raises.  WEAK_CPU=1 asks for gloo ranks on the CPU instead (one torch
thread a rank), the counterpart of the JAX script's virtual CPU mesh.  At
each D, rank 0's BWT of ShardedTorchBwt must equal TorchBwt's on the same
reads and device.  A world is D fresh processes (torch.multiprocessing,
spawn) over a file store in a temporary directory; its wall (rank 0's
insert_multi and export) checks that per-rank work stays flat as D
grows.  On the CPU the ranks share its cores, so its walls are no claim
about the card.

Env: WEAK_M0 (reads a rank, 2048), WEAK_L (64), WEAK_CPU (1: the CPU).
"""

import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .common import device_label, power_limit
from ..engine.bcr import TorchBwt
from ..parallel.sharded import ShardedTorchBwt

WORLDS = (1, 2, 4)


def _rank(rank, d, store, cpu, reads, out):
    """One rank of a world of d: the sharded build on cuda:rank over NCCL
    (or on the CPU over gloo); rank 0 saves its BWT and wall to ``out``
    (.npz)."""
    if cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"file://{store}", rank=rank,
                            world_size=d)
    try:
        eng = ShardedTorchBwt(so=1, K=256, device=dev)
        t0 = time.perf_counter()
        eng.insert_multi(list(reads))
        got = eng.bwt_array()
        if rank == 0:
            np.savez(out, bwt=got, wall=time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()


def run_world(d, reads, cpu=False, timeout=600):
    """(rank 0's BWT, its wall s) of the sharded build of ``reads`` on a
    world of d ranks: on cards 0 .. d-1, or on the CPU if ``cpu``."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.npz")
        ctx = mp.start_processes(
            _rank, args=(d, os.path.join(tmp, "store"), cpu, reads, out),
            nprocs=d, join=False, start_method="spawn")
        t0 = time.monotonic()
        while not ctx.join(timeout=5):
            if time.monotonic() - t0 > timeout:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"the world of {d} ran past {timeout} s")
        with np.load(out) as r:
            return r["bwt"], float(r["wall"])


def main():
    """Every world's parity; returns [(d, symbols, wall s, rank 0's BWT)]
    and raises on the first world whose BWT differs."""
    m0 = int(os.environ.get("WEAK_M0", 2048))
    L = int(os.environ.get("WEAK_L", 64))
    cpu = os.environ.get("WEAK_CPU") == "1"
    if cpu:
        dev, worlds = torch.device("cpu"), WORLDS
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
        worlds = [d for d in WORLDS if d <= torch.cuda.device_count()]
    else:
        raise RuntimeError("scale_shards: no CUDA device; set WEAK_CPU=1 "
                           "to run its ranks on the CPU over gloo")
    rng = np.random.default_rng(3)
    print(f"WEAK per-shard reads={m0} L={L} (weak scaling: total = D*m0) "
          f"on {device_label(dev)} ({power_limit(dev)}), worlds {worlds}",
          flush=True)
    rows = []
    for d in worlds:
        reads = rng.integers(1, 5, size=(d * m0, L)).astype(np.int8)
        got, wall = run_world(d, reads, cpu)
        ref = TorchBwt(so=1, K=256, device=dev)
        ref.insert_multi(reads)
        ok = np.array_equal(got, ref.bwt_array())
        syms = d * m0 * (L + 1)
        print(f"WEAK D={d}: {syms} syms in {wall:.2f}s "
              f"parity={'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"the sharded BWT differs at D={d}")
        rows.append((d, syms, wall, got))
    return rows


if __name__ == "__main__":
    main()
