"""Peak device memory and walls of the one-card flat and packed build
paths at the benchmark's shapes, so that two trees of the port can be
held against each other on one card.

Memory is read three ways after the batches: torch.cuda.max_memory_
allocated (what the benchmark's ``peak_device_gib`` reads),
torch.cuda.max_memory_reserved (what the caching allocator held at most,
the CUDA graphs' memory pool with it) and the card's used memory
(torch.cuda.mem_get_info, the CUDA context and every pool with it).

    python -m ropebwt2_tpu_torch.scripts.peak_memory [PATH ...]

PATH is one of ``sustained_m20``, ``sustained_m17`` and ``capacity``
(default: all three, each in a fresh process), the cells of those names
in BENCHMARK.json: their lanes, planned batches, untimed and timed
batches and engine (RLO, K 128, R and pcap from _choose_defer, pack4
"auto"), on uniform reads x 101 from numpy's default_rng(SEED, path,
batch).  It calls only TorchBwt's plan, insert_multi and bwt_array, so
that it runs against an older tree of the port as well: copy it there
and run it from that tree's root.  Prints one JSON line a path: the
three memory figures (bytes), the timed batches' walls, the BWT's md5,
and the card's name and power limit."""

import hashlib
import json
import subprocess
import sys
import time

import numpy as np

SEED = 19
L = 101
# path: (lanes, batches planned, untimed, timed), as BENCHMARK.json's cells
PATHS = {"sustained_m20": (1 << 20, 12, 8, 3),
         "sustained_m17": (1 << 17, 80, 64, 16),
         "capacity": (1 << 20, 21, 0, 21)}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def run(path: str) -> dict:
    import torch

    from ropebwt2_tpu_torch.engine import TorchBwt

    m, planned, pre, timed = PATHS[path]
    dev = torch.device("cuda")
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = TorchBwt(so=1, K=128, defer_r=None, device=dev, pack4="auto")
    eng.plan(planned * m * (L + 1))
    walls = []
    for i in range(pre + timed):
        batch = np.random.default_rng([SEED, len(path), i]).integers(
            1, 5, (m, L), dtype=np.int8)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        eng.insert_multi(batch)
        torch.cuda.synchronize(dev)
        if i >= pre:
            walls.append(time.perf_counter() - t0)
    free, total = torch.cuda.mem_get_info(dev)
    out = {"path": path, "tier": type(eng.state).__name__,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "max_memory_reserved": torch.cuda.max_memory_reserved(dev),
           "device_used_after": total - free,
           "walls_s": walls, "msym_s": m * (L + 1) * timed / sum(walls)
           / 1e6,
           "md5": hashlib.md5(eng.bwt_array().tobytes()).hexdigest(),
           "card": smi()}
    return out


def main(argv):
    names = argv or list(PATHS)
    bad = [p for p in names if p not in PATHS]
    if bad:
        sys.exit(f"peak_memory: unknown paths {bad}; known: {list(PATHS)}")
    if len(names) == 1:
        import torch

        if not torch.cuda.is_available():
            sys.exit("peak_memory: needs a CUDA device")
        print(json.dumps(run(names[0])), flush=True)
        return
    for p in names:  # each path in a fresh process: peaks of its own
        rc = subprocess.run([sys.executable, "-m",
                             "ropebwt2_tpu_torch.scripts.peak_memory", p],
                            check=False).returncode
        if rc:
            sys.exit(rc)


if __name__ == "__main__":
    main(sys.argv[1:])
