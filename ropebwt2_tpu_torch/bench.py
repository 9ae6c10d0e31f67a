"""Benchmark of the port: BCR construction and FM-query throughput on one
NVIDIA H100 (counterpart of the root bench.py, with its regimes, stages,
inputs, knobs and output line).

    python -m ropebwt2_tpu_torch.bench

Both construction regimes and the query metrics:

* sustained: the headline ``value``.  Batches inserted into an index
  prefilled to BENCH_PREFILL_X times the batch and planned for every batch
  of the run: the steady state a full build spends its time in;
* batch: one batch into an empty index, BENCH_RUNS times on fresh
  engines (best wall); the first run is the warm-up, reported apart
  (``warmup_s``: the kernels' build or load, the process's lazy CUDA
  set-up and the batch);
* rank_queries, extend and backward_search: chained 6-symbol ranks,
  chained backward extensions (rld_extend's step) and 31-symbol backward
  searches over the sustained index, through the query API's tier
  dispatch (engine/query.py), so they run over whichever tier was built.

The reads are drawn with readgen.ReadGen(seed=0): BENCH_DATA=coverage
(default) samples them from one genome at 47x with 1% substitution errors,
the shape of the reference's own benchmark sets; uniform gives i.i.d.
reads.  The query inputs come from numpy's default_rng(1) in the JAX
bench's order (rank positions, extend starts, patterns), so the port asks
the JAX bench's questions.  A batch's wall is the host clock around
insert_multi, closed by a device synchronisation and counts(); a query
stage's is the best of 3 runs after a warm-up, each closed by a
synchronisation.

Baseline: the reference's worm RLO row (66.8M x 100 bp in 506 s wall on a
48-core Xeon = 13.2 Msym/s), a CPU number, kept as the JAX bench keeps it.

The device work runs in a child process that prints a RESULT line after
every stage, each richer than the last; this process keeps the freshest,
kills the child 45 s before BENCH_TIMEOUT, and prints it as the last line
(with ``degraded`` naming the stage it stopped before).  A child that
fails (a self-check, an error) leaves its freshest line with an ``error``
key and a nonzero exit, so that a failure never reads as a result.  With
no card the child refuses to run, and the last line is an error object
(``value`` 0.0, ``error``) with a nonzero exit: there is no fallback to
the CPU.
BENCH_CPU=1 runs on the CPU with the kernels' plain versions, at the
caller's explicit request (the tests do, at small sizes).

Env knobs: BENCH_M (reads a batch, 2^17), BENCH_L (read length, 101),
BENCH_SO (0/1/2, 1), BENCH_RUNS (timed batch runs, 5), BENCH_PREFILL_X
(8), BENCH_SUSTAIN_RUNS (2), BENCH_TIMEOUT (s, 1500), BENCH_CPU=1,
BENCH_K (block size, 128), BENCH_DATA (coverage|uniform), BENCH_COV (47),
BENCH_ERR (0.01); the index tier as the CLI maps it (ROPEBWT2_TPU_DEFER_R,
_PACK4, _RUNS, _RUNS_MARGIN, _RUNS_RCAP).  The query stages ask Q = 2^18
ranks and extensions and Q / 4 backward searches, as the JAX bench does.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from . import _build
from .cli import engine_options
from .engine import TorchBwt, query
from .scripts.common import (
    device_label, launch_counts, launches_since, power_limit,
    sync, timed_insert,
)
from .scripts.readgen import ReadGen

BASELINE = 13.2e6  # ropebwt2 worm-RLO wall symbols/s (BASELINE.md)
METRIC = "bcr_insert_throughput_rlo"
INNER = "ROPEBWT2_TPU_BENCH_INNER"  # set in the child that does the work
Q = 1 << 18  # rank and extend queries; backward_search takes Q / 4
ITERS = 32  # chained steps of the rank and extend stages
PLEN = 31  # backward_search pattern length
REPS = 3  # timed runs of a query stage, after one warm-up


@dataclasses.dataclass
class Config:
    """The run's knobs, with the JAX bench's defaults."""
    M: int = 1 << 17
    L: int = 101
    so: int = 1
    runs: int = 5
    K: int = 128
    prefill_x: int = 8
    sustain_runs: int = 2
    data: str = "coverage"
    cov: float = 47.0
    err: float = 0.01

    ENV = {"M": "BENCH_M", "L": "BENCH_L", "so": "BENCH_SO",
           "runs": "BENCH_RUNS", "K": "BENCH_K",
           "prefill_x": "BENCH_PREFILL_X",
           "sustain_runs": "BENCH_SUSTAIN_RUNS", "data": "BENCH_DATA",
           "cov": "BENCH_COV", "err": "BENCH_ERR"}

    @classmethod
    def from_env(cls):
        """The knobs set in the environment, the defaults elsewhere."""
        kw = {f.name: f.type(os.environ[cls.ENV[f.name]])
              for f in dataclasses.fields(cls)
              if cls.ENV[f.name] in os.environ}
        return cls(**kw)

    @property
    def syms(self):
        return self.M * (self.L + 1)


# ---------------------------------------------------------------- stages

def reads_gen(cfg):
    """The read stream of every batch of the run (the batch regime's
    batch first, then the sustained regime's, drawn fresh)."""
    nbatches = 1 + cfg.prefill_x + cfg.sustain_runs
    return ReadGen(seed=0, nreads=cfg.M * nbatches, L=cfg.L, mode=cfg.data,
                   cov=cfg.cov, err=cfg.err)


def new_engine(cfg, device, **tier):
    """A fresh TorchBwt with the run's sorting order, K and index tier
    (the environment's, as the CLI maps it, overridden by ``tier``)."""
    return TorchBwt(so=cfg.so, K=cfg.K, device=device,
                    **{**engine_options(), **tier})


def check_counts(cnt, reads, syms):
    if int(cnt[0]) != reads or int(cnt.sum()) != syms:
        raise RuntimeError(f"self-check failed: counts {cnt.tolist()}")


def batch_run(cfg, reads, device):
    """The batch regime once: ``reads`` into a fresh, empty index; returns
    its wall."""
    eng = new_engine(cfg, device)
    wall, cnt = timed_insert(eng, reads)
    check_counts(cnt, cfg.M, cfg.syms)
    return wall


def sustained_engine(cfg, device, **tier):
    """A fresh index planned for every batch of the sustained regime and
    one more, as the JAX bench plans it."""
    eng = new_engine(cfg, device, **tier)
    eng.plan((cfg.prefill_x + cfg.sustain_runs + 1) * cfg.syms)
    return eng


def prefill(eng, batches):
    """Insert the prefill batches; returns their wall (ended by counts)."""
    t0 = time.perf_counter()
    for bt in batches:
        eng.insert_multi(bt)
    sync(eng.device)
    eng.counts()
    return time.perf_counter() - t0


def stage_sustained(cfg, gen, device, log=None):
    """The sustained regime: plan, BENCH_PREFILL_X prefill batches and
    BENCH_SUSTAIN_RUNS timed ones, each drawn fresh from ``gen``; returns
    (engine, {"thr", "prefill_sym", "batches", "walls", "prefill_s"})."""
    eng = sustained_engine(cfg, device)
    pre = prefill(eng, (gen.batch(cfg.M).view(np.int8)
                        for _ in range(cfg.prefill_x)))
    if log:
        log(f"prefill {cfg.prefill_x} batches: {pre:.1f}s")
    walls = []
    for i in range(cfg.sustain_runs):
        bt = gen.batch(cfg.M).view(np.int8)
        wall, cnt = timed_insert(eng, bt)
        walls.append(wall)
        if log:
            log(f"sustained run {i + 1}/{cfg.sustain_runs}: {wall:.2f}s")
    done = cfg.prefill_x + cfg.sustain_runs
    check_counts(eng.counts(), cfg.M * done, cfg.syms * done)
    return eng, {"thr": cfg.syms / min(walls), "walls": walls,
                 "prefill_sym": cfg.prefill_x * cfg.syms,
                 "batches": cfg.sustain_runs, "prefill_s": pre}


def query_inputs(rng, n, q):
    """The query stages' inputs, drawn from ``rng`` in the JAX bench's
    order: q sorted rank positions in [0, n), q sorted extend starts in
    [0, n - 200), and q / 4 patterns of PLEN symbols."""
    qpos = np.sort(rng.integers(0, n, q))
    starts = np.sort(rng.integers(0, n - 200, q))
    pats = rng.integers(1, 5, size=(q // 4, PLEN)).astype(np.int32)
    return qpos, starts, pats


def best_of(fn, device, reps=REPS):
    """(fn()'s result, best wall s of ``reps`` runs after a warm-up), each
    run closed by a device synchronisation."""
    out = fn()
    sync(device)
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return out, best


def rank_chain(st, n, pos, iters=ITERS):
    """``iters`` chained ranks: pos <- clip(pos + (occ[$] & 1), 0, n - 1)."""
    p = pos
    for _ in range(iters):
        occ = query.rank1a(st, p)
        p = (p + (occ[:, 0] & 1)).clamp(0, n - 1)
    return p


def extend_chain(st, n, ik, iters=ITERS):
    """``iters`` chained backward extension steps of bi-intervals (x0, x1,
    size): step i extends by symbol a = i % 4 + 1 to (C[a] + occ_a(x0),
    x1, max(size_a, 1)), the rank at min(x0 + size, n), so that the chain
    stays alive (bench.py's inline rld_extend step)."""
    tot = st.pcounts.sum(dim=0)
    C = torch.cat([tot.new_zeros(1), torch.cumsum(tot, 0)])
    for i in range(iters):
        p = ik[:, 0]
        tk, tl = query.rank2a(st, p, (p + ik[:, 2]).clamp(max=n))
        a = i % 4 + 1
        ik = torch.stack([C[a] + tk[:, a], ik[:, 1],
                          (tl[:, a] - tk[:, a]).clamp(min=1)], dim=1)
    return ik


def stage_rank(st, n, qpos, device):
    """(final positions, best wall) of rank_chain from ``qpos``."""
    pos = torch.as_tensor(qpos, dtype=torch.int64, device=device)
    return best_of(lambda: rank_chain(st, n, pos), device)


def stage_extend(st, n, starts, device):
    """(final bi-intervals, best wall) of extend_chain from (start, 0,
    100) at each of ``starts``."""
    s = torch.as_tensor(starts, dtype=torch.int64, device=device)
    ik = torch.stack([s, torch.zeros_like(s), torch.full_like(s, 100)], 1)
    return best_of(lambda: extend_chain(st, n, ik), device)


def stage_bsearch(st, pats, device):
    """((lo, hi), best wall) of backward_search of ``pats`` (all PLEN
    symbols long)."""
    p = torch.as_tensor(pats, dtype=torch.int64, device=device)
    lens = torch.full((p.shape[0],), p.shape[1], dtype=torch.int64,
                      device=device)
    return best_of(lambda: query.backward_search(st, p, lens), device)


# ---------------------------------------------------------------- child

def report(cfg, state, dev_label, power):
    """The result object of what the stages measured so far (the JAX
    bench's keys and nesting, with the card's power limit)."""
    t = state["batch_t"]
    syms = cfg.syms
    detail = {
        "reads": cfg.M,
        "read_len": cfg.L,
        "sorting_order": cfg.so,
        "K": cfg.K,
        "device": dev_label,
        "power_limit": power,
        "data": cfg.data,
        "baseline":
            "ropebwt2 -brRm10g worm 13.2 Msym/s wall (README.md:176)",
        "batch": {
            "value": round(syms / t, 1),
            "unit": "symbols/s/chip",
            "vs_baseline": round(syms / t / BASELINE, 3),
            "wall_s": round(t, 4),
            "timed_runs": state["batch_runs"],
            "regime": "one batch into an empty index (merge traffic ~ "
                      "batch size)",
        },
    }
    if state["sustained"] is not None:
        sv = state["sustained"]
        value = sv["thr"]
        detail["regime"] = (
            f"sustained: batches into a ~{cfg.prefill_x}x-batch "
            "prefilled index (steady-state of a full build)")
        detail["prefill_symbols"] = sv["prefill_sym"]
        detail["timed_batches"] = sv["batches"]
    else:
        value = syms / t
        detail["regime"] = ("batch (sustained stage pending; value will "
                            "switch to the sustained number)")
    if state["warmup_s"] is not None:
        detail["warmup_s"] = round(state["warmup_s"], 1)
        detail["build_s"] = state["build_s"]
    if state["rank"] is not None:
        rv = state["rank"]
        detail["rank_queries"] = {
            "value": round(rv["qps"], 1),
            "unit": "queries/s/chip (6-symbol rank, batched)",
            "index_symbols": rv["n"],
            "batch_queries": rv["q"],
        }
    if state["extend"] is not None:
        ev = state["extend"]
        detail["extend"] = {
            "value": round(ev["qps"], 1),
            "unit": "bi-interval extensions/s/chip (rld_extend batched)",
            "batch_queries": ev["q"],
        }
    if state["bsearch"] is not None:
        bv = state["bsearch"]
        detail["backward_search"] = {
            "value": round(bv["sps"], 1),
            "unit": "pattern symbols/s/chip (backward search steps)",
            "patterns": bv["q"],
            "pattern_len": bv["plen"],
        }
    detail["launches"] = state["launches"]
    obj = {
        "metric": METRIC,
        "value": round(value, 1),
        "unit": "symbols/s/chip",
        "vs_baseline": round(value / BASELINE, 3),
        "detail": detail,
    }
    if state["degraded"]:
        obj["degraded"] = state["degraded"]
    return obj


def inner(cfg):
    """The child: every stage in order, a RESULT line after each."""
    if os.environ.get("BENCH_CPU") == "1":
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    else:
        print("[bench] no CUDA device; refusing to run on the CPU (set "
              "BENCH_CPU=1 to ask for it)", file=sys.stderr)
        return 2
    dev_label, power = device_label(dev), power_limit(dev)

    def log(msg):
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    def emit():
        print("RESULT " + json.dumps(report(cfg, state, dev_label, power)),
              flush=True)

    state = {"batch_t": None, "batch_runs": 0, "degraded": None,
             "sustained": None, "rank": None, "warmup_s": None,
             "build_s": None, "extend": None, "bsearch": None,
             "launches": {}}
    gen = reads_gen(cfg)
    rng = np.random.default_rng(1)  # the query stages' inputs
    reads = gen.batch(cfg.M).view(np.int8)

    t0 = time.perf_counter()
    if dev.type == "cuda":  # the kernels' build (or load of a cached one)
        _build.lib()
        state["build_s"] = round(time.perf_counter() - t0, 3)
    t_warm = time.perf_counter() - t0 + batch_run(cfg, reads, dev)
    log(f"warmup (build, set-up and one batch): {t_warm:.1f}s on "
        f"{dev_label}")
    state.update(batch_t=t_warm, warmup_s=t_warm,
                 degraded="warmup-includes-build")
    emit()

    before = launch_counts()
    best = None
    for i in range(cfg.runs):
        t = batch_run(cfg, reads, dev)
        best = t if best is None else min(best, t)
        log(f"run {i + 1}/{cfg.runs}: {t:.3f}s (best {best:.3f}s)")
        state.update(batch_t=best, batch_runs=i + 1,
                     degraded="batch-stage-partial" if i < cfg.runs - 1
                     else "sustained-stage-pending")
        state["launches"]["batch"] = launches_since(before)
        emit()

    before = launch_counts()
    eng, sv = stage_sustained(cfg, gen, dev, log)
    state["launches"]["sustained"] = launches_since(before)
    state.update(sustained=sv, degraded="rank-stage-pending")
    emit()

    n = eng.n
    qpos, starts, pats = query_inputs(rng, n, Q)
    st = eng.state
    _, dt = stage_rank(st, n, qpos, dev)
    state.update(rank={"qps": Q * ITERS / dt, "n": n, "q": Q},
                 degraded="extend-stage-pending")
    log(f"rank: {Q * ITERS / dt / 1e6:.1f} Mq/s over n={n / 1e6:.0f}M")
    emit()

    _, dt = stage_extend(st, n, starts, dev)
    state.update(extend={"qps": Q * ITERS / dt, "q": Q},
                 degraded="bsearch-stage-pending")
    log(f"extend: {Q * ITERS / dt / 1e6:.1f} M ext/s")
    emit()

    _, dt = stage_bsearch(st, pats, dev)
    qb = pats.shape[0]
    state.update(bsearch={"sps": qb * PLEN / dt, "q": qb, "plen": PLEN},
                 degraded=None)
    log(f"backward_search: {qb * PLEN / dt / 1e6:.1f} M sym-steps/s")
    emit()
    return 0


# ---------------------------------------------------------------- parent

def run_child(deadline):
    """Run the stages in a child, keeping its freshest RESULT line; returns
    (that line or None, the child's exit code or "timeout")."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env[INNER] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    p = subprocess.Popen([sys.executable, "-m", "ropebwt2_tpu_torch.bench"],
                         env=env, stdout=subprocess.PIPE, stderr=sys.stderr,
                         text=True)
    last = [None]

    def reader():
        for line in p.stdout:
            if line.startswith("RESULT "):
                last[0] = line[len("RESULT "):].strip()

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    while True:
        rc = p.poll()
        if rc is not None:
            th.join(5)
            return last[0], rc
        if time.time() > deadline:
            p.kill()
            p.wait()
            th.join(5)
            return last[0], "timeout"
        time.sleep(0.5)


def main():
    """The parent: the child's freshest line (exit 0), that line with an
    ``error`` key when the child failed after it (exit 1), or the error
    object (exit 1) when the child gave no line.  A child killed at the
    deadline leaves its line as it was, with ``degraded``."""
    timeout = float(os.environ.get("BENCH_TIMEOUT", 1500))
    t0 = time.time()
    result, rc = run_child(t0 + timeout - 45)
    if rc != 0:
        print(f"[bench] device child ended with {rc}", file=sys.stderr)
    if result is not None:
        if rc in (0, "timeout"):
            print(result)
            return 0
        obj = json.loads(result)
        obj["error"] = f"the device child failed after this line (exit {rc})"
        print(json.dumps(obj))
        return 1
    print(json.dumps({
        "metric": METRIC,
        "value": 0.0,
        "unit": "symbols/s/chip",
        "vs_baseline": 0.0,
        "error": (f"no result within {timeout:.0f}s" if rc == "timeout"
                  else f"the device child gave no result (exit {rc})"),
    }))
    return 1


if __name__ == "__main__":
    if os.environ.get(INNER) == "1":
        sys.exit(inner(Config.from_env()))
    sys.exit(main())
