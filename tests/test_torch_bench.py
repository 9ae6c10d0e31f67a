"""The port's bench (ropebwt2_tpu_torch/bench.py) on the CPU
(BENCH_CPU=1, M = 2^10, PREFILL_X = 2, 2048 queries in place of the 2^18
that the CPU cannot answer in the suite's time): its sustained index
equals a TpuBwt built on the same reads, and its rank, extend and
backward_search stages give what bench.py:222-323's expressions give over
that TpuBwt (rebuilt here with rank_global and backward_search on the same
inputs, drawn in the same order); the bench as a user runs it exits
nonzero with the error object as its last line when there is no card and
no BENCH_CPU; its child's last line with BENCH_CPU=1 has every key; and
the parent turns a failed child into an ``error`` line and a nonzero
exit.

Tolerance 0: every compared value is an integer.  The JAX positions are
int32 and the port's int64, so values are compared, not dtypes."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ropebwt2_tpu.engine import TpuBwt
from ropebwt2_tpu.engine import query as jq
from ropebwt2_tpu.index.rank import rank_global
from ropebwt2_tpu.index.scan import cumsum_small

from ropebwt2_tpu_torch import bench

REPO = Path(__file__).resolve().parents[1]
SMALL = {"BENCH_M": "1024", "BENCH_PREFILL_X": "2", "BENCH_RUNS": "1",
         "BENCH_SUSTAIN_RUNS": "1"}
Q = 2048


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small torch ops on one thread: the suite runs on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_queries(st, n, K, qpos, starts, pats, iters):
    """bench.py's rank, extend and backward_search stages over a TpuBwt
    state (its jitted loops, with the same inputs)."""
    @jax.jit
    def qloop(bwt, blk, g):
        def body(i, g):
            occ = rank_global(bwt, blk, g, K)
            return jnp.clip(g + (occ[:, 0] & 1), 0, n - 1)
        return jax.lax.fori_loop(0, iters, body, g)

    pdt = st.blk_prefix.dtype
    Cvec = jnp.concatenate(
        [jnp.zeros(1, jnp.int64), cumsum_small(st.pcounts.sum(axis=0))]
    ).astype(pdt)

    @jax.jit
    def eloop(bwt, blk, ik):
        def body(i, ik):
            p = ik[:, 0]
            tk = rank_global(bwt, blk, p, K)
            tl = rank_global(bwt, blk, jnp.minimum(p + ik[:, 2], n), K)
            size = tl - tk
            a = (i % 4) + 1
            x0 = Cvec[a] + tk[:, a]
            keep = ik[:, 1]
            sz = jnp.maximum(size[:, a], 1)
            return jnp.stack([x0, keep, sz], axis=1)
        return jax.lax.fori_loop(0, iters, body, ik)

    ranks = qloop(st.bwt, st.blk_prefix, jnp.asarray(qpos.astype(np.int32)))
    ik0 = jnp.stack([jnp.asarray(starts, pdt), jnp.zeros(len(starts), pdt),
                     jnp.full(len(starts), 100, pdt)], axis=1)
    ext = eloop(st.bwt, st.blk_prefix, ik0)
    lo, hi = jq.backward_search(st, jnp.asarray(pats),
                                jnp.full(len(pats), pats.shape[1], np.int32))
    return [np.asarray(x).astype(np.int64) for x in (ranks, ext, lo, hi)]


def test_stages_ask_and_answer_the_jax_bench_questions(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    cfg = bench.Config.from_env()
    assert (cfg.M, cfg.prefill_x, cfg.sustain_runs) == (1024, 2, 1)
    gen = bench.reads_gen(cfg)
    first = gen.batch(cfg.M).view(np.int8)
    assert bench.batch_run(cfg, first, "cpu") > 0
    eng, sv = bench.stage_sustained(cfg, gen, "cpu")
    assert sv["batches"] == 1 and sv["prefill_sym"] == 2 * cfg.syms
    n = eng.n
    assert n == 3 * cfg.syms

    # the JAX bench's index: the same reads, planned the same way
    ref_gen = bench.reads_gen(cfg)
    ref_gen.batch(cfg.M)
    ref = TpuBwt(so=1, K=cfg.K)
    ref._plan(4 * cfg.syms)
    for _ in range(3):
        ref.insert_multi(ref_gen.batch(cfg.M).view(np.int8))
    assert np.array_equal(eng.bwt_array(), ref.bwt_array())

    qpos, starts, pats = bench.query_inputs(np.random.default_rng(1), n, Q)
    rng = np.random.default_rng(1)  # bench.py's draws, in its order
    assert np.array_equal(qpos, np.sort(rng.integers(0, n, Q)))
    assert np.array_equal(starts, np.sort(rng.integers(0, n - 200, Q)))
    assert np.array_equal(pats, rng.integers(1, 5, size=(Q // 4, 31)))

    st = eng.state
    ranks, t_r = bench.stage_rank(st, n, qpos, "cpu")
    ext, t_e = bench.stage_extend(st, n, starts, "cpu")
    (lo, hi), t_b = bench.stage_bsearch(st, pats, "cpu")
    assert min(t_r, t_e, t_b) > 0
    want = jax_queries(ref.state, n, cfg.K, qpos, starts, pats, bench.ITERS)
    for got, w in zip((ranks, ext, lo, hi), want):
        assert np.array_equal(got.numpy(), w)
    assert int((hi - lo).max()) >= 0 and ext.shape == (Q, 3)


def run_bench(env_extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    env.update(env_extra)
    return subprocess.run([sys.executable, "-m", "ropebwt2_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_bench_without_a_card_prints_the_error_object():
    r = run_bench({"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["value"] == 0.0 and "error" in last
    assert last["metric"] == bench.METRIC
    assert "no CUDA device" in r.stderr


def test_bench_on_the_cpu_prints_every_key(monkeypatch, capsys):
    """The child's stages in this process at 2048 queries: its last RESULT
    line (what the parent prints) has every key."""
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_CPU", "1")
    monkeypatch.setattr(bench, "Q", Q)
    assert bench.inner(bench.Config.from_env()) == 0
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("RESULT ")]
    assert len(lines) == 6  # warm-up, batch run, sustained, three queries
    last = json.loads(lines[-1][len("RESULT "):])
    assert "degraded" not in last and "error" not in last
    assert last["metric"] == "bcr_insert_throughput_rlo"
    assert last["unit"] == "symbols/s/chip"
    d = last["detail"]
    for k in ("batch", "warmup_s", "rank_queries", "extend",
              "backward_search", "device", "power_limit", "regime",
              "prefill_symbols", "timed_batches", "launches"):
        assert k in d, k
    assert d["device"] == "cpu" and d["power_limit"] is None
    assert d["batch"]["timed_runs"] == 1
    assert d["rank_queries"]["batch_queries"] == Q
    assert d["backward_search"]["patterns"] == Q // 4
    assert last["value"] > 0 and last["vs_baseline"] == round(
        last["value"] / bench.BASELINE, 3)


@pytest.mark.parametrize("rc", [0, "timeout", 1])
def test_a_failed_child_never_reads_as_a_result(rc, monkeypatch, capsys):
    """The parent prints the child's freshest line as it is when the child
    ended well or was killed at the deadline (``degraded`` stays), and with
    an ``error`` key and exit 1 when the child failed after it."""
    line = {"metric": bench.METRIC, "value": 1.0,
            "degraded": "rank-stage-pending"}
    monkeypatch.setattr(bench, "run_child",
                        lambda deadline: (json.dumps(line), rc))
    got = bench.main()
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["degraded"] == line["degraded"]
    if rc == 1:
        assert got == 1 and "exit 1" in last["error"]
    else:
        assert got == 0 and "error" not in last
