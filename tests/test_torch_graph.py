"""The graph runner (ropebwt2_tpu_torch/engine/graph.py): a batch's rounds
on the runner's own buffers, which the card replays as CUDA graphs.

On the CPU the runner runs the same rounds op by op on those buffers;
the tests hold it byte for byte against the JAX package's TpuBwt on the
same numpy-seeded reads: every sorting order, the flat and the packed
tier, windows that do not divide the rounds (R even and odd), an
unplanned growth between batches and a flat-to-packed conversion (each a
new configuration of the runner), long reads, rounds merged at once (R =
0) and the run tier, and an index given to an engine (copied, never
written).  The card's tests hold the graphs against graphs=False by md5
and by the kernels' launch counts.  JAX is imported inside the CPU tests only, so
that the card's test runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graph.py
"""

import hashlib

import numpy as np
import pytest
import torch

from ropebwt2_tpu_torch.engine import TorchBwt, graph
from ropebwt2_tpu_torch.index import packed
from ropebwt2_tpu_torch.index.flat import FlatBwt, empty_state, grow_state
from ropebwt2_tpu_torch.utils import launches, trace


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small torch ops on one thread: the suite runs on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reads_of(seed, m, lo=4, hi=40, n_frac=0.02):
    """m reads of lo..hi symbols of ACGT with a few N, from default_rng."""
    rng = np.random.default_rng(seed)
    out = []
    for ln in rng.integers(lo, hi + 1, m):
        r = rng.integers(1, 5, ln).astype(np.int8)
        r[rng.random(ln) < n_frac] = 5
        out.append(r)
    return out


def both(so, batches, monkeypatch, pack4=0, plan=None, **kw):
    """The same batches through TpuBwt and TorchBwt(device="cpu"): the two
    BWTs and counts equal; returns the port's engine."""
    from ropebwt2_tpu.engine import TpuBwt

    monkeypatch.setenv("ROPEBWT2_TPU_PACK4", str(pack4))
    jeng = TpuBwt(so=so, **kw)
    teng = TorchBwt(so=so, device="cpu", pack4=pack4, **kw)
    if plan:
        jeng._plan(plan)
        teng.plan(plan)
    for b in batches:
        jeng.insert_multi(b)
        teng.insert_multi(b)
    assert teng.n == jeng.n
    assert np.array_equal(teng.bwt_array(), jeng.bwt_array())
    assert np.array_equal(teng.counts(), jeng.counts())
    return teng


@pytest.mark.parametrize("so,tier,R", [
    (0, "flat", 4), (1, "flat", 4), (2, "flat", 4), (0, "packed", 4),
    (1, "packed", 4), (2, "packed", 4), (1, "flat", 3)])
def test_runner_matches_jax(so, tier, R, monkeypatch):
    """Batches of 31 and 36 rounds (last windows of 3 and 4 rounds at R
    4, of 1 and 3 at R 3), on either tier."""
    batches = [reads_of(10 + so, 90, hi=30), reads_of(20 + so, 70, hi=35)]
    eng = both(so, batches, monkeypatch, pack4=1 if tier == "packed" else 0,
               defer_r=R)
    assert isinstance(eng.state, packed.PackedFlatBwt
                      if tier == "packed" else FlatBwt)
    assert eng._runner.state is eng.state and eng._runner.owned


def test_growth_and_conversion_make_new_configurations(monkeypatch):
    """Four unplanned batches, the first three growing the index, the third
    past the pack4 threshold (flat to packed): each batch binds the runner
    to a new configuration (a new capacity, tier or batch width), and the
    BWT equals the JAX package's."""
    batches = [reads_of(30 + i, 40 * (i + 1), hi=30) for i in range(4)]
    thr = sum(len(r) + 1 for b in batches[:2] for r in b) + 1
    keys = []
    real_bind = graph.Runner.bind

    def bind(self, state, **kw):
        out = real_bind(self, state, **kw)
        keys.append(self.key)
        return out

    monkeypatch.setattr(graph.Runner, "bind", bind)
    eng = both(1, batches, monkeypatch, pack4=thr, defer_r=4)
    assert isinstance(eng.state, packed.PackedFlatBwt)
    assert len(keys) == 4 and len(set(keys)) == 4
    assert not eng._runner.repeat
    assert [k[0] for k in keys] == ["FlatBwt"] * 2 + ["PackedFlatBwt"] * 2


def test_long_reads_match_jax(monkeypatch):
    """A batch of 64 reads of 150-400 symbols (401 rounds, R = 16) after a
    batch of short ones."""
    batches = [reads_of(40, 50, hi=30), reads_of(41, 64, lo=150, hi=400)]
    both(1, batches, monkeypatch, defer_r=16)


def test_a_given_index_is_copied_and_never_written(monkeypatch):
    """An index given to an engine (a copy of another's, as a restore
    makes one) is copied by the runner at the engine's next batch: the
    engine it came from keeps its BWT, and both give the JAX package's.
    A copy of an engine gets no runner of its own until its first batch,
    and an engine's runner goes with it."""
    import copy
    import gc
    import weakref

    from ropebwt2_tpu.engine import TpuBwt

    monkeypatch.setenv("ROPEBWT2_TPU_PACK4", "0")
    b1, b2 = reads_of(50, 80, hi=30), reads_of(51, 80, hi=30)
    jeng = TpuBwt(so=1, defer_r=4)
    jeng._plan(20000)
    jeng.insert_multi(b1)
    first = jeng.bwt_array()
    jeng.insert_multi(b2)
    want = jeng.bwt_array()

    eng = TorchBwt(so=1, device="cpu", defer_r=4)
    eng.plan(20000)
    eng.insert_multi(b1)
    twin = copy.copy(eng)
    assert twin._runner is None and twin.state is eng.state
    twin.insert_multi(b2)
    assert twin._runner is not eng._runner
    assert twin.state.bwt.data_ptr() != eng.state.bwt.data_ptr()
    assert np.array_equal(twin.bwt_array(), want)
    assert np.array_equal(eng.bwt_array(), first)
    eng.insert_multi(b2)
    assert np.array_equal(eng.bwt_array(), want)

    given = copy.deepcopy(twin.state)
    held = given.bwt.clone()
    other = TorchBwt(so=1, device="cpu", defer_r=4)
    other.state = given
    other._n, other._n_strings = twin.n, twin._n_strings
    other.insert_multi(b1)
    assert torch.equal(given.bwt, held) and other.state is not given
    gone = weakref.ref(other._runner)
    del other
    gc.collect()
    assert gone() is None


@pytest.mark.parametrize("runs,defer_r", [(None, 0), (1, 4)])
def test_merged_rounds_and_the_run_tier_run_on_the_runner(runs, defer_r,
                                                          monkeypatch):
    """Rounds merged at once (R = 0) and the run tier's deferred rounds go
    through the same runner and replace the index's tensors: a state
    held from before a batch stays as it was, and the BWT is the JAX
    package's over two batches (its flat tier merged every round: the
    run tier's BWT is the same, and tests/test_torch_runs_engine.py holds
    it against the JAX run tier)."""
    import dataclasses

    from ropebwt2_tpu.engine import TpuBwt

    monkeypatch.setenv("ROPEBWT2_TPU_PACK4", "0")
    batches = [reads_of(70, 60, hi=25), reads_of(71, 50, hi=30)]
    jeng = TpuBwt(so=1, defer_r=0)
    eng = TorchBwt(so=1, device="cpu", pack4=0, runs=runs, defer_r=defer_r)
    jeng.insert_multi(batches[0])
    eng.insert_multi(batches[0])
    prev = eng.state
    kept = {f.name: getattr(prev, f.name).clone()
            for f in dataclasses.fields(prev)}
    jeng.insert_multi(batches[1])
    eng.insert_multi(batches[1])
    assert all(torch.equal(getattr(prev, k), t) for k, t in kept.items())
    assert np.array_equal(eng.bwt_array(), jeng.bwt_array())
    assert np.array_equal(eng.counts(), jeng.counts())
    run = eng._runner
    assert not run.fixed and not run.owned and run.state is eng.state


def test_graphs_come_with_a_configuration_that_repeats(monkeypatch):
    """A batch replays graphs only where its configuration is the last
    batch's: a planned index repeats from its second batch on, an
    unplanned growth starts anew.  On the CPU nothing is captured."""
    eng = TorchBwt(so=1, device="cpu", defer_r=4)
    eng.plan(12000)
    seen = []
    real_run = graph.Runner.run

    def run(self, *a):
        seen.append((self.repeat, self.fixed))
        return real_run(self, *a)

    monkeypatch.setattr(graph.Runner, "run", run)
    for i in range(3):
        eng.insert_multi(reads_of(80 + i, 64, lo=20, hi=20))
    eng.insert_multi(reads_of(83, 64, lo=200, hi=200))  # grows the index
    assert seen == [(False, True), (True, True), (True, True),
                    (False, True)]
    assert eng._runner.stats["tapes"] == 0 and not eng._runner.tapes


def test_config_key_changes_with_what_the_graphs_bake_in():
    """A changed capacity, pcap, R or batch width gives a new key; the same
    configuration of another index gives the same key."""
    st = empty_state(1 << 12, 128, "cpu")
    kw = dict(K=128, so=1, R=8, pcap=1 << 16, mpad=1 << 10, nbuf=1 << 15)
    key = graph.config_key(st, **kw)
    assert graph.config_key(empty_state(1 << 12, 128, "cpu"), **kw) == key
    assert graph.config_key(grow_state(st, 1 << 13, 128), **kw) != key
    for name, value in (("pcap", 1 << 17), ("R", 16), ("mpad", 1 << 11),
                        ("nbuf", 1 << 16), ("so", 2)):
        assert graph.config_key(st, **{**kw, name: value}) != key, name
    assert graph.config_key(packed.packed_from_flat(st, 1 << 12),
                            **kw) != key


def test_spans_cut_a_round_and_keep_their_names():
    """trace.cutting sees every span of a deferred batch enter and exit in
    nested order (where a capture is cut into graphs), inside collect()
    the same spans are recorded, and a capture that ends by an exception
    is not cut at the exit."""
    events = []
    eng = TorchBwt(so=1, device="cpu", defer_r=4)
    reads = reads_of(60, 40, hi=12)
    with trace.collect() as tr, trace.cutting(
            lambda name, entering: events.append((name, entering))):
        eng.insert_multi(reads)
    stack = []
    for name, entering in events:
        if entering:
            stack.append(name)
        else:
            assert stack.pop() == name
    assert not stack
    entered = {n for n, e in events if e}
    assert {"round", "plan.sort", "plan.groups", "plan.rank", "plan.update",
            "pending.new_rows", "pending.kernel", "flush",
            "merge.kernel", "merge.tables"} <= entered
    assert entered == set(tr)
    assert tr["round"]["calls"] == sum(1 for n, e in events
                                       if e and n == "round") \
        == max(len(r) for r in reads) + 1
    events.clear()
    with pytest.raises(ZeroDivisionError), trace.cutting(
            lambda name, entering: events.append((name, entering))):
        with trace.span("round"):
            1 / 0
    assert events == [("round", True)]


def test_replayed_launches_count_as_launches():
    """A graph's recorded launches added by replayed(): each kernel's count
    and, inside collect(), the launches counter of the span open then."""
    counts = {"LAUNCHES": 5}
    table = {"rank_flat": 0}
    rec = {}
    prev = launches.recording(rec)
    rec[(id(counts), "LAUNCHES")] = [counts, "LAUNCHES", 2]
    rec[(id(table), "rank_flat")] = [table, "rank_flat", 3]
    assert launches.recording(prev) is rec
    with trace.collect() as tr:
        with trace.span("round"):
            launches.replayed(tuple(rec.values()))
    assert counts["LAUNCHES"] == 7 and table["rank_flat"] == 3
    assert tr["round"]["counters"]["launches"] == 5


@pytest.mark.cuda
def test_graphs_match_eager_on_the_card():
    """On the card: the flat tier at R 8 and R 3, and the packed tier,
    with graphs and with graphs=False; equal BWTs (md5), equal launch
    counts by kernel (the replays count theirs), graphs captured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ropebwt2_tpu_torch.scripts.common import launch_counts
    from ropebwt2_tpu_torch.index import rank_cuda

    batches = [np.random.default_rng(s).integers(1, 5, (3000, 101))
               .astype(np.int8) for s in range(3)]
    for kw in ({"defer_r": 8}, {"defer_r": 3}, {"defer_r": 4, "pack4": 1}):
        got, stats = [], []
        for graphs in (True, False):
            before = {**launch_counts(), **rank_cuda.LAUNCHES}
            eng = TorchBwt(so=1, graphs=graphs, **kw)
            eng.plan(3 * 3000 * 102)
            for b in batches:
                eng.insert_multi(b)
                stats.append(eng._runner.stats["graphs"])
            torch.cuda.synchronize()
            counts = {k: v - before[k] for k, v in
                      {**launch_counts(), **rank_cuda.LAUNCHES}.items()}
            got.append((hashlib.md5(eng.bwt_array().tobytes()).hexdigest(),
                        counts))
            del eng
        assert got[0] == got[1], kw
        # graphs: none in the first batch, captured in the second, kept
        assert stats[0] == 0 and stats[1] > 0 and stats[2] == stats[1], kw
        assert stats[3:] == [0, 0, 0], kw


@pytest.mark.cuda
def test_a_sync_inside_a_captured_round_raises(monkeypatch):
    """A round that reads a value back to the host cannot be captured: the
    batch that captures (a configuration's second) raises, with no
    fallback to running op by op, and the runner drops its graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ropebwt2_tpu_torch.engine import bcr

    real = bcr.pending_add

    def reads_back(pend, gX, sym, stream, active):
        int(active.sum())
        return real(pend, gX, sym, stream, active)

    batches = [np.random.default_rng(s).integers(1, 5, (256, 30))
               .astype(np.int8) for s in range(2)]
    eng = TorchBwt(so=1, defer_r=4)
    eng.plan(2 * 256 * 31)
    monkeypatch.setattr(bcr, "pending_add", reads_back)
    eng.insert_multi(batches[0])  # op by op: the read is allowed
    with pytest.raises(RuntimeError):
        eng.insert_multi(batches[1])  # captured
    assert eng._runner.tapes == {} and eng._runner.key is None
    torch.cuda.synchronize()
