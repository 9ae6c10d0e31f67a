"""The port's run-length tier end to end on the CPU: TorchBwt(runs=...)
against the JAX engine under ROPEBWT2_TPU_RUNS (set with monkeypatch), the
queries over a run-tier index, the CLI under ROPEBWT2_TPU_RUNS=1, the
overflow check, and long reads on the flat and the run tier.

Every comparison is exact: the BWT, the counts and, where both engines
plan the same, every field of the run-tier state."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ropebwt2_tpu import cli as jcli
from ropebwt2_tpu.engine import TpuBwt
from ropebwt2_tpu.engine import query as jq
from ropebwt2_tpu.index import runs as jruns

from ropebwt2_tpu_torch import cli as tcli
from ropebwt2_tpu_torch.engine import TorchBwt
from ropebwt2_tpu_torch.engine import bcr
from ropebwt2_tpu_torch.engine import query as tq
from ropebwt2_tpu_torch.index import runs as truns
from ropebwt2_tpu_torch.index.runs import RunBwt

from conftest import random_reads, reads_to_lines

FIELDS = ("rsym", "rend", "bstart", "bocc", "nslot", "overflow")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's many small torch ops on one thread: with every
    core busy (the suite runs on parallel workers) the intra-op pool's
    spinning threads slow each op by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_build(batches, so=1, defer_r=None, runs="1"):
    """A TpuBwt build of ``batches`` with ROPEBWT2_TPU_RUNS=runs and the
    packed tier off (the environment restored after)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ROPEBWT2_TPU_RUNS", runs)
        mp.setenv("ROPEBWT2_TPU_PACK4", "0")
        eng = TpuBwt(so=so, defer_r=defer_r)
        for b in batches:
            eng.insert_multi(b)
    return eng


def port_build(batches, so=1, defer_r=None, **kw):
    eng = TorchBwt(so=so, defer_r=defer_r, device="cpu", pack4=0, **kw)
    for b in batches:
        eng.insert_multi(b)
    return eng


def assert_same_state(ts, js):
    assert isinstance(ts, RunBwt)
    for f in FIELDS:
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f


def assert_same_bwt(t, j):
    assert t.n == j.n
    assert np.array_equal(t.bwt_array(), j.bwt_array())
    assert np.array_equal(t.counts(), j.counts())


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(71)
    reads = random_reads(rng, n=64, lo=4, hi=30, with_n=True)
    return [reads[:32], reads[32:]]


@pytest.mark.parametrize("so", [0, 1, 2])
@pytest.mark.parametrize("defer_r", [0, 4])
def test_engine_matches_jax(batches, so, defer_r):
    t = port_build(batches, so, defer_r, runs=1)
    j = jax_build(batches, so, defer_r)
    assert_same_state(t.state, j.state)
    assert_same_bwt(t, j)
    assert t.state.rcap == j.state.rcap


def test_conversion_midway_matches_jax():
    """runs=T converts at the batch whose plan passes T symbols; the first
    batch stays flat."""
    rng = np.random.default_rng(72)
    reads = random_reads(rng, n=60, lo=5, hi=25)
    parts = [reads[:20], reads[20:40], reads[40:]]
    thr = sum(len(r) + 1 for r in parts[0]) + 10
    t = TorchBwt(so=1, device="cpu", pack4=0, runs=thr)
    t.insert_multi(parts[0])
    assert not isinstance(t.state, RunBwt)
    for p in parts[1:]:
        t.insert_multi(p)
    j = jax_build(parts, runs=str(thr))
    assert_same_state(t.state, j.state)
    assert_same_bwt(t, j)
    assert_same_bwt(t, port_build(parts, runs=0))


def test_growth_and_int64_upgrade_match_jax(monkeypatch):
    """Eight small batches grow the slots (and tighten the slot bound by a
    read of nslot); with the int32 table limit lowered on both sides to
    1500 symbols, a later batch widens the tables to int64.  After every
    batch: the same state, rcap and (R, pcap) choice as the JAX engine."""
    thr = 1500
    monkeypatch.setattr(jruns, "gdt_for_symbols",
                        lambda t: jnp.int32 if t < thr else jnp.int64)
    monkeypatch.setattr(truns, "gdt_for_symbols",
                        lambda t: torch.int32 if t < thr else torch.int64)
    monkeypatch.setattr(bcr, "gdt_for_symbols", truns.gdt_for_symbols)
    rng = np.random.default_rng(73)
    reads = random_reads(rng, n=240, lo=4, hi=16)
    parts = [reads[i::8] for i in range(8)]
    t = TorchBwt(so=1, device="cpu", pack4=0, runs=1)
    dtypes = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ROPEBWT2_TPU_RUNS", "1")
        mp.setenv("ROPEBWT2_TPU_PACK4", "0")
        j = TpuBwt(so=1)
        for p in parts:
            t.insert_multi(p)
            j.insert_multi(p)
            assert_same_state(t.state, j.state)
            assert t._nslot_bound == j._nslot_bound
            for mpad in (16, 4096, 1 << 16):
                assert t._choose_defer(mpad) == j._choose_defer(mpad)
            dtypes.append(t.state.bstart.dtype)
    assert dtypes[0] == torch.int32 and dtypes[-1] == torch.int64
    assert_same_bwt(t, j)
    assert_same_bwt(t, port_build(parts, runs=0))


def test_compressibility():
    """Duplicated reads (a coverage proxy) keep the slots well below n."""
    rng = np.random.default_rng(74)
    base = random_reads(rng, n=12, lo=20, hi=30)
    reads = [base[i % len(base)] for i in range(120)]
    t = port_build([reads], runs=1)
    assert int(t.state.nslot) < t.n // 3 and int(t.state.overflow) == 0
    assert_same_bwt(t, port_build([reads], runs=0))


@pytest.mark.parametrize("split_len", [None, 16])
def test_run_arrays_equal_the_flat_tier(split_len, monkeypatch):
    """run_arrays on the run tier, with and without bounds, equals the
    flat tier's: equal neighbouring slots (left by the insertion's economy
    rules, and the halves of runs split at conversion, here with the
    split length lowered to 16) coalesce into maximal runs."""
    if split_len:
        monkeypatch.setattr(bcr, "RUN_LEN_MAX", split_len)
    rng = np.random.default_rng(75)
    reads = random_reads(rng, n=150, lo=5, hi=40)
    reads += [[2] * 120, [3] * 90, [2] * 200]
    parts = [reads[::2], reads[1::2]]
    thr = sum(len(r) + 1 for r in parts[0]) + 1
    t = port_build(parts, runs=thr)
    f = port_build(parts, runs=0)
    assert isinstance(t.state, RunBwt)
    offs = np.concatenate([[0], np.cumsum(f.state.psize.numpy())])
    for bounds in (None, offs, [0, 7, 7, 300, f.n - 1, f.n]):
        got, want = t.run_arrays(bounds=bounds), f.run_arrays(bounds=bounds)
        assert got[0].dtype == want[0].dtype == np.uint8
        assert got[1].dtype == want[1].dtype == np.int64
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    maximal = f.run_arrays()[0].size
    assert int(t.state.nslot) > maximal  # some slots did coalesce
    assert t.runs() == f.runs()
    for lo, hi in ((0, f.n), (3, 4), (5, 5), (100, f.n - 7)):
        assert torch.equal(t._symbols(lo, hi), f._symbols(lo, hi))


@pytest.mark.parametrize("case", ["rcap", "margin"])
def test_overflow_raises_after_the_batch(case):
    """A batch that outgrows its slots raises RuntimeError when it ends,
    and the corrupt index exports nothing: a fixed runs_rcap too small for
    the batch, or a margin of 0.35 on incompressible reads in batches
    that grow."""
    rng = np.random.default_rng(76)
    kw = {"runs_rcap": truns.RCAP_ALIGN} if case == "rcap" else {}
    t = TorchBwt(so=1, device="cpu", pack4=0, runs=1, runs_margin=0.35, **kw)
    raised = None
    for i in range(8):  # batches of 400, 800, ... reads
        reads = random_reads(rng, n=400 * (i + 1), lo=20, hi=40)
        try:
            t.insert_multi(reads)
        except RuntimeError as e:
            raised = (i, str(e))
            break
        assert int(t.state.overflow) == 0
    assert raised is not None and "outgrew" in raised[1]
    assert int(t.state.overflow) > 0
    with pytest.raises(RuntimeError, match="corrupt"):
        t.bwt_array()
    with pytest.raises(RuntimeError, match="corrupt"):
        t.run_arrays()


def test_queries_match_the_flat_tier_and_jax():
    """rank2a, extend and backward_search over a run-tier index equal the
    flat tier's and the JAX functions' over the JAX run-tier index."""
    rng = np.random.default_rng(77)
    reads = random_reads(rng, n=80, lo=8, hi=30, with_n=True)
    t = port_build([reads], runs=1)
    f = port_build([reads], runs=0)
    j = jax_build([reads])
    assert isinstance(j.state, jruns.RunBwt)
    n = t.n
    x = np.sort(rng.integers(0, n + 1, 256))
    y = np.minimum(x + rng.integers(0, 50, x.size), n)
    for a, b, c in zip(tq.rank2a(t.state, x, y), tq.rank2a(f.state, x, y),
                       jq.rank2a(j.state, jnp.asarray(x), jnp.asarray(y))):
        assert torch.equal(a, b)
        assert np.array_equal(a.numpy(), np.asarray(c))
    ik = np.stack([x, np.zeros_like(x), y - x], axis=1)
    for back in (True, False):
        got = tq.extend(t.state, ik, is_back=back)
        assert torch.equal(got, tq.extend(f.state, ik, is_back=back))
        assert np.array_equal(got.numpy(), np.asarray(
            jq.extend(j.state, jnp.asarray(ik), is_back=back)))
    pats = np.zeros((64, 12), np.int32)  # substrings of the reads
    lens = rng.integers(1, 9, 64).astype(np.int32)
    for i, ln in enumerate(lens):
        r = reads[i % len(reads)]
        s = int(rng.integers(0, len(r) - ln + 1))
        pats[i, 12 - ln:] = r[s: s + ln]
    lo, hi = tq.backward_search(t.state, pats, lens)
    flo, fhi = tq.backward_search(f.state, pats, lens)
    jlo, jhi = jq.backward_search(j.state, jnp.asarray(pats),
                                  jnp.asarray(lens))
    assert torch.equal(lo, flo) and torch.equal(hi, fhi)
    assert np.array_equal(lo.numpy(), np.asarray(jlo))
    assert np.array_equal(hi.numpy(), np.asarray(jhi))
    assert bool((hi - lo >= 1).all())


@pytest.fixture(scope="module")
def cli_input(tmp_path_factory):
    rng = np.random.default_rng(78)
    reads = random_reads(rng, n=120, lo=5, hi=40, with_n=True)
    d = tmp_path_factory.mktemp("runs_cli")
    paths = []
    for i, part in enumerate((reads, reads[:60], reads[60:])):
        p = d / f"in{i}.txt"
        p.write_bytes(reads_to_lines(part))
        paths.append(str(p))
    return d, paths


@pytest.mark.parametrize("flags", [["-LRs"], ["-LRs", "-d"], ["-LRs", "-b"],
                                   ["-LR", "-B"]])
def test_cli_matches_jax(flags, cli_input, monkeypatch):
    """Under ROPEBWT2_TPU_RUNS=1 the port's CLI builds on the run tier and
    writes the JAX CLI's bytes."""
    d, paths = cli_input
    monkeypatch.setenv("ROPEBWT2_TPU_RUNS", "1")
    monkeypatch.setenv("ROPEBWT2_TPU_NATIVE", "0")
    built = []

    class Recorded(TorchBwt):
        def counts(self):
            built.append(type(self.state).__name__)
            return super().counts()

    monkeypatch.setattr(tcli, "TorchBwt", Recorded)
    tag = "".join(flags).replace("-", "")
    out_t, out_j = d / f"t{tag}", d / f"j{tag}"
    assert tcli.main([*flags, "-o", str(out_t), paths[0]],
                     device="cpu") == 0
    assert jcli.main([*flags, "-o", str(out_j), paths[0]]) == 0
    assert set(built) == {"RunBwt"}
    assert out_t.read_bytes() == out_j.read_bytes()


def test_cli_restore_converts_at_the_first_batch(cli_input, monkeypatch):
    """-b, then -i with more reads under ROPEBWT2_TPU_RUNS=1: the restored
    flat index converts at its first batch; the FMD equals the JAX CLI's
    and a one-shot build's."""
    d, paths = cli_input
    monkeypatch.setenv("ROPEBWT2_TPU_RUNS", "1")
    outs = {}
    for tag, run in (("t", lambda a: tcli.main(a, device="cpu")),
                     ("j", jcli.main)):
        fmr, fmd = d / f"{tag}.fmr", d / f"{tag}.fmd"
        assert run(["-LRs", "-b", "-o", str(fmr), paths[1]]) == 0
        assert run(["-LR", "-d", "-i", str(fmr), "-o", str(fmd),
                    paths[2]]) == 0
        outs[tag] = fmd.read_bytes()
    one = d / "one.fmd"
    assert tcli.main(["-LRs", "-d", "-o", str(one), paths[0]],
                     device="cpu") == 0
    assert outs["t"] == outs["j"] == one.read_bytes()


@pytest.fixture(scope="module")
def long_reads():
    rng = np.random.default_rng(79)
    return [rng.integers(1, 5, size=int(ln)).astype(np.int8)
            for ln in rng.integers(150, 1001, size=24)]


@pytest.fixture(scope="module")
def long_jax():
    """The JAX engine's flat builds of long_reads, by defer_r."""
    return {}


@pytest.mark.parametrize("runs", [0, 1])
@pytest.mark.parametrize("defer_r", [0, 8])
def test_long_reads_match_jax(long_reads, long_jax, runs, defer_r):
    """Reads of 150-1000 bp (hundreds of rounds a batch) on the flat and
    the run tier, merging every round or deferred, against TpuBwt."""
    if defer_r not in long_jax:
        long_jax[defer_r] = jax_build([long_reads], defer_r=defer_r,
                                      runs="0")
    t = port_build([long_reads], defer_r=defer_r, runs=runs)
    assert isinstance(t.state, RunBwt) == bool(runs)
    assert_same_bwt(t, long_jax[defer_r])


def test_run_tier_refuses_bad_options():
    with pytest.raises(ValueError):
        TorchBwt(device="cpu", runs=-1)
    with pytest.raises(ValueError):
        TorchBwt(device="cpu", runs="auto")
    st = truns.empty_runs_state(truns.RCAP_ALIGN, 100, "cpu")
    with pytest.raises(ValueError):
        truns.grow_runs_state(st, truns.RCAP_ALIGN + 128)
    assert dataclasses.replace(st).cap == 1 << 30
