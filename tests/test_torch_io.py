"""The port's IO (ropebwt2_tpu_torch.io, .native) against the JAX
package's on the CPU: the text, RLE, CRLF, FMD and FMR writers give the
same bytes on the same runs and their readers round-trip; FmdReader.to_flat
and state_from_partition_runs build the same state; the native reader and
writers equal the JAX package's native ones; and TorchBwt.run_arrays, with
and without bounds and across chunk edges, equals the runs numpy finds.
Every comparison is exact."""

import io

import numpy as np
import pytest
import torch

from ropebwt2_tpu.engine import TpuBwt
from ropebwt2_tpu.index.flat import state_from_partition_runs as j_from_runs
from ropebwt2_tpu.io import crlf as jcrlf
from ropebwt2_tpu.io import fmd as jfmd
from ropebwt2_tpu.io import fmr as jfmr
from ropebwt2_tpu.io import rle_codec as jrle
from ropebwt2_tpu.io import text as jtext
from ropebwt2_tpu.native import lib as jnlib

from ropebwt2_tpu_torch.engine import TorchBwt
from ropebwt2_tpu_torch.index.flat import state_from_partition_runs
from ropebwt2_tpu_torch.io import crlf, fmd, fmr, rle_codec, text
from ropebwt2_tpu_torch.native import lib as nlib

from conftest import random_reads, reads_to_lines


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's many small torch ops on one thread: with every
    core busy (the suite runs on parallel workers) the intra-op pool's
    spinning threads slow each op by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_runs(b):
    """(sym, len) runs of an int8 array."""
    if b.size == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    head = np.flatnonzero(np.diff(b)) + 1
    starts = np.concatenate([[0], head])
    ends = np.concatenate([head, [b.size]])
    return b[starts].astype(np.uint8), (ends - starts).astype(np.int64)


def _split(sym, ln, cuts):
    """Runs split further at the offsets ``cuts``."""
    b = np.repeat(sym, ln)
    edges = np.unique(np.concatenate([[0], np.cumsum(ln)[:-1], cuts]))
    edges = edges[(edges >= 0) & (edges < b.size)]
    ends = np.concatenate([edges[1:], [b.size]])
    return b[edges], (ends - edges).astype(np.int64)


@pytest.fixture(scope="module")
def built():
    """One RLO build of runs-rich reads in the port and in JAX."""
    rng = np.random.default_rng(7)
    reads = [np.asarray(r, np.int8) for r in
             random_reads(rng, 200, lo=1, hi=30, with_n=True)]
    reads += [np.full(40, 1, np.int8)] * 30  # long runs of one symbol
    eng = TorchBwt(so=1, K=128, device="cpu")
    eng.insert_multi(reads)
    jeng = TpuBwt(so=1, K=128)
    jeng.insert_multi(reads)
    assert np.array_equal(eng.bwt_array(), jeng.bwt_array())
    return eng, jeng


@pytest.mark.parametrize("pack4", [0, 1])
def test_run_arrays_match_numpy(pack4):
    rng = np.random.default_rng(11 + pack4)
    reads = [np.asarray(r, np.int8) for r in
             random_reads(rng, 300, lo=1, hi=40, with_n=True)]
    reads += [np.full(int(rng.integers(1, 300)), int(rng.integers(1, 5)),
                      np.int8) for _ in range(60)]
    eng = TorchBwt(so=1, K=128, device="cpu", pack4=pack4)
    eng.insert_multi(reads)
    b = eng.bwt_array()
    want = _np_runs(b)
    psize = eng.state.psize.numpy()
    offs = np.concatenate([[0], np.cumsum(psize)])
    extra = rng.integers(0, b.size + 1, 20)
    for chunk in (256, 512, 1 << 28):  # chunk edges inside runs, or none
        got = eng.run_arrays(chunk=chunk)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), chunk
        for cuts in (offs, np.concatenate([offs, extra, [256, 512, 768]])):
            got = eng.run_arrays(bounds=cuts, chunk=chunk)
            w = _split(*want, cuts)
            assert all(np.array_equal(g, x) for g, x in zip(got, w)), chunk
    assert eng.runs() == [(int(s), int(n)) for s, n in zip(*want)]


def test_run_arrays_of_an_empty_index():
    eng = TorchBwt(so=1, device="cpu")
    sym, ln = eng.run_arrays(bounds=[0, 0])
    assert sym.dtype == np.uint8 and ln.dtype == np.int64
    assert sym.size == 0 and ln.size == 0
    assert eng.runs() == []


def test_partition_runs_match_jax(built):
    eng, jeng = built
    assert fmr.partition_runs_from_state(eng) == \
        jfmr.partition_runs_from_state(jeng)


def test_writers_match_jax(built):
    eng, jeng = built
    runs = eng.runs()
    assert runs == jeng.runs()
    arr = eng.bwt_array()

    a, b = io.BytesIO(), io.BytesIO()
    text.write_text_bwt(arr, a, chunk=100)
    jtext.write_text_bwt(arr, b, chunk=100)
    assert a.getvalue() == b.getvalue() == text.bwt_to_text(arr)

    a, b = io.BytesIO(), io.BytesIO()
    crlf.write_crlf(runs, eng.counts(), a)
    jcrlf.write_crlf(runs, jeng.counts(), b)
    assert a.getvalue() == b.getvalue()
    got, tags, nsym = crlf.read_crlf(io.BytesIO(a.getvalue()))
    assert got == runs and nsym == 6
    assert np.array_equal(np.frombuffer(tags["MC"], "<i8"), eng.counts())

    a, b = io.BytesIO(), io.BytesIO()
    fmd.write_fmd(runs, a, log_summary=False)
    jfmd.write_fmd(runs, b, log_summary=False)
    assert a.getvalue() == b.getvalue()
    got, mcnt = fmd.read_fmd(io.BytesIO(a.getvalue()))
    assert got == runs and mcnt[1:] == list(eng.counts())

    for block_len, max_nodes in ((512, 64), (64, 4), (33, 3)):
        a, b = io.BytesIO(), io.BytesIO()
        fmr.write_fmr(eng, a, block_len=block_len, max_nodes=max_nodes)
        jfmr.write_fmr(jeng, b, block_len=block_len, max_nodes=max_nodes)
        assert a.getvalue() == b.getvalue()
        parts, so = fmr.read_fmr_runs(io.BytesIO(a.getvalue()))
        assert so == 1 and parts == jfmr.partition_runs_from_state(jeng)

    a, b = io.BytesIO(), io.BytesIO()
    fmr.write_tree_debug(eng, a, block_len=64, max_nodes=4)
    jfmr.write_tree_debug(jeng, b, block_len=64, max_nodes=4)
    assert a.getvalue() == b.getvalue()


@pytest.mark.parametrize("length", [1, 15, 16, 255, 256, (1 << 19) - 1,
                                    1 << 19, (1 << 43) - 1])
def test_rle_codec_matches_jax(length):
    for c in range(6):
        enc = rle_codec.enc_run(c, length)
        assert enc == jrle.enc_run(c, length)
        assert len(enc) == rle_codec.enc_size(length)
        assert rle_codec.dec_runs(enc + enc) == [(c, length)] * 2


def test_fmd_reader_and_to_flat_match_jax(built, tmp_path):
    eng, jeng = built
    path = tmp_path / "x.fmd"
    with open(path, "wb") as f:
        fmd.write_fmd(eng.runs(), f, log_summary=False)
    rd, jrd = fmd.FmdReader(str(path)), jfmd.FmdReader(str(path))
    assert list(rd.runs()) == list(jrd.runs()) == eng.runs()
    for a, b in zip(rd.runs_arrays(), jrd.runs_arrays()):
        assert np.array_equal(a, b)
    n = eng.n
    for k in (0, 1, 17, n // 2, n - 1, n):
        assert rd.rank1a(k) == jrd.rank1a(k)
        assert rd.rank2a(k, min(n, k + 40)) == jrd.rank2a(k, min(n, k + 40))
    assert rd.extend((0, 0, n)) == jrd.extend((0, 0, n))
    for K in (128, 256):
        st = rd.to_flat(K=K, device="cpu")
        js = jrd.to_flat(K=K)
        _same_flat(st, js, n, K)
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rd.to_flat()


def _same_flat(st, js, n, K):
    assert int(st.n) == int(js.n) == n
    assert np.array_equal(st.bwt.numpy()[:n], np.asarray(js.bwt)[:n])
    assert np.array_equal(st.psize.numpy(), np.asarray(js.psize))
    assert np.array_equal(st.pcounts.numpy(), np.asarray(js.pcounts))
    rows = n // K + 1
    assert np.array_equal(st.blk_prefix.numpy()[:rows],
                          np.asarray(js.blk_prefix)[:rows])
    assert st.cap == js.cap


@pytest.mark.parametrize("K", [16, 128, 256])
def test_state_from_partition_runs_matches_jax(built, K):
    eng, jeng = built
    parts = fmr.partition_runs_from_state(eng)
    _same_flat(state_from_partition_runs(parts, K, device="cpu"),
               j_from_runs(parts, K), eng.n, K)
    parts[3] = []  # an empty partition
    n = sum(l for p in parts for _, l in p)
    _same_flat(state_from_partition_runs(parts, K, device="cpu"),
               j_from_runs(parts, K), n, K)


def test_fmr_restore_at_k128_continues_the_build(built, tmp_path):
    """-i restores at K = 128: the restored index grows on both tiers and
    gives the BWT of a build of all the reads."""
    eng, _ = built
    path = tmp_path / "x.fmr"
    with open(path, "wb") as f:
        fmr.write_fmr(eng, f)
    rng = np.random.default_rng(3)
    more = [np.asarray(r, np.int8) for r in random_reads(rng, 50, lo=1,
                                                         hi=30)]
    outs = []
    for pack4 in (0, 1):
        res, so = fmr.read_fmr_state(str(path), device="cpu", pack4=pack4)
        assert so == 1 and res.K == 128 and res.n == eng.n
        assert np.array_equal(res.bwt_array(), eng.bwt_array())
        res.insert_multi(more)
        outs.append(res.bwt_array())
    whole = TorchBwt(so=1, device="cpu")
    whole.state = state_from_partition_runs(
        fmr.partition_runs_from_state(eng), 128, device="cpu")
    whole._n, whole._n_strings = eng.n, eng._n_strings
    whole.insert_multi(more)
    assert np.array_equal(outs[0], whole.bwt_array())
    assert np.array_equal(outs[1], whole.bwt_array())


# ---- the native host runtime against the JAX package's ----

FLAGS = [  # tests/test_native.py's flag sets
    {},
    {"rev": False},
    {"fwd": False},
    {"skip_n": True},
    {"cut_n": True, "min_cut_len": 3},
    {"cut_n": True, "min_cut_len": 1, "trim_pal": True},
    {"trim_pal": True},
]


def _batches(lib, path, line_mode, **flags):
    r = lib.NativeReader(str(path), line_mode=line_mode)
    out = []
    while (b := r.next_batch(min_fill=1 << 8, slack=1 << 12, **flags)) \
            is not None:
        out.append(b.copy())
    r.close()
    return out


@pytest.mark.parametrize("flags", FLAGS)
def test_native_reader_matches_jax(flags, rng, tmp_path):
    if not jnlib.native_available():
        pytest.skip("the JAX package's native runtime did not build")
    assert nlib.native_available(), nlib.BUILD_ERROR
    reads = random_reads(rng, n=400, lo=1, hi=20, with_n=True)
    reads += [[5, 5], [1, 4], [2, 3, 3, 2], [1], [4, 5, 4]]
    p = tmp_path / "in.txt"
    p.write_bytes(reads_to_lines(reads))
    a = _batches(nlib, p, True, **flags)
    b = _batches(jnlib, p, True, **flags)
    assert len(a) == len(b) > 1
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_native_fastq_reader_matches_jax(rng, tmp_path):
    if not jnlib.native_available():
        pytest.skip("the JAX package's native runtime did not build")
    import gzip

    tab = "$ACGTN"
    recs = []
    for i, r in enumerate(random_reads(rng, n=60, lo=5, hi=30)):
        seq = "".join(tab[c] for c in r)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 42, len(r)))
        recs.append(f"@r{i} comment\n{seq}\n+\n{qual}\n")
    p = tmp_path / "in.fq.gz"
    p.write_bytes(gzip.compress("".join(recs).encode()))
    for flags in ({"min_q": 20}, {"min_q": 20, "skip_n": True}):
        a = _batches(nlib, p, False, **flags)
        b = _batches(jnlib, p, False, **flags)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_native_writers_match_jax(built, tmp_path):
    if not jnlib.native_available():
        pytest.skip("the JAX package's native runtime did not build")
    eng, jeng = built
    arr = eng.bwt_array()
    sym, ln = eng.run_arrays()
    js, jl = jnlib.extract_runs(arr)
    assert np.array_equal(sym, js) and np.array_equal(ln, jl)

    def same(write, jwrite, name):
        p, q = tmp_path / name, tmp_path / ("j" + name)
        write(str(p))
        jwrite(str(q))
        assert p.read_bytes() == q.read_bytes(), name
        return p

    same(lambda p: nlib.text_write(arr, p),
         lambda p: jnlib.text_write(arr, p), "t.txt")
    p = same(lambda p: nlib.fmd_write(sym, ln, p),
             lambda p: jnlib.fmd_write(js, jl, p), "t.fmd")
    for a, b in zip(nlib.fmd_decode(str(p)), jnlib.fmd_decode(str(p))):
        assert np.array_equal(a, b)
    same(lambda p: nlib.crlf_write(sym, ln, eng.counts(), p),
         lambda p: jnlib.crlf_write(js, jl, jeng.counts(), p), "t.crlf")
    psym, pln = fmr.partition_run_arrays(eng)
    nruns = np.asarray([len(s) for s in psym], np.int64)
    jparts = jfmr.partition_runs_from_state(jeng)
    jsym = np.asarray([c for p in jparts for c, _ in p], np.uint8)
    jln = np.asarray([n for p in jparts for _, n in p], np.int64)
    jnr = np.asarray([len(p) for p in jparts], np.int64)
    same(lambda p: nlib.fmr_write(np.concatenate(psym), np.concatenate(pln),
                                  nruns, 1, p, 64, 4),
         lambda p: jnlib.fmr_write(jsym, jln, jnr, 1, p, 64, 4), "t.fmr")


def test_native_build_failure_is_logged(monkeypatch, tmp_path, capsys):
    """A host runtime that cannot build leaves get_lib() None, keeps the
    compiler's output in BUILD_ERROR and logs it; the Python paths stay."""
    monkeypatch.setattr(nlib, "_lib", None)
    monkeypatch.setattr(nlib, "_tried", False)
    monkeypatch.setattr(nlib, "BUILD_ERROR", None)
    monkeypatch.setattr(nlib, "BUILD", tmp_path)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nlib, "SRC", bad)
    assert nlib.get_lib() is None and not nlib.native_available()
    assert "bad.cpp" in nlib.BUILD_ERROR
    assert "[E::native]" in capsys.readouterr().err
