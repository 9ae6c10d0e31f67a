"""One BCR round's plan (ropebwt2_tpu_torch.engine.bcr.plan_round) against
the JAX package's plan_round on the same read states and a non-empty
index, round after round; a JAX index carried into the port mid-build;
and the port's independence from JAX.  Exact comparisons (integers)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ropebwt2_tpu.engine import TpuBwt
from ropebwt2_tpu.engine import bcr as jbcr
from ropebwt2_tpu.index.merge import apply_insertions as japply
from ropebwt2_tpu.index.rank import build_block_tables as jbuild
from ropebwt2_tpu.index.rank import rank_global as jrank

from ropebwt2_tpu_torch.convert import flat_from_numpy
from ropebwt2_tpu_torch.engine import TorchBwt
from ropebwt2_tpu_torch.engine import bcr as tbcr
from ropebwt2_tpu_torch.index.merge_cuda import merge
from ropebwt2_tpu_torch.index.rank import rank_global as trank

from conftest import random_reads

K = 128
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _layout(reads, n_strings, so):
    """The read-state layout of _run_batch: padding rows first up to a
    power of two, 8-aligned reversed reads with a 0 terminator."""
    m = len(reads)
    mpad = 16
    while mpad < m:
        mpad *= 2
    npad = mpad - m
    strides = np.array([(len(r) + 8) & ~7 for r in reads], np.int64)
    starts = np.concatenate([[0], np.cumsum(strides)[:-1]])
    buf = np.zeros(int(strides.sum()), np.int8)
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


def _flat(jstate):
    return flat_from_numpy(np.asarray(jstate.bwt), int(jstate.n),
                           np.asarray(jstate.psize),
                           np.asarray(jstate.pcounts),
                           np.asarray(jstate.blk_prefix), "cpu")


@pytest.mark.parametrize("so", [0, 1, 2])
def test_plan_round_matches_jax(so):
    rng = np.random.default_rng(30 + so)
    first = [np.asarray(r, np.int8)
             for r in random_reads(rng, 150, lo=1, hi=25, with_n=True)]
    jeng = TpuBwt(so=so, K=K, defer_r=0)
    jeng.insert_multi(first)
    second = [np.asarray(r, np.int8)
              for r in random_reads(rng, 100, lo=1, hi=25, with_n=True)]
    # grow the JAX index to fit the batch; the port's copy converts from it
    jeng._plan(sum(len(r) + 1 for r in second))
    js = jeng.state
    ts = _flat(js)

    buf, l, u, pk = _layout(second, jeng._n_strings, so)
    jreads = jbcr.ReadStates(l=jnp.asarray(l), u=jnp.asarray(u),
                             pk=jnp.asarray(pk))
    treads = tbcr.ReadStates(l=torch.from_numpy(l), u=torch.from_numpy(u),
                             pk=torch.from_numpy(pk))
    jbuf, tbuf = jnp.asarray(buf), torch.from_numpy(buf)

    @jax.jit
    def jplan(bwt, blk, psize, pcounts, reads, d):
        return jbcr.plan_round(
            psize, pcounts, reads, jbuf, d, d == 0,
            lambda g: jrank(bwt, blk, g, K), so=so)

    for d in range(max(len(r) for r in second) + 1):
        jr, jgX, jsym, jstream, jact, jins, jn = jplan(
            js.bwt, js.blk_prefix, js.psize, js.pcounts, jreads,
            jnp.asarray(d, jnp.int32))
        tr, tgX, tsym, tstream, tact, tins, tn = tbcr.plan_round(
            ts.psize, ts.pcounts, treads, tbuf, d, d == 0,
            lambda g: trank(ts.bwt, ts.blk_prefix, g, K), so=so)
        act = np.asarray(jact)
        assert np.array_equal(tact.numpy(), act), d
        for name, t, j in (("l", tr.l, jr.l), ("u", tr.u, jr.u),
                           ("pk", tr.pk, jr.pk), ("sym", tsym, jsym),
                           ("ins_bucket", tins, jins)):
            assert np.array_equal(t.numpy(), np.asarray(j)), (d, name)
        # gX and the tie ranks are defined on active rows only
        assert np.array_equal(tgX.numpy()[act], np.asarray(jgX)[act]), d
        assert np.array_equal(tstream.numpy()[act],
                              np.asarray(jstream)[act]), d
        assert int(tn) == int(jn), d
        # apply the round in both packages before the next plan
        jbwt = japply(js.bwt, js.n, jgX, jsym, jstream, jact)
        js = jbcr.FlatBwt(bwt=jbwt, n=js.n + jn,
                          psize=js.psize + jins.sum(axis=1),
                          pcounts=js.pcounts + jins,
                          blk_prefix=jbuild(jbwt, K, dtype=jnp.int32))
        bwt, blk = merge(ts.bwt, tgX, tsym, tstream, tact, ts.n, K)
        ts = tbcr.FlatBwt(bwt=bwt, n=ts.n + tn,
                          psize=ts.psize + tins.sum(1),
                          pcounts=ts.pcounts + tins, blk_prefix=blk)
        jreads, treads = jr, tr
    n = int(js.n)
    assert np.array_equal(ts.bwt.numpy()[:n], np.asarray(js.bwt)[:n])


@pytest.mark.parametrize("so,defer_r", [(1, 0), (2, 4)])
def test_jax_index_carried_into_the_port(so, defer_r):
    """A JAX build stopped after batch 1 and continued in the port gives
    the same BWT as a build done wholly in JAX."""
    rng = np.random.default_rng(40 + so)
    batches = [[np.asarray(r, np.int8) for r in
                random_reads(rng, 160, lo=1, hi=30, with_n=True)]
               for _ in range(3)]
    whole = TpuBwt(so=so, K=K, defer_r=defer_r)
    half = TpuBwt(so=so, K=K, defer_r=defer_r)
    for b in batches:
        whole.insert_multi(b)
    half.insert_multi(batches[0])

    eng = TorchBwt(so=so, K=K, defer_r=defer_r, device="cpu")
    eng.state = _flat(half.state)
    eng._n, eng._n_strings = half.n, half._n_strings
    for b in batches[1:]:
        eng.insert_multi(b)
    assert np.array_equal(eng.bwt_array(), whole.bwt_array())
    assert np.array_equal(eng.counts(), whole.counts())


def test_port_imports_and_builds_without_jax():
    """A GPU deployment of the port has no JAX: the port must import and
    run with jax made unimportable, and must not pull in the JAX package
    or a module of the JAX repo's scripts/."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import ropebwt2_tpu_torch.engine\n"
        "import ropebwt2_tpu_torch.convert\n"
        "import ropebwt2_tpu_torch.index.packed\n"
        "import ropebwt2_tpu_torch.index.merge_packed_cuda\n"
        "import ropebwt2_tpu_torch.probes._timing\n"
        "import ropebwt2_tpu_torch.probes.kernel_scaling\n"
        "import ropebwt2_tpu_torch.probes.merge_phases\n"
        "import ropebwt2_tpu_torch.probes.kernel_stages\n"
        "import ropebwt2_tpu_torch.probes.warmup_build\n"
        "import ropebwt2_tpu_torch.probes.kernel_features\n"
        "import ropebwt2_tpu_torch.cli\n"
        "import ropebwt2_tpu_torch.engine.query as q\n"
        "import ropebwt2_tpu_torch.native.lib\n"
        "import ropebwt2_tpu_torch.utils.log\n"
        "for m in ('text', 'rle_codec', 'crlf', 'fmd', 'fmr', 'seqio',\n"
        "          'preprocess'):\n"
        "    __import__('ropebwt2_tpu_torch.io.' + m)\n"
        "from ropebwt2_tpu_torch.engine import TorchBwt\n"
        "import ropebwt2_tpu_torch.index.runs\n"
        "import ropebwt2_tpu_torch.parallel.mesh\n"
        "import ropebwt2_tpu_torch.parallel.comm\n"
        "import ropebwt2_tpu_torch.oracle as o\n"
        "import ropebwt2_tpu_torch.bruteforce as bf\n"
        "from ropebwt2_tpu_torch.parallel.sharded import ShardedTorchBwt\n"
        "import ropebwt2_tpu_torch.bench as bench\n"
        "for m in ('readgen', 'common', 'scale_run', 'gen_scale_input',\n"
        "          'longread_run', 'scale_exp', 'scale_shards'):\n"
        "    __import__('ropebwt2_tpu_torch.scripts.' + m)\n"
        "from ropebwt2_tpu_torch.scripts.scale_run import text_md5\n"
        "g = bench.reads_gen(bench.Config(M=64, L=20, prefill_x=1,\n"
        "                                 sustain_runs=1))\n"
        "be = TorchBwt(so=1, device='cpu', runs=1)\n"
        "be.insert_multi(g.batch(64).view(np.int8))\n"
        "assert text_md5(be) == text_md5(be.bwt_array())\n"
        "sh = ShardedTorchBwt(so=1, defer_r=2, device='cpu')\n"
        "sh.insert_multi([np.array([1, 2, 3, 4], np.int8)] * 3)\n"
        "assert sh.counts().tolist() == [3, 3, 3, 3, 3, 0]\n"
        "assert sh.bwt_array().tolist() == bf.bwt_bruteforce(\n"
        "    [[1, 2, 3, 4]] * 3, o.SO_RLO)\n"
        "sh.mesh.close()\n"
        "for pack4, runs in ((0, None), (1, None), (0, 1)):\n"
        "    e = TorchBwt(so=1, defer_r=2, device='cpu', pack4=pack4,\n"
        "                 runs=runs)\n"
        "    e.insert_multi([np.array([1, 2, 3, 4], np.int8)] * 3)\n"
        "    assert e.counts().tolist() == [3, 3, 3, 3, 3, 0]\n"
        "    assert q.rank1a(e.state, [15]).tolist() == [[3, 3, 3, 3, 3, 0]]\n"
        "    assert sum(l for _, l in e.runs()) == 15\n"
        "    assert (type(e.state).__name__ == 'RunBwt') == bool(runs)\n"
        "assert not any(m.split('.')[0] in ('jax', 'ropebwt2_tpu')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "import os\n"
        "scripts = os.path.join(os.getcwd(), 'scripts') + os.sep\n"
        "assert not any((getattr(m, '__file__', None) or '').startswith(\n"
        "    scripts) for m in list(sys.modules.values()) if m is not None)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
