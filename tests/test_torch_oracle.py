"""The port's copies of the oracle (ropebwt2_tpu_torch/oracle.py) and the
brute-force suffix sort (bruteforce.py) against the JAX package's, and
the port's engines against them on tiny inputs: the same BWT, runs and
counts, single-string and batched, in every sorting order."""

import numpy as np
import pytest

from ropebwt2_tpu import bruteforce as jbrute
from ropebwt2_tpu import oracle as joracle

from ropebwt2_tpu_torch import bruteforce, oracle
from ropebwt2_tpu_torch.engine import TorchBwt

from conftest import random_reads


def _build(mod, reads, so, batches):
    idx = mod.OracleIndex(so)
    for part in np.array_split(np.arange(len(reads)), batches):
        if len(part):
            idx.insert_multi([list(reversed(reads[i])) for i in part])
    return idx


@pytest.mark.parametrize("so", [0, 1, 2])
def test_oracle_copy_matches_the_jax_oracle(so, rng):
    assert (oracle.SO_IO, oracle.SO_RLO, oracle.SO_RCLO) == \
        (joracle.SO_IO, joracle.SO_RLO, joracle.SO_RCLO)
    for trial in range(6):
        reads = random_reads(rng, n=int(rng.integers(1, 14)), with_n=True)
        for batches in (1, 3):
            got, want = (_build(m, reads, so, batches)
                         for m in (oracle, joracle))
            assert got.bwt() == want.bwt(), (so, trial, batches)
            assert got.runs() == want.runs()
            assert got.counts() == want.counts()
        single = oracle.OracleIndex(so)
        for r in reads:
            single.insert1(list(reversed(r)))
        assert single.bwt() == got.bwt()
        want = jbrute.bwt_bruteforce(reads, so)
        assert bruteforce.bwt_bruteforce(reads, so) == want
        assert got.bwt() == want


@pytest.mark.parametrize("so", [0, 1, 2])
def test_engine_matches_the_oracle_copy(so, rng):
    for _ in range(3):
        reads = random_reads(rng, n=int(rng.integers(2, 30)), lo=1, hi=20,
                             with_n=True)
        eng = TorchBwt(so=so, device="cpu")
        eng.insert_multi([np.asarray(r, np.int8) for r in reads])
        want = _build(oracle, reads, so, 1)
        assert eng.bwt_array().tolist() == want.bwt()
        assert eng.counts().tolist() == want.counts()
