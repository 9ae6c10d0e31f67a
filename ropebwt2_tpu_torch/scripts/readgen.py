"""Shared read-set generator for scale/bench runs and their reference-
binary parity inputs.

Two modes:
* uniform  — i.i.d. ACGT reads (the round-2..4 scale inputs; worst case
  for run compression and rank locality, unrepresentative of the
  reference's benchmark datasets).
* coverage — reads sampled from both strands of one synthetic genome at
  a target coverage with i.i.d. substitution errors: the shape of the
  reference's own benchmarks (worm = 66.8M x 100 bp over ~100 Mbp at
  ~47x, NA12878 = 39x human; README.md:139-152).

Determinism: the read STREAM is a pure function of (seed, nreads, L,
mode, cov, err, mbatch) — both scale_run.py and gen_scale_input.py draw
through this module so the engine input and the reference-binary input
are identical.  This is the port's copy of scripts/readgen.py (the port
imports nothing of the JAX repo's scripts): the same stream, byte for
byte.  The genome derives from seed+1 (a separate Generator),
so batch draws are independent of genome length.
"""

import numpy as np


class ReadGen:
    def __init__(self, *, seed, nreads, L, mode="uniform", cov=47.0,
                 err=0.01):
        self.mode = mode
        self.L = L
        self.rng = np.random.default_rng(seed)
        if mode == "coverage":
            glen = max(int(nreads * L / cov), 4 * L)
            g = np.random.default_rng(seed + 1)
            self.genome = g.integers(1, 5, glen, dtype=np.uint8)
            self.rc = (5 - self.genome).astype(np.uint8)
            self.err = err
        elif mode != "uniform":
            raise ValueError(mode)

    def batch(self, m):
        """(m, L) uint8 nt6-code read matrix."""
        L, rng = self.L, self.rng
        if self.mode == "uniform":
            return rng.integers(1, 5, size=(m, L), dtype=np.uint8)
        starts = rng.integers(0, self.genome.shape[0] - L, m)
        idx = starts[:, None] + np.arange(L)[None, :]
        fwd = self.genome[idx]
        use_rc = rng.random(m) < 0.5
        rev = self.rc[idx][:, ::-1]
        reads = np.where(use_rc[:, None], rev, fwd)
        if self.err > 0:
            emask = rng.random((m, L)) < self.err
            subs = rng.integers(1, 5, size=(m, L), dtype=np.uint8)
            reads = np.where(emask, subs, reads)
        return reads.astype(np.uint8)


def from_env(env, nreads, L, mbatch):  # noqa: ARG001 (mbatch: stream doc)
    """ReadGen from SCALE_* environment conventions."""
    import os

    e = os.environ if env is None else env
    return ReadGen(
        seed=int(e.get("SCALE_SEED", 12345)),
        nreads=nreads,
        L=L,
        mode=e.get("SCALE_DATA", "uniform"),
        cov=float(e.get("SCALE_COV", 47.0)),
        err=float(e.get("SCALE_ERR", 0.01)),
    )
