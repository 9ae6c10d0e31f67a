"""The port's CLI against the JAX package's on the preprocessing flags
(-x -C -N -F -R, tests/test_cli.py's sets), with the native and the
Python reader; the RCLO recipe identity; and the kseq stream-boundary
phantom line.  Output bytes must be equal."""

import numpy as np
import pytest

from test_torch_cli import one_torch_thread, same  # noqa: F401

from conftest import random_reads, reads_to_lines


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("flags", [
    ["-LR", "-x3"],
    ["-LR", "-x1", "-C"],
    ["-L", "-x2"],
    ["-LR", "-N"],
    ["-LR", "-C"],
    ["-L", "-C", "-s"],
])
def test_preprocessing(flags, native, rng, tmp_path, monkeypatch):
    monkeypatch.setenv("ROPEBWT2_TPU_NATIVE", native)
    reads = random_reads(rng, n=30, lo=1, hi=18, with_n=True)
    # adversarial reads: all-N, palindromes, single bases
    reads += [[5, 5, 5], [1, 4], [2, 3, 2, 3], [1], [1, 2, 3, 5, 3, 2, 1]]
    same(flags, reads_to_lines(reads), tmp_path)


def test_rclo_recipe(rng, tmp_path):
    """-LRr equals input order after sorting by the reversed complement
    (README.md:21-25)."""
    reads = random_reads(rng, n=20, lo=3, hi=10)
    out = same(["-LRr"], reads_to_lines(reads), tmp_path)
    comp = lambda c: 5 - c if 1 <= c <= 4 else c  # noqa: E731
    presorted = sorted(reads,
                       key=lambda r: tuple(comp(c) for c in reversed(r)))
    assert same(["-LR"], reads_to_lines(presorted), tmp_path) == out


@pytest.mark.parametrize("native", ["1", "0"])
def test_kseq_stream_boundary_phantom_line(native, tmp_path, monkeypatch):
    """A line-mode stream whose length is a multiple of kseq's 16384-byte
    buffer (the empty stream too) gives one phantom empty read; one byte
    less does not."""
    monkeypatch.setenv("ROPEBWT2_TPU_NATIVE", native)
    rng = np.random.default_rng(3)
    reads = rng.integers(1, 5, size=(160, 101)).astype(np.int8)
    lut = np.frombuffer(b"$ACGTN", dtype=np.uint8)
    data = bytearray()
    for r in lut[reads]:
        data += bytes(r) + b"\n"
    data += b"A" * (16384 - len(data) - 1) + b"\n"
    assert len(data) == 16384
    for payload in (bytes(data), bytes(data[:-103] + b"G\n"), b""):
        same(["-LRs"], payload, tmp_path)
