"""The port's command line driver (ropebwt2_tpu_torch.cli) against the JAX
package's on the CPU: the same flags on the same input give the same
output bytes.  Both CLIs run in-process (``main(argv)``, reading a file
and writing with -o; the port with device="cpu").  Two subprocesses cover
what an in-process call cannot: the CLI reading stdin and writing stdout,
and the run without a device on a machine with no card, which must fail.

This file holds the input formats and batching; the preprocessing flags
are in test_torch_cli_preprocess.py, the output modes and -i restore in
test_torch_cli_outputs.py."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ropebwt2_tpu import cli as jcli

from ropebwt2_tpu_torch import cli as tcli

from conftest import random_reads, reads_to_lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's many small torch ops on one thread: with every
    core busy (the suite runs on parallel workers) the intra-op pool's
    spinning threads slow each op by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_both(flags, data, tmp_path, name="in.txt"):
    """(port output, JAX output) bytes of ``flags`` on ``data``."""
    p = tmp_path / name
    p.write_bytes(data)
    outs = []
    for tag, run in (("t", lambda a: tcli.main(a, device="cpu")),
                     ("j", jcli.main)):
        out = tmp_path / f"{tag}.out"
        assert run([*flags, "-o", str(out), str(p)]) == 0, (tag, flags)
        outs.append(out.read_bytes())
    return outs


def same(flags, data, tmp_path, **kw):
    got, want = run_both(flags, data, tmp_path, **kw)
    assert got == want, flags
    return got


def to_fasta(reads) -> bytes:
    tab = "$ACGTN"
    return "".join(
        f">r{i}\n" + "".join(tab[c] for c in r) + "\n"
        for i, r in enumerate(reads)
    ).encode()


def to_fastq(reads, rng) -> bytes:
    tab = "$ACGTN"
    out = []
    for i, r in enumerate(reads):
        seq = "".join(tab[c] for c in r)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 42, len(r)))
        out.append(f"@r{i}\n{seq}\n+\n{qual}\n")
    return "".join(out).encode()


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("flags", ["-LR", "-LRs", "-LRr", "-L", "-LF"])
def test_line_mode(flags, native, rng, tmp_path, monkeypatch):
    monkeypatch.setenv("ROPEBWT2_TPU_NATIVE", native)
    reads = random_reads(rng, n=30, lo=3, hi=20, with_n=True)
    same([flags], reads_to_lines(reads), tmp_path)


def test_fasta_and_gzip_fasta(rng, tmp_path):
    reads = random_reads(rng, n=20, lo=4, hi=25)
    same(["-R"], to_fasta(reads), tmp_path)
    same(["-R"], gzip.compress(to_fasta(reads)), tmp_path, name="in.fa.gz")


@pytest.mark.parametrize("native", ["1", "0"])
def test_fastq_quality_mask(native, rng, tmp_path, monkeypatch):
    monkeypatch.setenv("ROPEBWT2_TPU_NATIVE", native)
    data = to_fastq(random_reads(rng, n=25, lo=5, hi=30), rng)
    for flags in (["-R", "-q20"], ["-R", "-q20", "-N"], ["-s", "-q20"]):
        same(flags, data, tmp_path)


@pytest.mark.parametrize("flags", [["-LR", "-m100"], ["-Ls", "-m", "64"],
                                   ["-LR", "-m0"], ["-Lr", "-m0"]])
def test_batching(flags, rng, tmp_path):
    """Small -m (many batches) and -m0 (one string at a time)."""
    reads = random_reads(rng, n=25, lo=3, hi=12)
    same(flags, reads_to_lines(reads), tmp_path)


def test_batch_size_parsing():
    for arg in ("0", "100", "64m", "10g", "1.5k", "7K"):
        assert tcli.parse_batch_size(arg) == jcli.parse_batch_size(arg)


RUNS_OFF = {"runs": None, "runs_margin": 2.0, "runs_rcap": 0}


@pytest.mark.parametrize("env,want", [
    ({}, {"defer_r": None, "pack4": "auto", **RUNS_OFF}),
    ({"ROPEBWT2_TPU_DEFER_R": "8", "ROPEBWT2_TPU_PACK4": "0"},
     {"defer_r": 8, "pack4": 0, **RUNS_OFF}),
    ({"ROPEBWT2_TPU_DEFER_R": "-1", "ROPEBWT2_TPU_PACK4": "1000"},
     {"defer_r": None, "pack4": 1000, **RUNS_OFF}),
    ({"ROPEBWT2_TPU_RUNS": "1", "ROPEBWT2_TPU_RUNS_MARGIN": "0.35",
      "ROPEBWT2_TPU_RUNS_RCAP": "65536"},
     {"defer_r": None, "pack4": "auto", "runs": 1, "runs_margin": 0.35,
      "runs_rcap": 65536}),
    ({"ROPEBWT2_TPU_RUNS": "0"},
     {"defer_r": None, "pack4": "auto", **RUNS_OFF}),
])
def test_engine_options_from_the_environment(env, want, monkeypatch, rng,
                                             tmp_path):
    for k in ("ROPEBWT2_TPU_DEFER_R", "ROPEBWT2_TPU_PACK4",
              "ROPEBWT2_TPU_RUNS", "ROPEBWT2_TPU_RUNS_MARGIN",
              "ROPEBWT2_TPU_RUNS_RCAP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tcli.engine_options() == want
    reads = random_reads(rng, n=40, lo=3, hi=30)
    same(["-LRs"], reads_to_lines(reads), tmp_path)


def test_sharded_is_refused(monkeypatch, tmp_path, capsys):
    """ROPEBWT2_TPU_SHARDED=1 builds on the sharded engine (a world of one
    on the CPU here; tests/test_torch_sharded_cli.py holds its bytes to the
    JAX CLI's); it is refused only where there is no device to run on: no
    device given and no card."""
    monkeypatch.setenv("ROPEBWT2_TPU_SHARDED", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tmp_path / "in.txt"
    p.write_bytes(b"ACGT\n")
    assert tcli.main(["-L", str(p)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    out = tmp_path / "out.txt"
    assert tcli.main(["-L", "-o", str(out), str(p)], device="cpu") == 0
    assert "sharded engine over 1 devices" in capsys.readouterr().err
    assert out.read_bytes() == b"TT$$AACCGG\n"


def _env():
    env = dict(os.environ)
    env.pop("ROPEBWT2_TPU_NATIVE", None)
    env["PYTHONPATH"] = REPO
    return env


def test_stdin_to_stdout_in_a_process(rng, tmp_path):
    """The CLI's main reading stdin (a pipe) and writing stdout, in a
    process of its own, on the CPU."""
    reads = random_reads(rng, n=30, lo=3, hi=20, with_n=True)
    data = reads_to_lines(reads)
    code = ("import sys\nfrom ropebwt2_tpu_torch.cli import main\n"
            "sys.exit(main(sys.argv[1:], device='cpu'))\n")
    r = subprocess.run([sys.executable, "-c", code, "-LRs", "-d"],
                       input=data, capture_output=True, cwd=REPO,
                       env=_env(), timeout=120)
    assert r.returncode == 0, r.stderr.decode()
    assert b"[M::main] reader: native" in r.stderr
    _, want = run_both(["-LRs", "-d"], data, tmp_path)
    assert r.stdout == want


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_and_no_device_fails(tmp_path):
    """``python -m ropebwt2_tpu_torch.cli`` builds on the card; with none it
    exits non-zero with TorchBwt's message, and never builds on the CPU."""
    p = tmp_path / "in.txt"
    p.write_bytes(b"ACGT\nGGCA\n")
    r = subprocess.run([sys.executable, "-m", "ropebwt2_tpu_torch.cli",
                        "-L", "-o", str(tmp_path / "out"), str(p)],
                       stdin=subprocess.DEVNULL, capture_output=True,
                       text=True, cwd=REPO, env=_env(), timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "out").exists()


def test_rlo_output_is_one_sort(rng, tmp_path):
    """RLO output does not depend on the input order or the batching, and
    equals input order after an explicit reverse-lexicographic sort
    (README.md:15-25)."""
    reads = random_reads(rng, n=25, lo=3, hi=12)
    out = same(["-LRs"], reads_to_lines(reads), tmp_path)
    shuffled = list(reads)
    rng.shuffle(shuffled)
    got = same(["-LRs", "-m50"], reads_to_lines(shuffled), tmp_path)
    assert got == out
    presorted = sorted(reads, key=lambda r: tuple(reversed(r)))
    got = same(["-LR"], reads_to_lines(presorted), tmp_path)
    assert got == out
    assert np.frombuffer(out, np.uint8).size == \
        sum(len(r) + 1 for r in reads) + 1
