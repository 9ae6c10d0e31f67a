"""The port's CLI under ROPEBWT2_TPU_SHARDED=1 against the JAX CLI under
the same switch (its sharded engine on the 8-device CPU mesh): the same
bytes in-process at a world of one on the CPU (text, -d, -b, -B, and -b
then -i), and from ``python -m torch.distributed.run --nproc_per_node 2``
on two gloo ranks, where only rank 0 writes (the output goes to stdout,
which both ranks share)."""

import os
import subprocess
import sys

import pytest
import torch

from ropebwt2_tpu import cli as jcli

from ropebwt2_tpu_torch import cli as tcli

from conftest import random_reads, reads_to_lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def sharded(monkeypatch):
    monkeypatch.setenv("ROPEBWT2_TPU_SHARDED", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_both(argv, tmp_path, capsys):
    """(port bytes, JAX bytes) of the CLIs with ``argv`` and -o."""
    outs = []
    for tag, run in (("t", lambda a: tcli.main(a, device="cpu")),
                     ("j", jcli.main)):
        out = tmp_path / f"{tag}.out"
        assert run([*argv[:-1], "-o", str(out), argv[-1]]) == 0, tag
        err = capsys.readouterr().err
        assert "sharded engine over" in err, tag
        outs.append(out.read_bytes())
    return outs


def test_world_of_one_matches_the_jax_cli(rng, tmp_path, capsys):
    reads = random_reads(rng, n=60, lo=3, hi=30, with_n=True)
    p = tmp_path / "in.txt"
    p.write_bytes(reads_to_lines(reads))
    for flags in (["-LRs"], ["-LRs", "-d"], ["-LR", "-b"], ["-LRr", "-B"]):
        got, want = run_both([*flags, str(p)], tmp_path, capsys)
        assert got == want, flags
    # -b on a first file, then -i with a second
    q = tmp_path / "more.txt"
    q.write_bytes(reads_to_lines(random_reads(rng, n=40, lo=3, hi=25)))
    fmr = tmp_path / "first.fmr"
    assert tcli.main(["-LRs", "-b", "-o", str(fmr), str(p)],
                     device="cpu") == 0
    got, want = run_both(["-LR", "-d", "-i", str(fmr), str(q)], tmp_path,
                         capsys)
    assert got == want


def test_torchrun_two_gloo_ranks_match_the_jax_cli(rng, tmp_path, capsys):
    reads = random_reads(rng, n=80, lo=3, hi=30, with_n=True)
    p = tmp_path / "in.txt"
    p.write_bytes(reads_to_lines(reads))
    script = tmp_path / "cli_cpu.py"
    script.write_text("import sys\nfrom ropebwt2_tpu_torch.cli import main\n"
                      "sys.exit(main(sys.argv[1:], device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", str(script), "-LRs", "-d", str(p)],
        capture_output=True, cwd=REPO, env=env, timeout=300)
    err = r.stderr.decode()
    assert r.returncode == 0, err[-3000:]
    assert err.count("sharded engine over 2 devices") == 2
    out = tmp_path / "j.out"
    assert jcli.main(["-LRs", "-d", "-o", str(out), str(p)]) == 0
    assert r.stdout == out.read_bytes()
