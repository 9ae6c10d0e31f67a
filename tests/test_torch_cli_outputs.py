"""The port's CLI against the JAX package's in every output mode (text,
-d FMD, -b FMR, -B CRLF, -T tree) with the native and the Python writers,
and -b followed by -i restore plus a second input, which also equals a
one-shot build of both inputs.  Output bytes must be equal."""

import pytest

from ropebwt2_tpu import cli as jcli

from ropebwt2_tpu_torch import cli as tcli

from test_torch_cli import one_torch_thread, same  # noqa: F401

from conftest import random_reads, reads_to_lines


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("mode", ["", "-d", "-b", "-B", "-T"])
def test_output_modes(mode, native, rng, tmp_path, monkeypatch):
    monkeypatch.setenv("ROPEBWT2_TPU_NATIVE", native)
    reads = random_reads(rng, n=60, lo=1, hi=30, with_n=True)
    reads += [[1] * 40] * 20  # long runs
    for flags in (["-Ls"], ["-L", "-r"]):
        same(flags + ([mode] if mode else []), reads_to_lines(reads),
             tmp_path)


@pytest.mark.parametrize("native", ["1", "0"])
def test_fmr_dump_then_restore(native, rng, tmp_path, monkeypatch):
    """-b on a first input, then -i with a second, in both CLIs: equal
    bytes, and equal to one build of both inputs (RLO output does not
    depend on the batching)."""
    monkeypatch.setenv("ROPEBWT2_TPU_NATIVE", native)
    first = reads_to_lines(random_reads(rng, n=50, lo=1, hi=25, with_n=True))
    second = reads_to_lines(random_reads(rng, n=40, lo=1, hi=25))
    (tmp_path / "a.txt").write_bytes(first)
    (tmp_path / "b.txt").write_bytes(second)
    outs = {}
    for tag, run in (("t", lambda a: tcli.main(a, device="cpu")),
                     ("j", jcli.main)):
        fmr = tmp_path / f"{tag}.fmr"
        assert run(["-Ls", "-b", "-o", str(fmr), str(tmp_path / "a.txt")]) \
            == 0
        for mode in ("", "-d", "-b"):
            out = tmp_path / f"{tag}{mode}.out"
            args = ["-L", "-i", str(fmr), "-o", str(out)]
            assert run(args + ([mode] if mode else [])
                       + [str(tmp_path / "b.txt")]) == 0
            outs[tag, mode] = out.read_bytes()
    for mode in ("", "-d", "-b"):
        assert outs["t", mode] == outs["j", mode], mode
    assert same(["-Ls"], first + second, tmp_path) == outs["t", ""]
    assert same(["-Ls", "-d"], first + second, tmp_path) == outs["t", "-d"]
