"""The port's run drivers (ropebwt2_tpu_torch/scripts/) against the JAX
repo's scripts they replace, on the CPU, each script's main() run
in-process on the same environment (monkeypatch), its record under
tmp_path:

* readgen: ReadGen and from_env give scripts/readgen.py's stream, byte
  for byte, in both modes at three seeds;
* scale_run: the BWT's md5, the final counts and, on the run tier, the
  symbols a slot equal scripts/scale_run.py's, on the flat tier, on a
  read set whose text is a multiple of kseq's 16384-byte buffer (2048
  reads x 127: the phantom empty read) and on the run tier planned
  upfront;
* longread_run: the md5 equals scripts/longread_run.py's on 16 reads of
  150-400 bp;
* gen_scale_input: the same bytes as scripts/gen_scale_input.py;
* scale_shards (WEAK_CPU=1): rank 0's sharded BWT at 1, 2 and 4 gloo
  ranks equals a TpuBwt's on the same reads (the script itself holds it
  against TorchBwt's).

Tolerance 0: every compared value is an integer or a hash."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import ropebwt2_tpu.engine as jax_engine

from ropebwt2_tpu_torch.cli import engine_options
from ropebwt2_tpu_torch.engine import TorchBwt
from ropebwt2_tpu_torch.scripts import (
    gen_scale_input, longread_run, readgen, scale_run, scale_shards,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small torch ops on one thread: the suite runs on parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_script(name):
    """A module of the JAX repo's scripts/, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_engines(monkeypatch):
    """Every TpuBwt that the JAX scripts make, in order."""
    made = []

    class Recorded(jax_engine.TpuBwt):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(jax_engine, "TpuBwt", Recorded)
    return made


@pytest.mark.parametrize("mode", ["uniform", "coverage"])
@pytest.mark.parametrize("seed", [0, 12345, 777])
def test_readgen_stream(mode, seed):
    ref = jax_script("readgen")
    kw = dict(seed=seed, nreads=3000, L=50, mode=mode, cov=20.0, err=0.02)
    a, b = readgen.ReadGen(**kw), ref.ReadGen(**kw)
    for m in (1000, 7, 1993):
        assert np.array_equal(a.batch(m), b.batch(m))
    env = {"SCALE_SEED": str(seed), "SCALE_DATA": mode, "SCALE_COV": "30",
           "SCALE_ERR": "0.005"}
    a, b = readgen.from_env(env, 2000, 40, 512), ref.from_env(env, 2000, 40,
                                                               512)
    for _ in range(3):
        x = a.batch(512)
        assert x.dtype == np.uint8 and x.shape == (512, 40)
        assert np.array_equal(x, b.batch(512))


SCALE_CASES = {
    "flat": ({"SCALE_NREADS": "1500", "SCALE_L": "101",
              "SCALE_MBATCH": "512", "SCALE_DATA": "coverage",
              "SCALE_COV": "20", "SCALE_SEED": "5"}, None),
    "phantom": ({"SCALE_NREADS": "2048", "SCALE_L": "127",
                 "SCALE_MBATCH": "1024"}, None),
    "runs": ({"SCALE_NREADS": "1536", "SCALE_L": "64",
              "SCALE_MBATCH": "512", "SCALE_DATA": "coverage",
              "SCALE_COV": "30", "SCALE_ERR": "0.003", "SCALE_SEED": "8"},
             "1"),
}


@pytest.mark.parametrize("case", list(SCALE_CASES))
def test_scale_run_matches_jax(case, monkeypatch, tmp_path, jax_engines):
    env, runs = SCALE_CASES[case]
    for k, v in {**env, "SCALE_MD5": "1", "SCALE_SO": "1"}.items():
        monkeypatch.setenv(k, v)
    if runs:
        monkeypatch.setenv("ROPEBWT2_TPU_RUNS", runs)
    monkeypatch.setenv("SCALE_JSON", str(tmp_path / "port.json"))
    got = scale_run.main(device="cpu")
    monkeypatch.setenv("SCALE_JSON", str(tmp_path / "jax.json"))
    jax_script("scale_run").main()
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got["bwt_md5"] == want["bwt_md5"]
    assert got["counts"] == np.asarray(jax_engines[-1].counts()).tolist()
    for k in ("symbols", "reads", "read_len", "sorting_order", "data"):
        assert got[k] == want[k], k
    assert got["index_tier"] == ("runs" if runs else "flat")
    assert ("sym_per_run" in got) == ("sym_per_run" in want) == bool(runs)
    if runs:
        for k in ("run_slots", "sym_per_run", "index_bytes_per_sym"):
            assert got[k] == want[k], k
    if case == "phantom":  # the phantom read: one more sentinel
        assert got["counts"][0] == 2048 + 1 + 4


@pytest.mark.parametrize("tier,total", [
    ({}, 100_000), ({"ROPEBWT2_TPU_PACK4": "1"}, 100_000),
    ({"ROPEBWT2_TPU_RUNS": "1"}, 100_000),
    ({"ROPEBWT2_TPU_RUNS": "1"}, 3_000_000_000)])
def test_plan_matches_the_jax_upfront_plan(tier, total, monkeypatch):
    """TorchBwt.plan(total) makes the index that the JAX scripts'
    _plan(total) makes: the capacity on the flat and packed tiers; on the
    run tier the conversion alone, its slots and its table dtype (int64
    past 2^31 symbols), with no slots for the total."""
    for k, v in tier.items():
        monkeypatch.setenv(k, v)
    ref = jax_engine.TpuBwt(so=1)
    ref._plan(total)
    eng = TorchBwt(so=1, device="cpu", **engine_options())
    eng.plan(total)
    assert type(eng.state).__name__ == type(ref.state).__name__
    if "ROPEBWT2_TPU_RUNS" in tier:
        assert eng.state.rcap == ref.state.rcap < total
        assert eng.state.bstart.element_size() == \
            ref.state.bstart.dtype.itemsize == (8 if total > 2**31 else 4)
    else:
        assert eng.state.cap == ref.state.cap >= total


def test_longread_run_matches_jax(monkeypatch, tmp_path):
    for k, v in {"LR_NREADS": "16", "LR_MIN": "150", "LR_MAX": "400",
                 "LR_REF": str(tmp_path / "no_reference")}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("LR_JSON", str(tmp_path / "port.json"))
    got = longread_run.main(device="cpu")
    monkeypatch.setenv("LR_JSON", str(tmp_path / "jax.json"))
    jax_script("longread_run").main()
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got["bwt_md5"] == want["bwt_md5"]
    for k in ("reads", "len_range", "symbols", "rounds"):
        assert got[k] == want[k], k
    assert got["md5_matches_reference"] is None


def test_gen_scale_input_bytes(monkeypatch, tmp_path):
    for k, v in {"SCALE_NREADS": "2500", "SCALE_L": "77",
                 "SCALE_MBATCH": "1000", "SCALE_DATA": "coverage",
                 "SCALE_SEED": "3"}.items():
        monkeypatch.setenv(k, v)
    port, ref = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert gen_scale_input.main([str(port)]) == 0
    monkeypatch.setattr("sys.argv", ["gen_scale_input.py", str(ref)])
    jax_script("gen_scale_input").main()
    data = port.read_bytes()
    assert data == ref.read_bytes()
    assert len(data) == 2500 * 78


def test_text_md5_chunks_equal_the_whole():
    """An engine hashed chunk by chunk (packed and run tiers expanding
    one chunk at a time) equals the hash of its whole bwt_array."""
    from ropebwt2_tpu_torch.engine import TorchBwt

    reads = readgen.ReadGen(seed=4, nreads=600, L=60, mode="coverage",
                            cov=15.0).batch(600).view(np.int8)
    whole = None
    for kw in ({}, {"pack4": 1}, {"runs": 1}):
        eng = TorchBwt(so=1, device="cpu", **kw)
        eng.insert_multi(reads)
        want = scale_run.text_md5(eng.bwt_array())
        assert scale_run.text_md5(eng, chunk=1024) == want
        assert whole in (None, want)
        whole = want


def test_scale_shards_parity(monkeypatch):
    monkeypatch.setenv("WEAK_M0", "48")
    monkeypatch.setenv("WEAK_L", "24")
    monkeypatch.setenv("WEAK_CPU", "1")
    rows = scale_shards.main()
    assert [d for d, _, _, _ in rows] == [1, 2, 4]
    assert [s for _, s, _, _ in rows] == [d * 48 * 25 for d in (1, 2, 4)]
    rng = np.random.default_rng(3)  # the script's draws, in its order
    for d, _, _, got in rows:
        reads = rng.integers(1, 5, size=(d * 48, 24)).astype(np.int8)
        ref = jax_engine.TpuBwt(so=1, K=256)
        ref.insert_multi(reads)
        assert np.array_equal(got, ref.bwt_array()), d


def test_drivers_refuse_without_a_card(monkeypatch):
    """No device and no card: the drivers raise through TorchBwt's "no CUDA
    device" (they never fall back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SCALE_NREADS", "16")
    monkeypatch.setenv("LR_NREADS", "2")
    monkeypatch.delenv("WEAK_CPU", raising=False)
    for mod in (scale_run, longread_run, scale_shards):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main()
