"""D: a cold kernel build, and a fresh process's way to a first kernel
result.

Counterpart of scripts/probe_warmup_aot.py::build_fns.pallas_fn, the toy
Pallas kernel ``x*2+1`` on int32 (8, 128) with which the script timed a
cold compile against loading a serialised executable in a fresh process.
The port compiles with nvcc into a shared library cached on disk
(_build.py), so the questions become:

1. how long a cold build takes, in a temporary build directory: of the
   toy library alone (csrc/probes/toy.cu) and of the main library;
2. how long a fresh process takes from its start to a first exact kernel
   result with the toy library already built: interpreter, torch import,
   CUDA context, library load, first launch;
3. the same child against an empty build directory, which it builds.

The results go to smoke_out/warmup_build.json.

    python -m ropebwt2_tpu_torch.probes.warmup_build
"""

import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import _timing
from .. import _build

LAUNCHES = 0  # toy kernel launches by this process
SHAPE = (8, 128)  # the script's
REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "smoke_out" / "warmup_build.json"


def toy_plain(x):
    return x * 2 + 1


@functools.cache
def toy_lib():
    """The loaded toy library, from this process's build directory."""
    return _build.load("toy")


def toy(x):
    """x * 2 + 1 on an int32 tensor: the toy kernel on CUDA tensors, its
    plain version on CPU tensors."""
    import torch

    if x.device.type == "cpu":
        return toy_plain(x)
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("toy: x must be a contiguous int32 tensor")
    global LAUNCHES
    y = torch.empty_like(x)
    rc = toy_lib().rb2_toy(x.data_ptr(), y.data_ptr(), x.numel(),
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rb2_toy")
    if not torch.cuda.is_current_stream_capturing():  # a capture launches none
        LAUNCHES += 1
    return y


def cold_build_s(name: str) -> float:
    """Seconds to build library ``name`` in an empty temporary directory
    beside the build cache (which it leaves as it is)."""
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as d:
        t0 = time.perf_counter()
        _build.build(name, d)
        return time.perf_counter() - t0


def child(build_dir: str) -> dict:
    """The fresh process: each step's seconds from this function's start
    to a first exact toy result, with the toy library in build_dir."""
    _build.BUILD = Path(build_dir)  # this process's build directory
    t0 = time.perf_counter()
    marks = {}
    import torch

    marks["import_torch_s"] = time.perf_counter() - t0
    torch.cuda.init()
    x = torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.int32,
                     device="cuda").view(SHAPE)
    torch.cuda.synchronize()
    marks["cuda_context_s"] = time.perf_counter() - t0
    toy_lib()
    marks["library_load_s"] = time.perf_counter() - t0
    y = toy(x)
    exact = bool(torch.equal(y, toy_plain(x)))
    marks["first_result_s"] = time.perf_counter() - t0
    return {"exact": exact, **marks}


def run_child(build_dir) -> dict:
    """Run ``child`` in a fresh interpreter; adds its wall time from
    spawn to exit."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "ropebwt2_tpu_torch.probes.warmup_build",
         "--child", str(build_dir)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"warmup child failed (rc {r.returncode}):\n"
                           + r.stderr[-2000:])
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    rec["process_wall_s"] = wall
    return rec


def check(say=print, device="cuda"):
    """The toy kernel at the script's shape against its plain version;
    returns max_abs_err."""
    import torch

    x = torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.int32,
                     device=device).view(SHAPE) - 500
    err = int((toy(x) - toy_plain(x)).abs().max())
    say(f"D toy x*2+1 on int32 {SHAPE}: max_abs_err {err} (tolerance 0)")
    return err


def measure(say=print):
    """Cold builds, then the fresh child against the warm toy library and
    against an empty build directory.  Writes smoke_out/warmup_build.json
    and returns the record."""
    rec = {"cold_build_s": {name: cold_build_s(name)
                            for name in ("toy", "main")}}
    _build.build("toy")  # the warm cache the first child loads from
    rec["child_cached"] = run_child(_build.BUILD)
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as d:
        rec["child_cold"] = run_child(d)
    for key in ("child_cached", "child_cold"):
        c = rec[key]
        say(f"D fresh process, {key.split('_')[1]} library: exact "
            f"{c['exact']}; torch import {c['import_torch_s']:.3f} s, CUDA "
            f"context {c['cuda_context_s']:.3f} s, library load "
            f"{c['library_load_s']:.3f} s, first result "
            f"{c['first_result_s']:.3f} s (cumulative); process wall "
            f"{c['process_wall_s']:.3f} s")
    say(f"D cold build in a temporary directory: toy library "
        f"{rec['cold_build_s']['toy']:.3f} s, main library "
        f"{rec['cold_build_s']['main']:.3f} s")
    if not (rec["child_cached"]["exact"] and rec["child_cold"]["exact"]):
        raise AssertionError("warmup child: the toy result is not exact")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1])))
        return 0
    if not _timing.require_card("warmup_build"):
        return 1
    err = check()
    measure()
    return 0 if err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
