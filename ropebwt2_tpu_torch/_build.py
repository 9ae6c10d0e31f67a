"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, which ``ctypes`` loads.
The library lives in ``_build/`` beside this file, named by a hash of the
sources and flags, so it is built once per source version, at first use
(never at import).  The compiler's register and shared-memory report
(``-Xptxas -v``) is kept in ``_build/<name>.log``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD = _HERE / "_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# (name, argument types) of every C entry point; each returns cudaError_t
_P = ctypes.c_void_p
_I = ctypes.c_longlong
ENTRY_POINTS = {
    # old, insmap, start, n, out, rows, alloc, nb, stream
    "rb2_merge": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # vp, psym, varr, sarr, start, p_after, vp_out, psym_out, rows,
    # pcap, nb, inf, stream
    "rb2_pending_merge": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

BUILD_SECONDS = None  # wall time of this process's build (None: cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD / f"librb2_{h.hexdigest()[:16]}.so"


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if this source version
    has not been built yet."""
    global BUILD_SECONDS
    path = library_path()
    if not path.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp),
               *[str(f) for f in sorted(CSRC.glob("*.cu"))]]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        path.with_suffix(".log").write_text(r.stdout + r.stderr)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
        BUILD_SECONDS = time.perf_counter() - t0
    so = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return so


def check(rc: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
