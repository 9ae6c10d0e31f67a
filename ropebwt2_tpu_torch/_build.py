"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, which ``ctypes`` loads.  The
library lives in ``_build/`` beside this file, named by a hash of the
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# (name, argument types) of every C entry point; each returns cudaError_t
_P = ctypes.c_void_p
_I = ctypes.c_longlong
ENTRY_POINTS = {
    # old, insmap, start, n, out, rows, alloc, nb, stream
    "rb2_merge": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # old, insmap, start, n, out, rows, alloc_bytes, nb, stream
    "rb2_merge_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
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
        tag = f"{os.getpid()}.tmp"
        t0 = time.perf_counter()
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [BUILD / f"{src.stem}.{tag}.o" for src in srcs]
        procs = [subprocess.Popen(
            [_nvcc(), *FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        outs = [p.communicate()[0] for p in procs]
        link = None
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run(
                [_nvcc(), *ARCH, "-shared", "-o", str(path.with_suffix(
                    f".{tag}")), *map(str, objs)],
                capture_output=True, text=True)
            outs.append(link.stdout + link.stderr)
        for obj in objs:
            obj.unlink(missing_ok=True)
        path.with_suffix(".log").write_text("".join(outs))
        if link is None or link.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + "".join(outs))
        # atomic: a concurrent loader sees all or none
        os.replace(path.with_suffix(f".{tag}"), path)
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
