"""Build and load the package's CUDA kernels.

Three libraries, each with a plain C interface that ``ctypes`` loads:

- ``main``: every ``csrc/*.cu``, the kernels of the build path (A, B, C
  and the rank kernels of ``csrc/rank.cu``);
- ``probes``: the probe suite's kernels under ``csrc/probes/`` (kernel A's
  stages looped alone, the Hopper feature probes, the rank kernels'
  earlier design and parts, which ``chip_smoke.py --rank-variants``
  times);
- ``toy``: the toy kernel (``csrc/probes/toy.cu``) alone, which
  ``probes/warmup_build.py`` launches and builds cold to time the
  toolchain.

Every translation unit is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library in a build directory (``_build/`` beside this file unless
the caller names another), named by a hash of the sources and flags, so
it is built once per source version, at first use (never at import).
The compiler's register and shared-memory report (``-Xptxas -v``) is kept
in ``<library>.log``.  A unit marked optional (one Hopper feature probe)
may fail to compile: the library is linked without it and its compiler
output is kept in ``<library>.units.json``, so the probe can report it; a
required unit that fails fails the build.
"""

import ctypes
import dataclasses
import functools
import hashlib
import json
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
PROBE_SRC = CSRC / "probes"
BUILD = _HERE / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# (name, argument types) of every C entry point; each returns cudaError_t
_P = ctypes.c_void_p
_I = ctypes.c_longlong
ENTRY_POINTS = {
    # old, insmap, start, n, out, prefix, scratch, alloc, nb, G, wide,
    # stream
    "rb2_merge": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # old, insmap, start, n, out, rows, alloc_bytes, nb, stream
    "rb2_merge_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # vp, psym, varr, sarr, start, p_after, vp_out, psym_out, rows,
    # pcap, nb, inf, stream
    "rb2_pending_merge": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # bwt, prefix, pos, out, Q, K, nprefix, nrows, wide, stream
    "rb2_rank_flat": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # pbwt, blkA, blkB, pos, out, Q, nprows, nrp, nanchor, stream
    "rb2_rank_packed": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # vp, psym, prefix, g, p, occ, Q, pcap, stream
    "rb2_rank_pend": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # bwt, prefix, vp, psym, pprefix, g, out, Q, K, nprefix, nrows, pcap,
    # lo, hi, wide, stream
    "rb2_rank_virtual": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P],
    # pbwt, blkA, blkB, vp, psym, pprefix, g, out, Q, nprows, nrp,
    # nanchor, pcap, stream
    "rb2_rank_virtual_packed": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _P],
}
# the Hopper feature probes of csrc/probes/features.cu, one unit each
# (-DRB2_FEATURE=<index>); section 0, the two plain stagings, is required
FEATURES = ("tma", "cp_async", "nibble", "simd_count", "cluster", "dynsmem")
_WINDOWS = [_P, _P, _P, _I, _I, _P]  # old, o0, out, nwin, alloc, stream
_FEATURE_ENTRY_POINTS = {
    "tma": {"rb2_feat_tma": _WINDOWS},
    "cp_async": {"rb2_feat_cp_async": _WINDOWS},
    # packed, o0, unpacked, repacked, nwin, cap, stream
    "nibble": {"rb2_feat_nibble": [_P, _P, _P, _P, _I, _I, _P]},
    # sym, rows, nrows, stream
    "simd_count": {"rb2_feat_simd_count": [_P, _P, _I, _P]},
    # x, out, nchunks, stream
    "cluster": {"rb2_feat_cluster": [_P, _P, _I, _P]},
    # x, out, bytes per CTA, nctas, stream
    "dynsmem": {"rb2_feat_dynsmem": [_P, _P, _I, _I, _P]},
}


@dataclasses.dataclass(frozen=True)
class Unit:
    """One translation unit: a source, its extra nvcc flags, and the entry
    points it defines."""

    name: str
    source: Path
    flags: tuple = ()
    optional: bool = False
    entry_points: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Library:
    prefix: str  # file name prefix
    units: tuple
    headers: tuple  # headers the hash covers


def _main_library() -> Library:
    units = [Unit(src.stem, src) for src in sorted(CSRC.glob("*.cu"))]
    # the main entry points belong to the library as a whole
    units[0] = dataclasses.replace(units[0], entry_points=ENTRY_POINTS)
    return Library("librb2", tuple(units), tuple(sorted(CSRC.glob("*.cuh"))))


def _probe_library() -> Library:
    stages = {  # old/insmap/sym, o0/-, out, acc, alloc, iters, grid, stream
        "rb2_stage_window": [_P, _P, _P, _P, _I, _I, _I, _P],
        "rb2_stage_scan": [_P, _P, _P, _I, _I, _P],
        "rb2_stage_gather": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "rb2_stage_counts": [_P, _P, _P, _I, _I, _I, _P],
    }
    rankvar = {  # the rank kernels measured by parts (csrc/probes)
        # mode, bwt, prefix, pos, sub, extra, out, Q, K, nprefix, nrows,
        # wide, stream
        "rb2_rankvar_flat": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _P],
        # vp, psym, prefix, g, p, occ, Q, pcap, stream
        "rb2_rankvar_pend": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
        # pbwt, blkA, blkB, pos, sub, extra, out, Q, nprows, nrp,
        # nanchor, stream
        "rb2_rankvar_packed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _P],
        # csrc/rank.cu's kernels by part: bwt, prefix, pos, out, Q,
        # nprefix, nrows, stream; count, vp, psym, prefix, g, p, occ, Q,
        # pcap, stream; pbwt, blkA, blkB, pos, out, Q, nprows, nrp,
        # nanchor, stream
        "rb2_rankpart_flat": [_P, _P, _P, _P, _I, _I, _I, _P],
        "rb2_rankpart_pend": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _P],
        "rb2_rankpart_packed": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # csrc/rank.cu's packed kernels under other launch bounds: ctas,
        # then rb2_rank_packed's and rb2_rank_virtual_packed's arguments
        "rb2_rankbound_packed": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "rb2_rankbound_virtual_packed": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                         _I, _I, _I, _I, _I, _P],
    }
    feat = PROBE_SRC / "features.cu"
    units = [
        Unit("stages", PROBE_SRC / "stages.cu", entry_points=stages),
        Unit("features_0", feat, ("-DRB2_FEATURE=0",), entry_points={
            "rb2_stage_bytes": _WINDOWS, "rb2_stage_vec16": _WINDOWS}),
    ] + [Unit(f"features_{i}", feat, (f"-DRB2_FEATURE={i}",), True,
              _FEATURE_ENTRY_POINTS[f]) for i, f in enumerate(FEATURES, 1)
         ] + [Unit("rank_variants", PROBE_SRC / "rank_variants.cu",
                   entry_points=rankvar)]
    # rank_variants.cu includes csrc/rank.cu
    headers = sorted(PROBE_SRC.glob("*.cuh")) + [CSRC / "common.cuh",
                                                 CSRC / "rank.cu"]
    return Library("librb2probes", tuple(units), tuple(headers))


def _toy_library() -> Library:
    toy = {"rb2_toy": [_P, _P, _I, _P]}  # x, y, n, stream
    return Library("librb2toy", (Unit("toy", PROBE_SRC / "toy.cu",
                                      entry_points=toy),), ())


LIBRARIES = {"main": _main_library, "probes": _probe_library,
             "toy": _toy_library}
BUILD_SECONDS = None  # this process's build of main, s (None: cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str = "main", build_dir=None) -> Path:
    spec = LIBRARIES[name]()
    h = hashlib.sha256(" ".join(FLAGS).encode())
    files = sorted({u.source for u in spec.units}) + list(spec.headers)
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    for u in spec.units:
        if u.flags:
            h.update(" ".join((u.name, *u.flags)).encode())
    return Path(build_dir or BUILD) / f"{spec.prefix}_{h.hexdigest()[:16]}.so"


def unit_status(name: str = "main") -> dict:
    """{unit: "ok" or its compiler output} of a built library ({} for a
    library built before this record was kept: all its units compiled)."""
    path = library_path(name).with_suffix(".units.json")
    return json.loads(path.read_text()) if path.exists() else {}


def build(name: str = "main", build_dir=None) -> Path:
    """The path of library ``name`` in ``build_dir`` (``_build/`` by
    default), compiled first if this source version is not there yet."""
    global BUILD_SECONDS
    spec = LIBRARIES[name]()
    path = library_path(name, build_dir)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs = [path.parent / f"{u.name}.{tag}.o" for u in spec.units]
    procs = [subprocess.Popen(
        [_nvcc(), *FLAGS, *u.flags, "-c", str(u.source), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for u, obj in zip(spec.units, objs)]
    outs = [p.communicate()[0] for p in procs]
    status = {u.name: "ok" if p.returncode == 0 else out
              for u, p, out in zip(spec.units, procs, outs)}
    required_ok = all(p.returncode == 0 or u.optional
                      for u, p in zip(spec.units, procs))
    link = None
    if required_ok:
        link = subprocess.run(
            [_nvcc(), *ARCH, "-shared", "-o", str(path.with_suffix(f".{tag}")),
             *(str(o) for o, p in zip(objs, procs) if p.returncode == 0)],
            capture_output=True, text=True)
        outs.append(link.stdout + link.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
    path.with_suffix(".log").write_text("".join(outs))
    if link is None or link.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + "".join(outs))
    path.with_suffix(".units.json").write_text(json.dumps(status))
    # atomic: a concurrent loader sees all or none
    os.replace(path.with_suffix(f".{tag}"), path)
    if name == "main" and build_dir is None:
        BUILD_SECONDS = time.perf_counter() - t0
    return path


def load(name: str = "main") -> ctypes.CDLL:
    """Library ``name``, built first if needed, with the argument types of
    the entry points of every unit that compiled."""
    path = build(name)
    status = unit_status(name)
    so = ctypes.CDLL(str(path))
    for u in LIBRARIES[name]().units:
        if status.get(u.name, "ok") != "ok":
            continue
        for fn_name, argtypes in u.entry_points.items():
            fn = getattr(so, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return so


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library of the build path."""
    return load("main")


@functools.cache
def probe_lib() -> ctypes.CDLL:
    """The loaded probe library (csrc/probes)."""
    return load("probes")


def check(rc: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
