"""Build and ctypes bindings of the native host runtime (src/host.cpp, a
copy of the JAX package's): the streaming gzip FASTA/FASTQ reader with the
read preprocessing, and the text, FMD, FMR and CRLF writers.

The shared library is compiled with g++ at first use (never at import)
into the package's ``_build/`` directory, named by a hash of the source
and the command, so it is built once per source version.  If it cannot be
built, the compiler's error is logged and kept in ``BUILD_ERROR``, and
``get_lib()`` returns None: callers then take the pure-Python paths, which
are the plain versions of the same reader and writers.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils import log

SRC = Path(__file__).resolve().parent / "src" / "host.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"
CMD = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]
LIBS = ["-lz"]
_lock = threading.Lock()
_lib = None
_tried = False
BUILD_ERROR = None  # the compiler's output when the build failed


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CMD + LIBS).encode() + SRC.read_bytes())
    return BUILD / f"librb2host_{h.hexdigest()[:16]}.so"


def _build(path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([*CMD, "-o", str(tmp), str(SRC), *LIBS],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(r.args)}\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or none


def get_lib():
    """The loaded CDLL, built first if needed; None if it cannot be built
    (the error is logged once and kept in BUILD_ERROR)."""
    global _lib, _tried, BUILD_ERROR
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError) as e:
            BUILD_ERROR = str(e)
            log.error("native", "the host runtime did not build: %s", e)
            return None
        c = ctypes
        i64, u64, p8, pi8, pi64, pu64 = (
            c.c_int64,
            c.c_uint64,
            c.POINTER(c.c_uint8),
            c.POINTER(c.c_int8),
            c.POINTER(c.c_int64),
            c.POINTER(c.c_uint64),
        )
        lib.rb2_open.restype = c.c_void_p
        lib.rb2_open.argtypes = [c.c_char_p, c.c_int]
        lib.rb2_close.argtypes = [c.c_void_p]
        lib.rb2_next_batch.restype = i64
        lib.rb2_next_batch.argtypes = [
            c.c_void_p, p8, i64, i64,
            c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        ]
        lib.rb2_fmd_write.restype = c.c_int
        lib.rb2_fmd_write.argtypes = [p8, pi64, i64, c.c_char_p, pu64]
        lib.rb2_fmr_write.restype = c.c_int
        lib.rb2_fmr_write.argtypes = [
            p8, pi64, pi64, c.c_int, c.c_char_p, c.c_int, c.c_int,
        ]
        lib.rb2_crlf_write.restype = c.c_int
        lib.rb2_crlf_write.argtypes = [p8, pi64, i64, pi64, c.c_char_p]
        lib.rb2_text_write.restype = c.c_int
        lib.rb2_text_write.argtypes = [pi8, i64, c.c_char_p]
        lib.rb2_fmd_decode.restype = i64
        lib.rb2_fmd_decode.argtypes = [p8, i64, p8, pi64, i64]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _p8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _pi8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _pi64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def fmd_decode(path):
    """Native bulk decode of an FMD file: (sym uint8[], len int64[]) run
    arrays, adjacent equal runs merged — the memory-bandwidth restore path
    (counterpart of rld_restore_mmap + rld_dec, rld0.c:308-327).  Returns
    None if the native library is unavailable; raises on a corrupt file."""
    lib = get_lib()
    if lib is None:
        return None
    data = np.memmap(path, dtype=np.uint8, mode="r")
    n_bytes = int(np.frombuffer(data[16:24].tobytes(), np.uint64)[0]) \
        if data.shape[0] >= 24 else 0
    # a run costs >= 4 bits in the delta stream; 1/byte covers all but
    # adversarial streams — the decoder returns the true total, so a
    # short guess costs exactly one retry at the exact size
    cap = max(n_bytes + 16, 1 << 12)
    for _ in range(2):
        sym = np.empty(cap, np.uint8)
        ln = np.empty(cap, np.int64)
        nr = lib.rb2_fmd_decode(
            _p8(data), data.shape[0], _p8(sym), _pi64(ln), cap
        )
        if nr == -2:
            raise ValueError(f"{path}: not an FMD file")
        if nr <= cap:
            return sym[:nr].copy(), ln[:nr].copy()
        cap = nr
    raise RuntimeError("unreachable")


class NativeReader:
    """Streaming preprocessed-batch reader (gz fasta/fastq/line)."""

    def __init__(self, path, line_mode=False):
        lib = get_lib()
        self._lib = lib
        p = None if path in (None, "-") else path.encode()
        self._h = lib.rb2_open(p, 1 if line_mode else 0)
        if not self._h:
            raise OSError(f"cannot open {path!r}")

    def next_batch(
        self,
        min_fill,
        *,
        min_q=0,
        skip_n=False,
        cut_n=False,
        min_cut_len=0,
        trim_pal=False,
        fwd=True,
        rev=True,
        slack=1 << 26,
    ):
        """Returns a uint8 array of NUL-terminated insertion-oriented
        strings, or None at EOF."""
        cap = min_fill + slack
        buf = np.empty(cap, dtype=np.uint8)
        while True:
            got = self._lib.rb2_next_batch(
                self._h, _p8(buf), cap, min_fill,
                min_q, int(skip_n), int(cut_n), min_cut_len,
                int(trim_pal), int(fwd), int(rev),
            )
            if got == -1:  # single record larger than slack: grow
                cap *= 4
                buf = np.empty(cap, dtype=np.uint8)
                continue
            break
        if got == 0:
            return None
        return buf[:got]

    def close(self):
        if self._h:
            self._lib.rb2_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def fmd_write(sym, ln, path):
    lib = get_lib()
    sym = np.ascontiguousarray(sym, dtype=np.uint8)
    ln = np.ascontiguousarray(ln, dtype=np.int64)
    mcnt = np.zeros(7, dtype=np.uint64)
    ret = lib.rb2_fmd_write(
        _p8(sym), _pi64(ln), len(sym),
        path.encode() if path else None,
        mcnt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if ret != 0:
        raise OSError(f"fmd write failed: {path}")
    return mcnt


def fmr_write(sym, ln, part_runs, so, path, block_len=512, max_nodes=64):
    lib = get_lib()
    sym = np.ascontiguousarray(sym, dtype=np.uint8)
    ln = np.ascontiguousarray(ln, dtype=np.int64)
    pr = np.ascontiguousarray(part_runs, dtype=np.int64)
    ret = lib.rb2_fmr_write(
        _p8(sym), _pi64(ln), _pi64(pr), so,
        path.encode() if path else None, block_len, max_nodes,
    )
    if ret != 0:
        raise OSError(f"fmr write failed: {path}")


def crlf_write(sym, ln, counts, path):
    lib = get_lib()
    sym = np.ascontiguousarray(sym, dtype=np.uint8)
    ln = np.ascontiguousarray(ln, dtype=np.int64)
    cnt = np.ascontiguousarray(counts, dtype=np.int64)
    ret = lib.rb2_crlf_write(
        _p8(sym), _pi64(ln), len(sym), _pi64(cnt),
        path.encode() if path else None,
    )
    if ret != 0:
        raise OSError(f"crlf write failed: {path}")


def text_write(bwt, path):
    lib = get_lib()
    bwt = np.ascontiguousarray(bwt, dtype=np.int8)
    ret = lib.rb2_text_write(_pi8(bwt), len(bwt), path.encode() if path else None)
    if ret != 0:
        raise OSError(f"text write failed: {path}")
