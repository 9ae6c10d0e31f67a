"""G: the Hopper features a redesign of kernels A, B or C would use.

Counterpart of scripts/probe_kfeat_tpu.py::try_kernel, which compiled and
ran one tiny Pallas kernel per Mosaic feature (int8 select, unaligned
dynamic sublane slice, dynamic and int8 roll) and printed ``OK exact=...``
or ``FAIL <error head>``.  Here each feature is one section of
csrc/probes/features.cu, compiled as a unit of its own (_build.py), so a
feature the toolchain refuses is reported and the others still run:

- ``tma``: a 1-D TMA bulk copy of a 4096-byte window whose start is not
  16-byte aligned (the aligned superset, shifted in shared memory);
- ``cp_async``: the same superset by cp.async 16-byte copies;
- ``nibble``: a 4096-symbol window at any symbol offset unpacked from
  index/packed.py's nibble planes, and packed back;
- ``simd_count``: per-128 counts of the 6 symbols by __vcmpeq4 + __popc;
- ``cluster``: a 2-CTA cluster reading its neighbour's shared memory;
- ``dynsmem``: dynamic shared memory above 48 KB.

Beside them, one timing: windows staged at kernel A's flush shape by byte
loads (``stage_bytes``, as merge.cu stages them), by 16-byte loads of the
aligned superset (``stage_vec16``), by cp.async and by TMA.

    python -m ropebwt2_tpu_torch.probes.kernel_features
"""

import sys

import numpy as np
import torch

from . import _timing
from .. import _build
from ..index.merge_cuda import BS, LANE
from ..index.flat import PAD
from ..index.packed import pack_bwt, unpack_bwt

DYN_BYTES = 224 << 10  # dynamic shared memory a CTA asks for (> 48 KB)
FEATURES = ("tma", "cp_async", "nibble", "simd_count", "cluster", "dynsmem")
WINDOW_KERNELS = ("stage_bytes", "stage_vec16", "tma", "cp_async")
KERNELS = ("stage_bytes", "stage_vec16") + FEATURES
LAUNCHES = dict.fromkeys(KERNELS, 0)  # launches by this process (captures
#                                       into a CUDA graph not)
_ENTRY = {"stage_bytes": "rb2_stage_bytes", "stage_vec16": "rb2_stage_vec16",
          "tma": "rb2_feat_tma", "cp_async": "rb2_feat_cp_async",
          "nibble": "rb2_feat_nibble", "simd_count": "rb2_feat_simd_count",
          "cluster": "rb2_feat_cluster", "dynsmem": "rb2_feat_dynsmem"}


# ------------------------------------------------------------ plain versions

def windows_plain(old, o0):
    """int8[nwin, BS]: old[o0[w] : o0[w] + BS], PAD past the buffer."""
    q = o0[:, None] + torch.arange(BS, device=old.device)
    return torch.where(q < old.shape[0], old[q.clamp(max=old.shape[0] - 1)],
                       PAD)


def nibble_plain(packed, o0):
    """(int8[nwin, BS] windows of the unpacked symbols at o0, uint8[nwin,
    BS / 2] each window packed as 16 packed rows)."""
    win = windows_plain(unpack_bwt(packed), o0)
    return win, pack_bwt(win.reshape(-1)).view(win.shape[0], BS // 2)


def simd_count_plain(sym):
    """int32[len / 128, 6]: the one-hot count of every 128 symbols."""
    one_hot = sym.view(-1, LANE, 1) == torch.arange(6, device=sym.device,
                                                    dtype=sym.dtype)
    return one_hot.sum(dim=1, dtype=torch.int32)


def cluster_plain(x):
    """Every pair of 4096-byte chunks swapped."""
    return x.view(-1, 2, BS).flip(1).reshape(-1)


def dynsmem_plain(x, nbytes=DYN_BYTES):
    """Every chunk of nbytes reversed."""
    return x.view(-1, nbytes).flip(1).reshape(-1)


# ---------------------------------------------------------------- wrappers

def run(name: str, *args):
    """Run feature kernel ``name`` (or a staging kernel) on CUDA tensors,
    its plain version on CPU tensors.  Window kernels take (old, o0),
    nibble (packed, o0), with windows at any o0 >= 0 (PAD past the
    buffer); simd_count takes (sym), cluster and dynsmem (x)."""
    x = args[0]
    if x.device.type == "cpu":
        return _plain(name, *args)
    if not all(a.is_cuda and a.is_contiguous() for a in args):
        raise ValueError(f"{name}: inputs must be contiguous on the card")
    fn = getattr(_build.probe_lib(), _ENTRY[name])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if name in WINDOW_KERNELS or name == "nibble":
        o0 = args[1]
        nwin = o0.shape[0]
        size = x.shape[0] * (2 if name == "nibble" else 1)  # in symbols
        if size % 16 or o0.dtype != torch.int64:
            raise ValueError(f"{name}: the buffer must hold a multiple of 16 "
                             "symbols and o0 must be int64")
        if name == "nibble":
            out = torch.empty((nwin, BS), dtype=torch.int8, device=x.device)
            rep = torch.empty((nwin, BS // 2), dtype=torch.uint8,
                              device=x.device)
            rc = fn(x.data_ptr(), o0.data_ptr(), out.data_ptr(),
                    rep.data_ptr(), nwin, size, stream)
            out = (out, rep)
        else:
            out = torch.empty((nwin, BS), dtype=torch.int8, device=x.device)
            rc = fn(x.data_ptr(), o0.data_ptr(), out.data_ptr(), nwin, size,
                    stream)
    elif name == "simd_count":
        if x.numel() % BS:
            raise ValueError("simd_count: the symbols must fill 4096-blocks")
        out = torch.empty((x.numel() // LANE, 6), dtype=torch.int32,
                          device=x.device)
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel() // LANE, stream)
    elif name == "cluster":
        if x.numel() % (2 * BS):
            raise ValueError("cluster: the input must fill pairs of chunks")
        out = torch.empty_like(x)
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel() // BS, stream)
    else:
        if x.numel() % DYN_BYTES:
            raise ValueError("dynsmem: the input must fill whole chunks")
        out = torch.empty_like(x)
        rc = fn(x.data_ptr(), out.data_ptr(), DYN_BYTES,
                x.numel() // DYN_BYTES, stream)
    _build.check(rc, _ENTRY[name])
    if not torch.cuda.is_current_stream_capturing():  # a capture launches none
        LAUNCHES[name] += 1
    return out


def _plain(name, *args):
    if name in WINDOW_KERNELS:
        return windows_plain(*args)
    return {"nibble": nibble_plain, "simd_count": simd_count_plain,
            "cluster": cluster_plain, "dynsmem": dynsmem_plain}[name](*args)


# ------------------------------------------------------------------ inputs

def window_starts(nwin: int, m: int, seed: int):
    """int64[nwin] starts b * BS - start[b] of kernel A's old windows for m
    random insertions into nwin CTAs (numpy-seeded)."""
    rng = np.random.default_rng(seed)
    per_cta = np.bincount(rng.integers(0, nwin * BS, m) // BS,
                          minlength=nwin)
    start = np.concatenate([[0], np.cumsum(per_cta)[:-1]])
    return np.maximum(np.arange(nwin, dtype=np.int64) * BS - start, 0)


def inputs(name: str, scale: str, device, seed: int = 0):
    """Arguments of kernel ``name``: scale "tiny" for the OK/FAIL probe,
    "timing" for the timed shape (kernel A's flush shape for the window
    kernels and simd_count).  Seeded; drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tiny = scale == "tiny"

    def draw(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=device,
                             dtype=torch.int8)

    if name in WINDOW_KERNELS or name == "nibble":
        nwin = 8 if tiny else (1 << 16 if name == "nibble"
                               else -(-(_timing.CAP_FLUSH + 2048) // BS))
        o0 = window_starts(nwin, 40 if tiny else _timing.M_FLUSH, seed)
        o0[0] = 129  # off 16-byte alignment, and in a high nibble plane
        if tiny:  # a window that runs past the buffer's end: PAD there
            o0[-1] = nwin * BS + 2 * BS - 1000
        o0 = torch.from_numpy(o0).to(device)
        if name == "nibble":
            return [pack_bwt(draw(0, 7, nwin * BS + 2 * BS)), o0]
        return [draw(0, 6, nwin * BS + 2 * BS), o0]
    if name == "simd_count":
        return [draw(0, 7, 2 * BS if tiny
                     else -(-(_timing.CAP_FLUSH + 2048) // BS) * BS)]
    if name == "cluster":
        return [draw(-128, 127, 4 * BS if tiny else 1 << 24)]
    return [draw(-128, 127, (2 if tiny else 264) * DYN_BYTES)]


def nbytes(name: str, args) -> int:
    """The byte model of one call: inputs read once, outputs written
    once."""
    x = args[0]
    if name in WINDOW_KERNELS:
        return _timing.windows_bytes(args[1].shape[0])
    if name == "nibble":  # BS/2 packed in, BS unpacked and BS/2 packed out
        return args[1].shape[0] * (2 * BS + 8)
    if name == "simd_count":
        return x.numel() + x.numel() // LANE * 24
    return 2 * x.numel()


def library_call(name: str):
    """The one PyTorch call that computes the same function, where there
    is one (timed as a yardstick only), else None."""
    if name == "cluster":
        return lambda x: torch.flip(x.view(-1, 2, BS), [1])
    if name == "dynsmem":
        return lambda x: torch.flip(x.view(-1, DYN_BYTES), [1])
    return None


# ------------------------------------------------------------------- probe

def _err(got, want):
    if isinstance(got, tuple):
        return max(_err(g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max())


def compiled(name: str):
    """None if kernel ``name`` compiled, else the head of its error."""
    _build.probe_lib()
    unit = "features_0" if name.startswith("stage_") else \
        f"features_{FEATURES.index(name) + 1}"
    status = _build.unit_status("probes").get(unit, "ok")
    if status == "ok":
        return None
    lines = [ln for ln in status.splitlines() if "error" in ln] or \
        status.splitlines()
    return " | ".join(lines)[:300]


def check(say=print, device="cuda"):
    """Every kernel that compiled, on tiny inputs, against its plain
    version: {name: max_abs_err, or the error head of one that did not
    compile}.  Prints OK exact=... or FAIL <error head> per feature."""
    res = {}
    for name in KERNELS:
        head = compiled(name)
        if head is not None:
            res[name] = head
            say(f"G {name}: FAIL {head}")
            continue
        args = inputs(name, "tiny", device, seed=1)
        got = run(name, *args)
        torch.cuda.synchronize()
        res[name] = _err(got, _plain(name, *args))
        say(f"G {name}: OK exact={res[name] == 0} (max_abs_err {res[name]})")
    return res


def measure(say=print, device="cuda", names=KERNELS):
    """Every kernel that compiled at its timing shape: held against its
    plain version there, then timed beside it, its bound and the library
    call where there is one.  Returns {name: {...}} with the max_abs_err
    at that shape under "err"."""
    out = {}
    for name in names:
        if compiled(name) is not None:
            continue
        args = inputs(name, "timing", device, seed=2)
        err = _err(run(name, *args), _plain(name, *args))
        ms = _timing.graph_ms(lambda: run(name, *args))
        plain = _timing.event_ms(lambda: _plain(name, *args), iters=2)
        lib = library_call(name)
        lib_ms = _timing.graph_ms(lambda: lib(*args)) if lib else None
        bound = _timing.bound_ms(nbytes(name, args))
        out[name] = {"err": err, "ms": ms, "plain_ms": plain,
                     "library_ms": lib_ms, "bound_ms": bound,
                     "share": _timing.share(bound, ms)}
        say(f"G {name} timed: max_abs_err {err} (tolerance 0), {ms:.4f} ms, "
            f"bound {bound:.4f} ms (share {out[name]['share']:.3f}), plain "
            f"{plain:.4f} ms, library "
            + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none"))
        del args
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not _timing.require_card("kernel_features"):
        return 1
    res = check()
    timed = measure()
    return 0 if all(v == 0 for v in res.values() if isinstance(v, int)) \
        and all(r["err"] == 0 for r in timed.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
