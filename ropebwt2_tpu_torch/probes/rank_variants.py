"""The rank kernels measured by parts (csrc/probes/rank_variants.cu), to
find what bounds them: issue slots, latency or bytes.  The earlier
design as timed variants, and csrc/rank.cu's kernels by parts.
``python3 chip_smoke.py --rank-variants`` times them on the card beside
csrc/rank.cu's kernels, on request; no build path runs them.

- ``flat(mode, ...)``: the earlier flat rank, 8 threads a query, int32 or
  int64 tables, at pos - sub plus extra (its deferred rank's second
  launch).  Mode 0 is the kernel as it was (a runtime 64-bit floor
  division by K in every thread); mode 1 takes K = 128 as a constant
  (shifts in place of the division); mode 2 is mode 1 without the count
  (loads, index arithmetic, the group sum and the stores: its answers
  are no rank).
- ``pend(...)``: the earlier pending rank, one lower bound over all of vp
  a thread.
- ``part_flat(...)``: csrc/rank.cu's flat kernel's loads without the
  count (K = 128, int32 tables; no rank).
- ``part_pend(count, ...)``: csrc/rank.cu's pending kernel's search
  alone (count False: p, no counts) or its count alone from a given p.

Modes 0 and 1, ``pend`` and the count alone return what their plain
versions return (index/rank.py::rank_global,
index/pending.py::pending_rank), and ``chip_smoke.py --rank-variants``
holds them to those before it times them.  On CPU tensors each runs its
plain version (mode 2 and the parts included); on CUDA tensors it
launches its kernel, or raises.
"""

import torch

from .. import _build
from ..alphabet import NSYM

MODES = (0, 1, 2)
LAUNCHES = dict.fromkeys(("rankvar_flat", "rankvar_pend", "rankpart_flat",
                         "rankpart_pend"), 0)  # eager launches


def flat(mode: int, bwt, blk_prefix, pos, K: int, sub=None, extra=None):
    """The earlier flat rank kernel in ``mode`` (see the module docstring)
    at pos - sub, plus extra, in blk_prefix's dtype."""
    if bwt.device.type == "cpu":
        from ..index.rank import rank_global
        from ..index.rank_cuda import shifted

        return shifted(lambda p: rank_global(bwt, blk_prefix, p, K), pos,
                       sub, extra)
    if mode not in MODES or (mode and K != 128):
        raise ValueError(f"rankvar_flat: mode {mode} at K {K}")
    if blk_prefix.dtype not in (torch.int32, torch.int64) \
            or bwt.data_ptr() % 16 or bwt.shape[0] % K \
            or pos.dtype != torch.int64:
        raise ValueError("rankvar_flat: an aligned int8 buffer of whole "
                         "K-rows, int32 or int64 tables and int64 positions")
    pos = pos.contiguous()
    q = pos.shape[0]
    out = torch.empty((q, NSYM), dtype=blk_prefix.dtype, device=bwt.device)
    _launch("rankvar_flat", bwt.device, q,
            _build.probe_lib().rb2_rankvar_flat, mode, bwt.data_ptr(),
            blk_prefix.data_ptr(), pos.data_ptr(), _ptr(sub), _ptr(extra),
            out.data_ptr(), q, K, blk_prefix.shape[0], bwt.shape[0] // K,
            int(blk_prefix.dtype == torch.int64))
    return out


def pend(pi, g):
    """(p, occ) of the earlier pending rank kernel at ``g``."""
    if pi.vp.device.type == "cpu":
        from ..index.pending import pending_rank

        return pending_rank(pi, g)
    g = g.contiguous()
    q = g.shape[0]
    p = torch.empty(q, dtype=torch.int64, device=g.device)
    occ = torch.empty((q, NSYM), dtype=torch.int32, device=g.device)
    _launch("rankvar_pend", g.device, q,
            _build.probe_lib().rb2_rankvar_pend, pi.vp.data_ptr(),
            pi.psym.data_ptr(), pi.blk_prefix.data_ptr(), g.data_ptr(),
            p.data_ptr(), occ.data_ptr(), q, pi.vp.shape[0])
    return p, occ


def part_flat(bwt, blk_prefix, pos):
    """int32[Q, 6]: csrc/rank.cu's flat kernel's loads without the count
    at K = 128 (no rank)."""
    if bwt.device.type == "cpu":
        from ..index.rank import rank_global

        return rank_global(bwt, blk_prefix, pos, 128)
    if blk_prefix.dtype != torch.int32 or bwt.data_ptr() % 16 \
            or bwt.shape[0] % 128 or pos.dtype != torch.int64:
        raise ValueError("rankpart_flat: an aligned int8 buffer of whole "
                         "128-rows, int32 tables and int64 positions")
    pos = pos.contiguous()
    q = pos.shape[0]
    out = torch.empty((q, NSYM), dtype=torch.int32, device=bwt.device)
    _launch("rankpart_flat", bwt.device, q,
            _build.probe_lib().rb2_rankpart_flat, bwt.data_ptr(),
            blk_prefix.data_ptr(), pos.data_ptr(), out.data_ptr(), q,
            blk_prefix.shape[0], bwt.shape[0] // 128)
    return out


def part_pend(count: bool, pi, g, p=None):
    """(p, occ): csrc/rank.cu's pending kernel's search alone (``count``
    False: occ is not written) or its count alone from the answers ``p``
    it is given (returned as given)."""
    if pi.vp.device.type == "cpu":
        from ..index.pending import pending_rank

        return pending_rank(pi, g)
    g = g.contiguous()
    q = g.shape[0]
    p = torch.empty(q, dtype=torch.int64, device=g.device) if p is None \
        else p.contiguous()
    occ = torch.empty((q, NSYM), dtype=torch.int32, device=g.device)
    _launch("rankpart_pend", g.device, q,
            _build.probe_lib().rb2_rankpart_pend, int(count),
            pi.vp.data_ptr(), pi.psym.data_ptr(), pi.blk_prefix.data_ptr(),
            g.data_ptr(), p.data_ptr(), occ.data_ptr(), q, pi.vp.shape[0])
    return p, occ


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, device, q, fn, *args):
    if q == 0:
        return
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(rc, f"rb2_{name}")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1


def sass_counts(lib_path) -> dict:
    """{kernel name with its mangled template arguments: SASS instructions
    in its body} of every rank kernel (rank_* and rankvar_*) of a built
    library, by ``cuobjdump -sass``
    ({} where the toolkit has no cuobjdump).  Straight-line kernels
    (K = 128) issue about this many instructions a warp; a loop's body
    counts once."""
    import re
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"(rank(?:var)?_[a-z]+_kernel)(I\w*?E)?(?=E|Ev)",
                          m.group(1))
            name = (k.group(1) + (k.group(2) or "")) if k else None
            if name:
                out[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            out[name] += 1
    return out


def issue_floor_ms(instructions: int, warps: int, sms: int,
                   clock_mhz: float) -> float:
    """The least time, in ms, for ``warps`` warps to issue
    ``instructions`` each at one instruction a cycle per scheduler (four
    schedulers an SM)."""
    return instructions * warps / (sms * 4 * clock_mhz * 1e6) * 1e3
