"""Kernel B: the pending-index merge (csrc/pending.cu), which replaces the
JAX package's Pallas kernel
ropebwt2_tpu/index/pending_pallas.py::pending_merge_pallas.

``merge`` takes one round's new rows, already placed at their merged
slots (varr, sarr), and moves the old rows around them.  On CPU tensors
it runs the plain version (pending.merge_rows); on CUDA tensors it
launches the kernel, or raises.

Where the JAX package returns new arrays, ``merge`` WRITES INTO the output
planes it is given: only the rows of the 4096-row blocks that can hold
live rows (a host-known bound), nothing past them.  The caller keeps
INF/PAD past the live rows of those planes (pending.py keeps two plane
pairs and uses them in turn), so the kernel never rewrites the empty tail
of the pending capacity."""

import torch

from .. import _build
from ..utils import launches

BS = 4096  # pending rows per CTA (csrc/common.cuh)
LANE = 128  # rows per count row (pending.KP)
LAUNCHES = 0  # kernel launches by this process (utils/launches.py)


def n_blocks(pcap: int, bound=None) -> int:
    """The BS-row blocks that a merge writes: those that can hold a live
    row when at most ``bound`` rows are live (None: the whole capacity)."""
    nb = -(-pcap // BS)
    return nb if bound is None else min(nb, -(-max(bound, 0) // BS))


def fresh_planes(pcap: int, device):
    """An empty (vp, psym) plane pair: INF/PAD in every row."""
    from .flat import PAD
    from .pending import INF

    return (torch.full((pcap,), INF, dtype=torch.int64, device=device),
            torch.full((pcap,), PAD, dtype=torch.int8, device=device))


def merge(vp, psym, varr, sarr, start_new, p_after, out=None, bound=None):
    """(vp, psym, row_counts) of the merged pending planes.

    vp/varr: int64[pcap]; psym/sarr: int8[pcap], with sarr = sym + 1 at the
    new rows' slots and 0 elsewhere (varr is read at those slots only);
    start_new: int64[ceil(pcap/BS) + 1], the exclusive prefix of new rows
    per BS-row block; p_after: int64 0-dim live count after the merge.

    ``out``: the (vp, psym) planes to write into, not the input planes;
    None takes fresh planes of INF/PAD.  ``bound``: a host-known upper
    bound of p_after (None: pcap).  Rows below n_blocks(pcap, bound) * BS
    of the out planes are written (INF/PAD at or past p_after); the rows
    past them are left as they are, so they come out INF/PAD only if they
    held INF/PAD.  The out planes are returned.  row_counts is
    int32[pcap // 128, 6], zero past the written blocks."""
    from .pending import merge_rows

    pcap = vp.shape[0]
    if out is None:
        out = fresh_planes(pcap, vp.device)
    if vp.device.type == "cpu":
        return merge_rows(vp, psym, varr, sarr, start_new, p_after, out,
                          bound)
    nb = -(-pcap // BS)
    ncta = n_blocks(pcap, bound)
    _check(vp, psym, varr, sarr, start_new, p_after, out, nb)
    # zeros, not empty: the count rows past the launched CTAs must read 0
    rows = torch.zeros((nb * (BS // LANE), 6), dtype=torch.int32,
                       device=vp.device)
    run_kernel(vp, psym, varr, sarr, start_new, p_after, out[0], out[1],
               rows, ncta)
    return out[0], out[1], rows[: pcap // LANE]


def run_kernel(vp, psym, varr, sarr, start_new, p_after, vp_out, psym_out,
               rows, ncta: int):
    """Kernel B alone: ``ncta`` CTAs write rows [0, ncta * BS) of the output
    planes and count rows [0, ncta * 32) of ``rows``.  The arguments are
    ``merge``'s, checked there."""
    from .pending import INF

    if ncta == 0:
        return
    rc = _build.lib().rb2_pending_merge(
        vp.data_ptr(), psym.data_ptr(), varr.data_ptr(), sarr.data_ptr(),
        start_new.data_ptr(), p_after.data_ptr(), vp_out.data_ptr(),
        psym_out.data_ptr(), rows.data_ptr(), vp.shape[0], ncta, INF,
        torch.cuda.current_stream(vp.device).cuda_stream,
    )
    _build.check(rc, "rb2_pending_merge")
    launches.launched(globals())


def _check(vp, psym, varr, sarr, start_new, p_after, out, nb):
    if not vp.is_cuda:
        raise ValueError(f"pending merge: unsupported device {vp.device}")
    pcap = vp.shape[0]
    if pcap % LANE:
        raise ValueError(f"pending merge: capacity {pcap} is not a multiple "
                         f"of {LANE}")
    for name, t, dt, shape in (
        ("vp", vp, torch.int64, (pcap,)), ("psym", psym, torch.int8, (pcap,)),
        ("varr", varr, torch.int64, (pcap,)),
        ("sarr", sarr, torch.int8, (pcap,)),
        ("start_new", start_new, torch.int64, (nb + 1,)),
        ("p_after", p_after, torch.int64, ()),
        ("out vp", out[0], torch.int64, (pcap,)),
        ("out psym", out[1], torch.int8, (pcap,)),
    ):
        if (t.device != vp.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"pending merge: {name} must be a contiguous "
                             f"{dt}{list(shape)} on {vp.device}")
    for name, t in (("psym", psym), ("sarr", sarr), ("out psym", out[1])):
        if t.data_ptr() % 16:
            raise ValueError(f"pending merge: {name} must be 16-byte aligned")
    if out[0].data_ptr() == vp.data_ptr() or \
            out[1].data_ptr() == psym.data_ptr():
        raise ValueError("pending merge: the out planes are the input planes")
