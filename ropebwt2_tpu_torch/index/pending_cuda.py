"""Kernel B: the pending-index merge (csrc/pending.cu), which replaces the
JAX package's Pallas kernel
ropebwt2_tpu/index/pending_pallas.py::pending_merge_pallas.

``merge`` takes one round's new rows, already placed at their merged
slots (varr, sarr), and moves the old rows around them.  On CPU tensors
it runs the plain version (pending.merge_rows); on CUDA tensors it
launches the kernel, or raises."""

import torch

from .. import _build

BS = 4096  # pending rows per CTA (csrc/common.cuh)
LANE = 128  # rows per count row (pending.KP)
LAUNCHES = 0  # kernel launches by this process


def merge(vp, psym, varr, sarr, start_new, p_after):
    """(vp, psym, row_counts) of the merged pending planes.

    vp/varr: int64[pcap]; psym/sarr: int8[pcap], with sarr = sym + 1 at the
    new rows' slots and 0 elsewhere; start_new: int64[ceil(pcap/BS) + 1],
    the exclusive prefix of new rows per BS-row block; p_after: int64 0-dim
    live count after the merge.  Rows at or past p_after come out INF/PAD.
    row_counts is int32[pcap // 128, 6]."""
    from .pending import INF, merge_rows

    if vp.device.type == "cpu":
        return merge_rows(vp, psym, varr, sarr, start_new, p_after)
    pcap = vp.shape[0]
    nb = -(-pcap // BS)
    _check(vp, psym, varr, sarr, start_new, p_after, nb)
    global LAUNCHES
    vp_out = torch.empty_like(vp)
    psym_out = torch.empty_like(psym)
    rows = torch.empty((nb * (BS // LANE), 6), dtype=torch.int32,
                       device=vp.device)
    rc = _build.lib().rb2_pending_merge(
        vp.data_ptr(), psym.data_ptr(), varr.data_ptr(), sarr.data_ptr(),
        start_new.data_ptr(), p_after.data_ptr(), vp_out.data_ptr(),
        psym_out.data_ptr(), rows.data_ptr(), pcap, nb, INF,
        torch.cuda.current_stream(vp.device).cuda_stream,
    )
    _build.check(rc, "rb2_pending_merge")
    LAUNCHES += 1
    return vp_out, psym_out, rows[: pcap // LANE]


def _check(vp, psym, varr, sarr, start_new, p_after, nb):
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
    ):
        if (t.device != vp.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"pending merge: {name} must be a contiguous "
                             f"{dt}{list(shape)} on {vp.device}")
