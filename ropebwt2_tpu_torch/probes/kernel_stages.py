"""E: kernel A's stages alone, each looped on its CTA's data.

Counterpart of scripts/probe_kernel_stages.py::mk, which looped the TPU
merge kernel's stages (stack+align, segprefix, expand, counts) ITERS =
3000 times on VMEM-resident data.  Here each stage of csrc/merge.cu is a
kernel of csrc/probes/stages.cu that loops it ITERS times (the script's
accumulator trick keeps every pass alive):

- ``window``: staging the old window in shared memory (merge.cu:59-63);
- ``scan``: the insertion flags and block_exclusive_scan (merge.cu:65-73);
- ``gather``: the gather and the 16-byte store (merge.cu:75-90);
- ``counts``: the symbol compares and write_row_counts (merge.cu:88-91).

Each runs for one CTA (latency) and for a full grid of 8 CTAs per SM
(throughput); the time per pass of the full grid over its CTAs, set
against kernel A's time per CTA from probes/kernel_scaling.py, is the
stage's share of kernel A.  The last pass of every launch is written and
held against the stage's plain version here.

    python -m ropebwt2_tpu_torch.probes.kernel_stages
"""

import sys

import numpy as np
import torch

from . import _timing
from .. import _build
from ..index.flat import PAD
from ..index.merge_cuda import BS, LANE

THREADS, PER = 256, 16  # threads per CTA, outputs per thread (common.cuh)
ITERS = 3000  # the script's
STAGES = ("window", "scan", "gather", "counts")
LAUNCHES = dict.fromkeys(STAGES, 0)  # kernel launches by this process
INS_RATE = 0.01  # the script's insertion density


# ------------------------------------------------------------ plain versions

def window_plain(old, o0):
    """int8[g, BS]: old[o0[b] : o0[b] + BS] for every CTA b, PAD past the
    allocation."""
    alloc = old.shape[0]
    q = o0[:, None] + torch.arange(BS, device=old.device)
    return torch.where(q < alloc, old[q.clamp(max=alloc - 1)], PAD)


def scan_plain(insmap, g: int):
    """int32[g, BS]: the inclusive prefix of the insertion flags within
    every CTA."""
    return torch.cumsum((insmap[: g * BS] != 0).view(g, BS), 1,
                        dtype=torch.int32)


def gather_plain(old, o0, insmap):
    """int8[g, BS]: kernel A's output of every CTA, insmap - 1 where it
    marks an insertion, else the window's symbol p - c(p)."""
    win = window_plain(old, o0)
    g = win.shape[0]
    ins = insmap[: g * BS].view(g, BS)
    src = torch.arange(BS, device=old.device) - scan_plain(insmap, g)
    return torch.where(ins != 0, ins - 1,
                       win.gather(1, src.clamp(min=0).long()))


def counts_plain(sym):
    """int32[len / 128, 6]: the count of every symbol in every 128."""
    rows = sym.view(-1, LANE, 1) == torch.arange(6, device=sym.device,
                                                 dtype=sym.dtype)
    return rows.sum(dim=1, dtype=torch.int32)


PLAIN = {
    "window": lambda d: window_plain(d["old"], d["o0"]),
    "scan": lambda d: scan_plain(d["insmap"], d["g"]),
    "gather": lambda d: gather_plain(d["old"], d["o0"], d["insmap"]),
    "counts": lambda d: counts_plain(d["sym"]),
}


def make_inputs(g: int, seed: int, device):
    """One CTA's data for each of g CTAs, seeded with numpy: an old buffer
    of symbols, an insertion map at the script's 1% density (plus PER
    bytes of slack for the perturbed loads), each CTA's window start
    b * BS - start[b] as in kernel A, and output symbols with PAD."""
    rng = np.random.default_rng(seed)
    ins = np.zeros(g * BS + PER, np.int8)
    hit = rng.random(g * BS) < INS_RATE
    ins[: g * BS] = hit * (rng.integers(0, 6, g * BS) + 1)
    per_cta = hit.reshape(g, BS).sum(1)
    start = np.concatenate([[0], np.cumsum(per_cta)[:-1]])
    o0 = np.arange(g, dtype=np.int64) * BS - start
    old = rng.integers(0, 6, g * BS + BS).astype(np.int8)
    sym = rng.integers(0, 7, g * BS).astype(np.int8)
    t = {k: torch.from_numpy(v).to(device) for k, v in
         (("old", old), ("o0", o0), ("insmap", ins), ("sym", sym))}
    t["g"] = g
    return t


# ---------------------------------------------------------------- wrappers

def run_stage(stage: str, d: dict, iters: int = ITERS):
    """One launch of a stage over d's CTAs, looping it ``iters`` times;
    returns the last pass's result (the plain version's on CPU tensors)."""
    if d["old"].device.type == "cpu":
        return PLAIN[stage](d)
    g, dev = d["g"], d["old"].device
    for name, t in d.items():
        if name != "g" and (not t.is_cuda or not t.is_contiguous()):
            raise ValueError(f"{stage}: {name} must be contiguous on the card")
    if d["insmap"].shape[0] < g * BS + PER or d["o0"].shape[0] != g:
        raise ValueError(f"{stage}: inputs do not cover {g} CTAs")
    lib = _build.probe_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    acc = torch.empty(g * THREADS, dtype=torch.int32, device=dev)
    alloc = d["old"].shape[0]
    if stage == "window":
        out = torch.empty((g, BS), dtype=torch.int8, device=dev)
        rc = lib.rb2_stage_window(d["old"].data_ptr(), d["o0"].data_ptr(),
                                  out.data_ptr(), acc.data_ptr(), alloc,
                                  iters, g, stream)
    elif stage == "scan":
        out = torch.empty((g, BS), dtype=torch.int32, device=dev)
        rc = lib.rb2_stage_scan(d["insmap"].data_ptr(), out.data_ptr(),
                                acc.data_ptr(), iters, g, stream)
    elif stage == "gather":
        out = torch.empty((3, g, BS), dtype=torch.int8, device=dev)
        rc = lib.rb2_stage_gather(
            d["old"].data_ptr(), d["o0"].data_ptr(), d["insmap"].data_ptr(),
            out.data_ptr(), acc.data_ptr(), alloc, g * BS, iters, g, stream)
        out = out[0]
    else:
        out = torch.empty((3, g * (BS // LANE), 6), dtype=torch.int32,
                          device=dev)
        rc = lib.rb2_stage_counts(d["sym"].data_ptr(), out.data_ptr(),
                                  acc.data_ptr(), g * (BS // LANE), iters, g,
                                  stream)
        out = out[0]
    _build.check(rc, f"rb2_stage_{stage}")
    LAUNCHES[stage] += 1
    return out


# ------------------------------------------------------------------- probe

def full_grid() -> int:
    """CTAs of a full grid: 8 per SM (2048 threads of 256)."""
    return torch.cuda.get_device_properties(0).multi_processor_count * 8


def check(say=print, device="cuda"):
    """Every stage at a full grid against its plain version; returns
    {stage: max_abs_err}."""
    d = make_inputs(full_grid(), 11, device)
    errs = {}
    for stage in STAGES:
        got = run_stage(stage, d)
        torch.cuda.synchronize()
        want = PLAIN[stage](d)
        errs[stage] = int((got.long() - want.long()).abs().max())
        say(f"E {stage}: full grid {d['g']} CTAs x {ITERS} passes, last "
            f"pass max_abs_err {errs[stage]} (tolerance 0)")
    return errs


def measure(say=print, a_cta_us=None, device="cuda"):
    """Time every stage for one CTA and for a full grid; returns {stage:
    {...}} with the full grid's ms per pass, the plain version's ms, the
    bound of one pass (_timing.stage_bound_ms), the HBM time of the
    stage's bytes inside kernel A (a reference, not a bound: the looped
    passes run on data held on the chip) and, given kernel A's us per
    CTA, the stage's share of it."""
    g = full_grid()
    one, grid = make_inputs(1, 12, device), make_inputs(g, 13, device)
    out = {}
    for stage in STAGES:
        t1 = _timing.event_ms(lambda: run_stage(stage, one), iters=3)
        tg = _timing.event_ms(lambda: run_stage(stage, grid), iters=3)
        plain = _timing.event_ms(lambda: PLAIN[stage](grid), iters=3)
        pass_ms = tg / ITERS
        cta_us = pass_ms * 1e3 / g
        bound = _timing.stage_bound_ms(stage, g, ITERS)
        in_a = _timing.bound_ms(_timing.stage_bytes(stage, g))
        rec = {"one_cta_us": t1 / ITERS * 1e3, "pass_ms": pass_ms,
               "cta_us": cta_us, "plain_ms": plain, "bound_ms": bound,
               "hbm_in_a_ms": in_a, "grid": g,
               "of_a": cta_us / a_cta_us if a_cta_us else None}
        out[stage] = rec
        say(f"E {stage}: one CTA {rec['one_cta_us']:.4f} us/pass; full grid "
            f"({g} CTAs) {pass_ms * 1e3:.4f} us/pass = {cta_us * 1e3:.4f} "
            f"ns per CTA; bound {bound * 1e3:.4f} us/pass (share "
            f"{_timing.share(bound, pass_ms):.3f}); HBM time of its bytes in "
            f"kernel A {in_a * 1e3:.4f} us (pass / that "
            f"{pass_ms / in_a:.3f}); plain {plain:.4f} ms"
            + (f"; {100 * rec['of_a']:.1f}% of kernel A's "
               f"{a_cta_us * 1e3:.4f} ns per CTA" if a_cta_us else ""))
    return out


def main() -> int:
    if not _timing.require_card("kernel_stages"):
        return 1
    errs = check()
    measure()
    return 0 if not any(errs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
