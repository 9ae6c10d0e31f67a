"""H: kernel A's cost per 4096-symbol CTA and per 131,072-symbol
super-block, against its bound.

Counterpart of scripts/probe_kernel_scaling.py::kernel_call, which chained
the TPU merge kernel R in {8, 48} times at cap 2^24 with a live prefix of
nsb in {1, 8, 32, 65, 128} super-blocks and differenced the two chains to
cancel dispatch and fetch costs.  Here kernel A runs alone
(merge_cuda.run_kernel, i.e. rb2_merge) on a prepared insertion map and
block prefix, each call's output the next call's input (the allocator
ping-pongs two buffers), at the same shapes with no insertions, as the
script ran, and at the main path's flush shape (cap 147,062,784, 2^20
insertions, live to the end).

A shape whose working set (old and new live prefix, insertion map) fits
the 50 MB L2 is marked L2-warm: its chain runs out of the cache.  For it
the probe also chains each call behind a 64 MB write that evicts the L2,
times the writes alone, and subtracts them.

    python -m ropebwt2_tpu_torch.probes.kernel_scaling
"""

import sys

import torch

from . import _timing
from ..index.flat import PAD_TAIL
from ..index.merge_cuda import (
    BS, block_prefix, insertion_map, merge_blocks, run_kernel,
)

SUPER = 131_072  # symbols per TPU super-block (merge_pallas.SUPER_B)
CAP = 1 << 24
NSB = (1, 8, 32, 65, 128)
R_LO, R_HI = 8, 48  # the script's chain lengths
EVICT_BYTES = 64 << 20


def cases():
    """(label, cap, live n, insertions)."""
    out = [(f"cap 2^24 nsb {k}", CAP, k * SUPER, 0) for k in NSB]
    cap, m = _timing.CAP_FLUSH, _timing.M_FLUSH
    out.append(("flush", cap, cap - m - 12345, m))
    return out


def prepare(cap: int, n: int, m: int, seed: int, device):
    """(bwt, insmap, start, n): a random buffer, and the insertion map and
    block prefix of m sorted insertions into its live prefix (none for
    m = 0), built by merge_cuda's own steps."""
    gen = torch.Generator(device=device).manual_seed(seed)
    alloc = cap + PAD_TAIL
    nb = -(-alloc // BS)
    bwt = torch.randint(0, 6, (alloc,), generator=gen, device=device,
                        dtype=torch.int8)
    pos = torch.sort(torch.randint(0, n + 1, (m,), generator=gen,
                                   device=device)).values
    sym = torch.randint(0, 6, (m,), generator=gen, device=device)
    dest, insmap = insertion_map(pos, sym, torch.arange(m, device=device),
                                 torch.ones(m, dtype=torch.bool,
                                            device=device), nb)
    start = block_prefix(dest, nb)
    return bwt, insmap, start, torch.tensor(n, device=device)


def check(say=print, device="cuda"):
    """Kernel A at the flush shape against merge_cuda.merge_blocks, its
    plain version at the kernel's interface, on the card: the live CTAs'
    output and every count row.  Returns max_abs_err."""
    _, cap, n, m = cases()[-1]
    bwt, insmap, start, nt = prepare(cap, n, m, 7, device)
    got, grows = run_kernel(bwt, insmap, start, nt)
    want, wrows = merge_blocks(bwt, insmap, start, nt)
    live = min(-(-(n + m) // BS) * BS, bwt.shape[0])
    err = max(int((got[:live].long() - want[:live].long()).abs().max()),
              int((grows - wrows).abs().max()))
    say(f"H kernel A at the flush shape against its plain version: "
        f"max_abs_err {err} (tolerance 0)")
    del got, grows, want, wrows
    torch.cuda.empty_cache()
    return err


def measure(say=print, device="cuda"):
    """Every case: ms per call from the chained difference, per CTA and
    per super-block, GB/s and share of the bound; L2-warm cases also
    with the L2 evicted before every call.  Returns a list of dicts."""
    evict = torch.empty(EVICT_BYTES, dtype=torch.uint8, device=device)
    rows = []
    for label, cap, n, m in cases():
        bwt, insmap, start, nt = prepare(cap, n, m, 1, device)
        live = min(n + m, bwt.shape[0])
        state = [bwt]

        def step(i):
            state[0] = run_kernel(state[0], insmap, start, nt)[0]

        def evicted(i):
            evict.fill_(i & 0xFF)
            step(i)

        per_call, lo, hi = _timing.chain_ms(step, R_LO, R_HI)
        nbytes = _timing.merge_bytes(n, m, bwt.shape[0])
        warm = 2 * live + n <= _timing.L2_BYTES
        rec = _record(label, cap, n, m, live, per_call, nbytes, warm)
        rec.update(t_lo_ms=lo, t_hi_ms=hi)
        rows.append(rec)
        say(_line(rec, f"(R {R_LO}: {lo:.4f} ms, R {R_HI}: {hi:.4f} ms)"))
        if warm:
            with_evict = _timing.chain_ms(evicted, R_LO, R_HI)[0]
            fill = _timing.chain_ms(lambda i: evict.fill_(i & 0xFF),
                                    R_LO, R_HI)[0]
            cold = _record(label + " L2 evicted", cap, n, m, live,
                           with_evict - fill, nbytes, False)
            cold["evict_ms"] = fill
            rows.append(cold)
            say(_line(cold, f"({EVICT_BYTES >> 20} MB write {fill:.4f} ms "
                            f"subtracted)"))
        del bwt, insmap, start, state
        torch.cuda.empty_cache()
    return rows


def _record(label, cap, n, m, live, per_call, nbytes, warm):
    ctas = -(-live // BS)
    bound = _timing.bound_ms(nbytes)
    return {"label": label, "cap": cap, "n": n, "ins": m, "ctas": ctas,
            "ms": per_call, "cta_us": per_call * 1e3 / ctas,
            "sb_us": per_call * 1e3 / (live / SUPER), "bytes": nbytes,
            "gbs": nbytes / (per_call * 1e-3) / 1e9 if per_call > 0 else 0.0,
            "bound_ms": bound, "share": _timing.share(bound, per_call),
            "l2_warm": warm}


def _line(r, extra):
    return (f"H {r['label']}: cap {r['cap']} n {r['n']} ins {r['ins']} "
            f"{r['ctas']} live CTAs: {r['ms']:.4f} ms/call, "
            f"{r['cta_us'] * 1e3:.3f} ns/CTA, {r['sb_us']:.3f} us/super-block,"
            f" {r['gbs']:.1f} GB/s, bound {r['bound_ms']:.4f} ms, share "
            f"{r['share']:.3f}{' L2-warm' if r['l2_warm'] else ''} {extra}")


def main() -> int:
    if not _timing.require_card("kernel_scaling"):
        return 1
    err = check()
    measure()
    return 0 if err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
