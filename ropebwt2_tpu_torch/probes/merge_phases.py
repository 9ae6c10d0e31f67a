"""F: where kernel A's wrapper spends its time, step by step.

Counterpart of scripts/probe_merge_tpu.py::_kernel_only, which ran the TPU
merge kernel alone on a precomputed insertion map beside the wrapper's
other sub-phases (scatters, searchsorted, tables, the full merge) at cap
2^24, M 2^17, K 256, n0 = cap / 2.  Here the steps are index/merge_cuda.py's
own functions, the ones merge() runs:

- ``insertion_map``: the zero-fill of the map and its scatter_;
- ``block_prefix``: the per-CTA index_add_ and cumsum (the TPU's
  searchsorted);
- ``kernel``: kernel A alone (run_kernel);
- ``tables``: the K-fold and prefix_rows;
- ``merge``: the whole wrapper.

At the script's shape and at chip_smoke.py's batch and flush shapes.

    python -m ropebwt2_tpu_torch.probes.merge_phases
"""

import sys

import torch

from . import _timing
from ..index import merge_cuda as mc
from ..index.flat import PAD_TAIL, table_dtype
from ..index.merge_cuda import BS

CASES = (  # name, cap, insertions, live n, K
    ("script", 1 << 24, 1 << 17, 1 << 23, 256),
    ("batch", 1 << 24, 1 << 17, (1 << 24) - (1 << 17) - 4097, 128),
    ("flush", _timing.CAP_FLUSH, _timing.M_FLUSH,
     _timing.CAP_FLUSH - _timing.M_FLUSH - 12345, 128),
)
STEPS = ("insertion_map", "block_prefix", "kernel", "tables")


def lanes(cap: int, m: int, n: int, seed: int, device):
    """(bwt, pos, sym, stream, valid, n) as the script builds them: sorted
    positions in [0, n), stream = arange(m), every lane valid, a random
    live prefix of n symbols and PAD past it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bwt = torch.full((cap + PAD_TAIL,), 6, dtype=torch.int8, device=device)
    bwt[:n] = torch.randint(0, 6, (n,), generator=gen, device=device,
                            dtype=torch.int8)
    pos = torch.sort(torch.randint(0, n, (m,), generator=gen,
                                   device=device)).values
    sym = torch.randint(0, 6, (m,), generator=gen, device=device)
    stream = torch.arange(m, device=device)
    valid = torch.ones(m, dtype=torch.bool, device=device)
    return bwt, pos, sym, stream, valid, torch.tensor(n, device=device)


def composed(bwt, pos, sym, stream, valid, n, K):
    """merge() as its four steps, called one by one."""
    nb = -(-bwt.shape[0] // BS)
    dest, insmap = mc.insertion_map(pos, sym, stream, valid, nb)
    start = mc.block_prefix(dest, nb)
    out, rows = mc.run_kernel(bwt, insmap, start, n)
    return out, mc.tables(rows, bwt.shape[0], K,
                          table_dtype(bwt.shape[0] - PAD_TAIL))


def check(say=print, device="cuda"):
    """The composed steps against merge() on the card at every case: the
    same live prefix, the same table rows, one launch each.  Returns
    max_abs_err over the cases."""
    worst = 0
    for name, cap, m, n, K in CASES:
        args = lanes(cap, m, n, 3, device)
        before = mc.LAUNCHES
        a, ta = mc.merge(*args, K)
        one = mc.LAUNCHES - before
        b, tb = composed(*args, K)
        two = mc.LAUNCHES - before - one
        live = n + m
        err = max(int((a[:live].long() - b[:live].long()).abs().max()),
                  int((ta[: live // K + 1].long()
                       - tb[: live // K + 1].long()).abs().max()))
        if args[0].is_cuda and (one != 1 or two != 1):
            raise AssertionError(f"F {name}: launches {one} and {two}, not 1")
        worst = max(worst, err)
        say(f"F {name}: the composed steps against merge(): max_abs_err "
            f"{err} (tolerance 0), one launch each")
    return worst


def measure(say=print, device="cuda", iters: int = 10):
    """ms of every step and of the whole wrapper at every case, on the
    device (a CUDA graph of ``iters`` calls, so no host cost) and as
    enqueued eagerly one call after another (CUDA events around the
    calls: the host's cost shows where it exceeds the device's), with the
    kernel's bound.  Returns {case: {"device": {step: ms}, "eager": {step:
    ms}, "bound_ms": ms}}."""
    out = {}
    for name, cap, m, n, K in CASES:
        bwt, pos, sym, stream, valid, nt = lanes(cap, m, n, 4, device)
        alloc = bwt.shape[0]
        nb = -(-alloc // BS)
        tdt = table_dtype(alloc - PAD_TAIL)
        dest, insmap = mc.insertion_map(pos, sym, stream, valid, nb)
        start = mc.block_prefix(dest, nb)
        _, rows = mc.run_kernel(bwt, insmap, start, nt)
        fns = {
            "insertion_map": lambda: mc.insertion_map(pos, sym, stream,
                                                      valid, nb),
            "block_prefix": lambda: mc.block_prefix(dest, nb),
            "kernel": lambda: mc.run_kernel(bwt, insmap, start, nt),
            "tables": lambda: mc.tables(rows, alloc, K, tdt),
            "merge": lambda: mc.merge(bwt, pos, sym, stream, valid, nt, K),
        }
        t = {"device": {s: _timing.graph_ms(f, iters) for s, f in fns.items()},
             "eager": {s: _timing.event_ms(f, iters) for s, f in fns.items()},
             "bound_ms": _timing.bound_ms(_timing.merge_bytes(n, m, alloc))}
        out[name] = t
        for how in ("device", "eager"):
            d = t[how]
            say(f"F {name} ({how}): cap {cap} M {m} n {n} K {K}: "
                + ", ".join(f"{s} {d[s]:.4f} ms "
                            f"({100 * d[s] / d['merge']:.1f}%)" for s in STEPS)
                + f"; steps {sum(d[s] for s in STEPS):.4f} ms, whole "
                f"wrapper {d['merge']:.4f} ms")
        say(f"F {name}: kernel bound {t['bound_ms']:.4f} ms, share "
            f"{_timing.share(t['bound_ms'], t['device']['kernel']):.3f} "
            f"on the device")
        del bwt, pos, sym, stream, valid, dest, insmap, start, rows, fns
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not _timing.require_card("merge_phases"):
        return 1
    err = check()
    measure()
    return 0 if err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
