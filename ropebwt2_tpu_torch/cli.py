"""ropebwt2 command line driver on one GPU (counterpart of
ropebwt2_tpu/cli.py): flag-compatible with the reference CLI
(main.c:89-343), with the same getopt string, defaults, semantics and
output bytes.

Usage: python -m ropebwt2_tpu_torch.cli [options] <in.fq.gz>

The index is built on the card; ``main(argv, device=...)`` builds on
another device (the tests pass "cpu").  Environment, as for the JAX
package: ROPEBWT2_TPU_DEFER_R (the pending depth R; -1 picks it per batch),
ROPEBWT2_TPU_PACK4 ("auto", 0, or a threshold in symbols for the 4-bit
packed tier), ROPEBWT2_TPU_RUNS (0, 1, or a threshold in symbols for the
run-length tier), ROPEBWT2_TPU_RUNS_MARGIN (run-tier slots planned per
inserted symbol, 2.0), ROPEBWT2_TPU_RUNS_RCAP (a fixed run-tier slot
capacity, 0 for none), ROPEBWT2_TPU_NATIVE=0 (the Python reader and
writers instead of the native host runtime) and ROPEBWT2_TPU_SHARDED=1 (the
multi-device engine, parallel/sharded.py, over the process group: a world
of one, or every rank of ``torchrun --nproc_per_node N -m
ropebwt2_tpu_torch.cli ...``, one card a rank; only rank 0 writes).
"""

import getopt
import os
import sys

import numpy as np

from . import __version__
from .alphabet import SO_IO, SO_RCLO, SO_RLO
from .engine import TorchBwt
from .index.flat import resolve_device
from .io.preprocess import preprocess_record
from .io.seqio import open_seq_stream, read_records
from .utils import log

DEF_BLOCK_LEN = 512  # ROPE_DEF_BLOCK_LEN (rope.h:9) — used for FMR output
DEF_MAX_NODES = 64  # ROPE_DEF_MAX_NODES (rope.h:8)

USAGE = f"""
Usage:   ropebwt2-torch-{__version__} [options] <in.fq.gz>

Options: -l INT     leaf block length for FMR output [{DEF_BLOCK_LEN}]
         -n INT     max number children per internal node for FMR output [{DEF_MAX_NODES}]
         -s         build BWT in the reverse lexicographical order (RLO)
         -r         build BWT in RCLO, overriding -s
         -m INT     batch size for multi-string indexing; 0 for single-string [10g]
         -P         always use a single device (accepted; no-op)
         -M INT     threading threshold (accepted; no-op)

         -i FILE    read existing index in the FMR format from FILE, overriding -s/-r [null]
         -L         input in the one-sequence-per-line format
         -F         skip forward strand
         -R         skip reverse strand
         -N         skip sequences containing ambiguous bases
         -x INT     cut at ambiguous bases and discard segment with length <INT [0]
         -C         cut one base if forward==reverse
         -q INT     hard mask bases with QUAL<INT [0]

         -o FILE    write output to FILE [stdout]
         -b         dump the index in the binary FMR format
         -d         dump the index in fermi's FMD format
         -T         output the index in the Newick format (for debugging)
"""


def parse_batch_size(arg: str) -> int:
    x = arg.strip()
    mult = 1
    if x and x[-1] in "KkMmGg":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[x[-1].lower()]
        x = x[:-1]
    v = float(x) * mult
    return int(v * 0.97) + 1 if v else 0  # the 0.97 fudge of main.c:136


def engine_options():
    """TorchBwt's defer_r, pack4, runs, runs_margin and runs_rcap from the
    environment variables the JAX engine reads (ROPEBWT2_TPU_DEFER_R,
    ROPEBWT2_TPU_PACK4, ROPEBWT2_TPU_RUNS, ROPEBWT2_TPU_RUNS_MARGIN,
    ROPEBWT2_TPU_RUNS_RCAP)."""
    env = os.environ.get
    r = int(env("ROPEBWT2_TPU_DEFER_R", "-1"))
    p = env("ROPEBWT2_TPU_PACK4", "auto")
    return {"defer_r": None if r < 0 else r,
            "pack4": p if p == "auto" else int(p),
            "runs": int(env("ROPEBWT2_TPU_RUNS", "0")) or None,
            "runs_margin": float(env("ROPEBWT2_TPU_RUNS_MARGIN", "2.0")),
            "runs_rcap": int(env("ROPEBWT2_TPU_RUNS_RCAP", "0"))}


def main(argv=None, device=None) -> int:
    cleanup = []  # what the run started and must end (the process group)
    try:
        return _main(sys.argv[1:] if argv is None else argv, device, cleanup)
    finally:
        for fn in cleanup:
            fn()


def _main(argv, device, cleanup) -> int:
    try:
        opts, args = getopt.getopt(argv, "BPNLTFRCtrbdsl:n:m:v:o:i:q:M:x:")
    except getopt.GetoptError as e:
        log.error("main", "%s", e)
        return 1

    m = int(0.97 * 10 * 1024 * 1024 * 1024) + 1
    so = SO_IO
    block_len, max_nodes = DEF_BLOCK_LEN, DEF_MAX_NODES
    verbose, min_q, min_cut_len = 3, 0, 0
    fwd = rev = True
    line_mode = skip_n = cut_n = trim_pal = False
    out_mode = "text"  # text | fmr | fmd | crlf | tree
    out_path = None
    restore_path = None

    for o, a in opts:
        if o == "-o":
            out_path = a
        elif o == "-F":
            fwd = False
        elif o == "-R":
            rev = False
        elif o == "-C":
            trim_pal = True
        elif o == "-T":
            out_mode = "tree"
        elif o == "-b":
            out_mode = "fmr"
        elif o == "-d":
            out_mode = "fmd"
        elif o == "-B":
            out_mode = "crlf"
        elif o == "-L":
            line_mode = True
        elif o == "-N":
            skip_n = True
        elif o in ("-t", "-P", "-M"):
            pass  # host threading knobs: accepted for compatibility
        elif o == "-s":
            so = SO_RLO if so != SO_RCLO else SO_RCLO
        elif o == "-r":
            so = SO_RCLO
        elif o == "-l":
            block_len = int(a)
        elif o == "-n":
            max_nodes = int(a)
        elif o == "-v":
            verbose = int(a)
        elif o == "-q":
            min_q = int(a)
        elif o == "-x":
            min_cut_len = int(a)
            cut_n = True
        elif o == "-i":
            restore_path = a
        elif o == "-m":
            m = parse_batch_size(a)

    log.set_verbosity(verbose)
    from_stdin = not sys.stdin.isatty()
    if not args and not from_stdin:
        sys.stderr.write(USAGE + "\n")
        return 1
    if cut_n and m == 0:
        log.error("main", "option '-x' cannot be used with '-m0'")
        return 1
    mesh = None
    try:
        if os.environ.get("ROPEBWT2_TPU_SHARDED", "0") == "1":
            from .parallel.mesh import make_mesh

            mesh = make_mesh(device=device)
            cleanup.append(mesh.close)
            device = mesh.device
        else:
            device = resolve_device(device, "TorchBwt")
    except RuntimeError as e:
        log.error("main", "%s", e)
        return 1
    log.message("main", "device %s", _device_name(device))
    if mesh is not None:
        log.message("main", "sharded engine over %d devices", mesh.d)

    log.liftrlimit()
    eng_opts = engine_options()
    if restore_path is not None:
        from .io.fmr import read_fmr_state

        try:
            bwt, so = read_fmr_state(restore_path, device=device,
                                     **eng_opts)
        except OSError:
            log.error("main", "fail to open file '%s'", restore_path)
            return 1
        except (EOFError, ValueError) as e:
            log.error("main", "fail to read FMR file '%s': %s", restore_path, e)
            return 1
        if mesh is not None:  # re-shard the restored flat index
            from .parallel.sharded import ShardedTorchBwt

            bwt = ShardedTorchBwt.from_single(bwt, mesh=mesh)
    elif mesh is not None:
        from .parallel.sharded import ShardedTorchBwt

        bwt = ShardedTorchBwt(so=so, mesh=mesh, defer_r=eng_opts["defer_r"])
    else:
        bwt = TorchBwt(so=so, device=device, **eng_opts)

    ct, rt = log.cputime(), log.realtime()
    in_path = args[0] if args else None
    use_native = m > 0 and _native_enabled()
    log.message("main", "reader: %s", "native" if use_native else "python")
    if use_native:
        from .native.lib import NativeReader

        reader = NativeReader(in_path, line_mode=line_mode)
        while True:
            batch = reader.next_batch(
                min_fill=m,
                min_q=min_q,
                skip_n=skip_n,
                cut_n=cut_n,
                min_cut_len=min_cut_len,
                trim_pal=trim_pal,
                fwd=fwd,
                rev=rev,
            )
            if batch is None:
                break
            ct0, rt0 = log.cputime(), log.realtime()
            bwt.insert_nul_batch(batch)
            _sync(device)
            log.message(
                "main",
                "inserted %d symbols in %.3f sec, %.3f CPU sec",
                len(batch),
                log.realtime() - rt0,
                log.cputime() - ct0,
            )
        reader.close()
    else:
        stream = open_seq_stream(in_path)
        batch, batch_syms = [], 0

        def flush():
            nonlocal batch, batch_syms
            if not batch:
                return
            ct0, rt0 = log.cputime(), log.realtime()
            bwt.insert_multi(batch, already_reversed=True)
            _sync(device)
            log.message(
                "main",
                "inserted %d symbols in %.3f sec, %.3f CPU sec",
                batch_syms,
                log.realtime() - rt0,
                log.cputime() - ct0,
            )
            batch, batch_syms = [], 0

        for seq, qual in read_records(stream, line_mode=line_mode):
            for s in preprocess_record(
                seq,
                qual,
                min_q=min_q,
                skip_n=skip_n,
                cut_n=cut_n,
                min_cut_len=min_cut_len,
                trim_palindrome=trim_pal,
                fwd=fwd,
                rev=rev,
            ):
                if m:
                    batch.append(s)
                    batch_syms += len(s) + 1
                else:
                    bwt.insert_multi([s], already_reversed=True)
            if m and batch_syms >= m:
                flush()
        flush()

    cnt = bwt.counts()
    log.message(
        "main",
        "constructed FM-index in %.3f sec, %.3f CPU sec",
        log.realtime() - rt,
        log.cputime() - ct,
    )
    log.message(
        "main",
        "symbol counts: ($, A, C, G, T, N) = (%d, %d, %d, %d, %d, %d)",
        *[int(c) for c in cnt],
    )

    if mesh is not None and mesh.s != 0:
        # only rank 0 writes: the others send it their shards
        if out_mode == "text":
            bwt.bwt_array()
        else:
            bwt.run_arrays()
    else:
        write_output(bwt, out_path, out_mode, block_len, max_nodes)
    return 0


def _device_name(device) -> str:
    if device.type == "cuda":
        import torch

        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def _sync(device):
    """Wait for the device, so that a batch's logged time is its own."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _native_enabled() -> bool:
    if os.environ.get("ROPEBWT2_TPU_NATIVE", "1") == "0":
        return False
    from .native import native_available

    return native_available()


def write_output(bwt: TorchBwt, out_path, mode, block_len, max_nodes):
    """Write the constructed index; out_path None = stdout.  Uses the native
    (C++) writers when available, with pure-Python fallbacks.  Every format
    but text is written from the index's run arrays (TorchBwt.run_arrays),
    so the BWT itself never comes to the host."""
    native = mode != "tree" and _native_enabled()
    log.message("main", "writer: %s %s", "native" if native else "python",
                mode)
    if native:
        from .native import lib as nlib

        path = out_path or "-"
        if mode == "text":
            nlib.text_write(bwt.bwt_array(), path)
        elif mode == "fmd":
            mcnt = nlib.fmd_write(*bwt.run_arrays(), path)
            log.message(
                "main",
                "rld: (tot, $, A, C, G, T, N) = (%d, %d, %d, %d, %d, %d, %d)",
                *[int(x) for x in mcnt],
            )
        elif mode == "crlf":
            nlib.crlf_write(*bwt.run_arrays(), bwt.counts(), path)
        elif mode == "fmr":
            from .io.fmr import partition_run_arrays

            syms, lns = partition_run_arrays(bwt)
            nlib.fmr_write(
                np.concatenate(syms),
                np.concatenate(lns),
                np.asarray([len(s) for s in syms], dtype=np.int64),
                bwt.so,
                path,
                block_len,
                max_nodes,
            )
        else:  # pragma: no cover
            raise ValueError(mode)
        return

    out = open(out_path, "wb") if out_path else sys.stdout.buffer
    try:
        if mode == "text":
            from .io.text import write_text_bwt

            write_text_bwt(bwt.bwt_array(), out)
        elif mode == "fmr":
            from .io.fmr import write_fmr

            write_fmr(bwt, out, block_len=block_len, max_nodes=max_nodes)
        elif mode == "fmd":
            from .io.fmd import write_fmd

            write_fmd(bwt.runs(), out)
        elif mode == "crlf":
            from .io.crlf import write_crlf

            write_crlf(bwt.runs(), bwt.counts(), out)
        elif mode == "tree":
            from .io.fmr import write_tree_debug

            write_tree_debug(bwt, out, block_len=block_len, max_nodes=max_nodes)
        else:  # pragma: no cover
            raise ValueError(mode)
    finally:
        out.flush()
        if out_path:
            out.close()


def console_main():
    rt0 = log.realtime()
    ret = main()
    if ret == 0:
        log.message("main", "Version: torch-%s", __version__, min_verbose=1)
        log.message(
            "main", "CMD: %s", " ".join(sys.argv), min_verbose=1
        )
        log.message(
            "main",
            "Real time: %.3f sec; CPU: %.3f sec",
            log.realtime() - rt0,
            log.cputime(),
            min_verbose=1,
        )
    sys.exit(ret)


if __name__ == "__main__":
    console_main()
