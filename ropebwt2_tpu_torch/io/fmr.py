"""FMR — the reference's live-index dump format, used for checkpoint/resume
and incremental builds (-b / -i).

Layout (mr_dump, mrope.c:136-143; rope_dump, rope.c:253-275):

  "RB\\2" + so(1B), then six rope dumps.  Each rope: max_nodes(i32le),
  block_len(i32le), then a preorder node walk: [is_bottom u8][n i16le];
  bottom nodes carry, per child, c[6] (6 x i64le symbol counts of the leaf)
  followed by the raw leaf block (u16le payload size + payload in the 43+3
  rle codec); internal nodes carry their n children recursively (their
  counts are recomputed on restore, rope.c:299-304).

We synthesize a balanced tree from the flat run-length partitions when
writing (any valid tree restores identically — restore only concatenates
leaves in preorder), and flatten trees back to runs when reading.  Output is
readable by the reference (`ropebwt2 -i ours.fmr` works) and vice versa.
"""

import struct

import numpy as np

from ..alphabet import NSYM
from .rle_codec import dec_runs, enc_run

MAGIC = b"RB\x02"
MIN_SPACE = 18  # RLE_MIN_SPACE (rle.h:35): keep headroom like a live block


# ---------- writing ----------


def _pack_leaves(runs, block_len):
    """Greedy-pack (sym, len) runs into leaf blocks with the same headroom a
    live rope keeps (split threshold, rope.c:143). Yields (payload_bytes,
    counts[6]) leaves; at least one (possibly empty) leaf."""
    cap = block_len - MIN_SPACE
    leaves = []
    payload = bytearray()
    counts = [0] * NSYM
    maxlen = (1 << 43) - 1
    for c, l in runs:
        while l > 0:
            step = min(l, maxlen)
            enc = enc_run(c, step)
            if len(payload) + len(enc) > cap and payload:
                leaves.append((bytes(payload), counts))
                payload, counts = bytearray(), [0] * NSYM
            payload.extend(enc)
            counts[c] += step
            l -= step
    leaves.append((bytes(payload), counts))
    return leaves


def _write_rope(out, runs, block_len, max_nodes):
    out.write(struct.pack("<ii", max_nodes, block_len))
    leaves = _pack_leaves(runs, block_len)

    # bottom level: group leaves into bottom nodes of <= max_nodes children
    def emit_bottom(group):
        out.write(struct.pack("<Bh", 1, len(group)))
        for payload, counts in group:
            out.write(struct.pack("<6q", *counts))
            out.write(struct.pack("<H", len(payload)))
            out.write(payload)

    # build the level structure top-down: number of bottom nodes
    groups = [
        leaves[i : i + max_nodes] for i in range(0, len(leaves), max_nodes)
    ]

    def emit_internal(nodes):
        """nodes: list of thunks at one level; group into parents until a
        single root remains, emitting preorder."""
        if len(nodes) == 1:
            nodes[0]()
            return
        parents = []
        for i in range(0, len(nodes), max_nodes):
            children = nodes[i : i + max_nodes]

            def parent(children=children):
                out.write(struct.pack("<Bh", 0, len(children)))
                for ch in children:
                    ch()

            parents.append(parent)
        emit_internal(parents)

    emit_internal([lambda g=g: emit_bottom(g) for g in groups])


def _clamp_params(block_len, max_nodes):
    """The reference clamps construction params in rope_init (rope.c:59-61):
    block_len >= 32 rounded up to x8, max_nodes rounded up to even.  Its -b
    dump therefore always carries clamped values; match, and keep leaf
    payloads within the restorer's fixed-size leaf allocation."""
    block_len = max(block_len, 32)
    block_len = (block_len + 7) >> 3 << 3
    max_nodes = (max_nodes + 1) >> 1 << 1
    return block_len, max_nodes


def write_fmr_runs(partition_runs, so, out, block_len=512, max_nodes=64):
    """partition_runs: list of 6 run lists [(sym, len), ...]."""
    block_len, max_nodes = _clamp_params(block_len, max_nodes)
    out.write(MAGIC)
    out.write(bytes([so]))
    for b in range(NSYM):
        _write_rope(out, partition_runs[b], block_len, max_nodes)


def write_fmr(bwt, out, block_len=512, max_nodes=64):
    """Dump a TorchBwt engine index (mr_dump equivalent)."""
    write_fmr_runs(
        partition_runs_from_state(bwt), bwt.so, out, block_len, max_nodes
    )


def partition_runs_from_state(bwt):
    """Split the engine's BWT into six per-partition run lists, from its
    run arrays split at the partition offsets (any tier)."""
    sym, ln = partition_run_arrays(bwt)
    return [list(zip(s.tolist(), l.tolist())) for s, l in zip(sym, ln)]


def partition_run_arrays(bwt):
    """([sym uint8[]] * 6, [len int64[]] * 6): the engine's runs of each
    partition (TorchBwt.run_arrays split at the offsets of state.psize)."""
    psize = bwt.state.psize.cpu().numpy()
    off = np.concatenate([[0], np.cumsum(psize)]).astype(np.int64)
    sym, ln = bwt.run_arrays(bounds=off)
    edges = np.searchsorted(np.cumsum(ln), off, side="right")
    return ([sym[edges[b]: edges[b + 1]] for b in range(NSYM)],
            [ln[edges[b]: edges[b + 1]] for b in range(NSYM)])


# ---------- reading ----------


def _read_exact(f, n):
    b = f.read(n)
    if len(b) != n:
        raise EOFError("truncated FMR file")
    return b


def _read_rope(f):
    max_nodes, block_len = struct.unpack("<ii", _read_exact(f, 8))
    runs = []

    def node():
        is_bottom, n = struct.unpack("<Bh", _read_exact(f, 3))
        if is_bottom:
            for _ in range(n):
                _read_exact(f, 48)  # leaf counts: recomputed from payload
                (nptr,) = struct.unpack("<H", _read_exact(f, 2))
                payload = _read_exact(f, nptr)
                runs.extend(dec_runs(payload))
        else:
            for _ in range(n):
                node()

    node()
    # merge adjacent equal-symbol runs across leaf boundaries
    merged = []
    for c, l in runs:
        if merged and merged[-1][0] == c:
            merged[-1][1] += l
        else:
            merged.append([c, l])
    return [(c, l) for c, l in merged], max_nodes, block_len


def read_fmr_runs(path_or_file):
    """Read an FMR file -> (partition_runs, so)."""
    f = (
        open(path_or_file, "rb")
        if isinstance(path_or_file, (str, bytes))
        else path_or_file
    )
    close = isinstance(path_or_file, (str, bytes))
    try:
        magic = _read_exact(f, 4)
        if magic[:3] != MAGIC:
            raise ValueError("not an FMR file (bad magic)")
        so = magic[3]
        parts = [_read_rope(f)[0] for _ in range(NSYM)]
        return parts, so
    finally:
        if close:
            f.close()


def read_fmr_state(path, K=128, device=None, **engine_options):
    """Restore an FMR file into a live engine (mr_restore equivalent) on
    ``device`` (None: the card), with TorchBwt's other options (defer_r,
    pack4, runs, ...).  Returns (TorchBwt, so).  The index is restored on
    the flat tier; a run-tier engine converts it at its first batch.  The
    bytes do not depend on K; K = 128 keeps the packed tier reachable when
    the restored index grows past its threshold."""
    from ..engine import TorchBwt
    from ..index.flat import state_from_partition_runs
    from ..utils import log

    parts, so = read_fmr_runs(path)
    eng = TorchBwt(so=so, K=K, device=device, **engine_options)
    eng.state = state_from_partition_runs(parts, K, device=eng.device)
    eng._n = sum(l for p in parts for _, l in p)
    eng._n_strings = sum(l for p in parts for c, l in p if c == 0)
    cnt = eng.counts()
    log.message(
        "mr_restore",
        "($, A, C, G, T, N) = (%d, %d, %d, %d, %d, %d)",
        *[int(x) for x in cnt],
    )
    return eng, so


# ---------- Newick-ish debug dump (-T; rope_print_node, rope.c:225-251) ----


def write_tree_debug(bwt, out, block_len=512, max_nodes=64):
    """Parenthesized leaf dump per rope. Note: tree SHAPE is our synthesized
    packing, not the reference's insertion history; leaf concatenation (the
    BWT content) is identical."""
    tab = b"$ACGTN"
    block_len, max_nodes = _clamp_params(block_len, max_nodes)
    for runs in partition_runs_from_state(bwt):
        leaves = _pack_leaves(runs, block_len)
        out.write(b"(")
        for i, (payload, _) in enumerate(leaves):
            if i:
                out.write(b",")
            for c, l in dec_runs(payload):
                out.write(tab[c : c + 1] * l)
        out.write(b")")
    out.write(b"\n")
