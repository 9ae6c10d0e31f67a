"""CRLF — the reference's streaming run-length BWT container (-B output;
crlf.c, crlf.h).  Byte-identical writer/reader for the RL53 codec:

  "CRL\\1" + n_symbols(u8) + dectab(256 x u32le) + n_tags(u32le) +
  tags(2 chars + u64le len + data) + run bytes (len<<3 | sym, runs > 31
  emitted as repeated 31-length bytes).

The CLI writes one 'MC' tag carrying the six marginal counts
(main.c:280-288)."""

import struct

import numpy as np


def rl53_dectab() -> np.ndarray:
    x = np.arange(256, dtype=np.uint32)
    return (x >> 3) << 8 | (x & 7)


def write_crlf(runs, counts, out, n_symbols=6):
    out.write(b"CRL\x01")
    out.write(bytes([n_symbols]))
    out.write(rl53_dectab().astype("<u4").tobytes())
    tags = [(b"MC", np.asarray(counts, dtype="<i8").tobytes())]
    out.write(struct.pack("<I", len(tags)))
    for tag, data in tags:
        out.write(tag)
        out.write(struct.pack("<Q", len(data)))
        out.write(data)
    # merge adjacent equal-symbol runs (crlf_write) then emit RL53 bytes;
    # crlf_close always flushes the staging run, so an empty BWT still
    # produces one 0x00 byte (crlf.c:74-76).
    merged_c, merged_l = 0, 0
    chunks = []
    for c, l in runs:
        if l == 0:
            continue
        if merged_l > 0 and c != merged_c:
            chunks.append(_rl53(merged_c, merged_l))
            merged_c, merged_l = c, l
        elif merged_l > 0:
            merged_l += l
        else:
            merged_c, merged_l = c, l
    chunks.append(_rl53(merged_c, merged_l))
    out.write(b"".join(chunks))


def _rl53(c, l) -> bytes:
    # runs > 31 become repeated 31-length bytes; remainder may be exactly 31
    out = bytearray()
    while l > 31:
        out.append(31 << 3 | c)
        l -= 31
    out.append(l << 3 | c)
    return bytes(out)


def read_crlf(path_or_file):
    """Read a CRLF file -> (runs, tags dict, n_symbols)."""
    f = (
        open(path_or_file, "rb")
        if isinstance(path_or_file, (str, bytes))
        else path_or_file
    )
    close = isinstance(path_or_file, (str, bytes))
    try:
        if f.read(4) != b"CRL\x01":
            raise ValueError("not a CRLF file")
        n_symbols = f.read(1)[0]
        dectab = np.frombuffer(f.read(1024), dtype="<u4")
        (n_tags,) = struct.unpack("<I", f.read(4))
        tags = {}
        for _ in range(n_tags):
            tag = f.read(2)
            (ln,) = struct.unpack("<Q", f.read(8))
            tags[tag.decode()] = f.read(ln)
        data = np.frombuffer(f.read(), dtype=np.uint8)
        ls = (dectab[data] >> 8).astype(np.int64)
        cs = (dectab[data] & 7).astype(np.int32)
        runs = []
        for c, l in zip(cs, ls):
            if runs and runs[-1][0] == c:
                runs[-1][1] += int(l)
            else:
                runs.append([int(c), int(l)])
        return [(c, l) for c, l in runs if l > 0], tags, n_symbols
    finally:
        if close:
            f.close()
