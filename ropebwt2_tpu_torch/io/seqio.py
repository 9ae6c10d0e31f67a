"""Sequence input: FASTA/FASTQ/one-per-line readers with transparent gzip.

Capability-parity with the reference's vendored kseq.h (used via
KSEQ_INIT(gzFile, gzread), main.c:12-13): records may be FASTA ('>') or
FASTQ ('@' with '+' quality), sequences may span lines, and `-L` line mode
truncates each line at the first non-alphabetic character (main.c:180-186).

This is the host-side input path; a C++ native reader can replace it behind
the same iterator interface.
"""

import gzip
import io
import sys


def open_seq_stream(path):
    """Open a (possibly gzipped) byte stream; '-' or None = stdin."""
    if path is None or path == "-":
        raw = sys.stdin.buffer
    else:
        raw = open(path, "rb")
    head = raw.read(2) if raw.seekable() else None
    if head is not None:
        raw.seek(0)
        if head == b"\x1f\x8b":
            return gzip.open(raw)
        return raw
    # non-seekable (stdin/pipe): peek via BufferedReader
    buf = io.BufferedReader(raw)
    head = buf.peek(2)[:2]
    if head == b"\x1f\x8b":
        return gzip.open(buf)
    return buf


KSEQ_BUF = 16384  # the reference's kstream buffer size (kseq.h / main.c:12)


def read_lines(stream):
    """`-L` mode: yield (seq_bytes, None) per line, truncated at the first
    non-alphabetic byte (main.c:183-186).

    Reproduces a kstream boundary quirk the reference inherits from kseq
    (kseq.h:91-141): when the decompressed stream length is an exact
    multiple of the 16384-byte buffer, the final fill is full so is_eof
    stays unset; the next ks_getuntil call reads 0 bytes and RETURNS an
    empty line instead of -1.  ropebwt2 then inserts one phantom empty
    read (a lone sentinel).  Same for a completely empty stream.  The
    quirk only exists in line mode — fasta/fastq go through ks_getc,
    which returns -1 on the empty fill."""
    total = 0
    ends_nl = False
    for line in stream:
        total += len(line)
        ends_nl = line.endswith(b"\n")
        line = line.rstrip(b"\r\n")
        end = len(line)
        for i, ch in enumerate(line):
            if not (65 <= ch <= 90 or 97 <= ch <= 122):
                end = i
                break
        yield line[:end], None
    if total % KSEQ_BUF == 0 and (total == 0 or ends_nl):
        yield b"", None


def read_fastx(stream):
    """Yield (seq_bytes, qual_bytes_or_None) records from FASTA/FASTQ."""
    seq = bytearray()
    qual = None
    in_record = False
    lines = iter(stream)
    for line in lines:
        line = line.rstrip(b"\r\n")
        if not line and not in_record:
            continue
        if line[:1] in (b">", b"@"):
            if in_record:
                yield bytes(seq), None
            seq = bytearray()
            qual = None
            in_record = True
        elif line[:1] == b"+" and in_record:
            # kseq semantics (kseq.h:197-208): consume at least one quality
            # line, read until length matches; a mismatch (incl. empty-seq
            # records) is a fatal parse error — stop like kseq's -2.
            qual = bytearray()
            while True:
                try:
                    ql = next(lines).rstrip(b"\r\n")
                except StopIteration:
                    break
                qual.extend(ql)
                if len(qual) >= len(seq):
                    break
            if len(qual) != len(seq):
                return
            yield bytes(seq), bytes(qual)
            seq = bytearray()
            qual = None
            in_record = False
        elif in_record:
            seq.extend(line)
    if in_record:
        yield bytes(seq), None


def read_records(stream, line_mode=False):
    return read_lines(stream) if line_mode else read_fastx(stream)
