"""The reference's "43+3" run-length byte codec (rle.h:39-75), used inside
FMR leaf blocks.  Runs are (symbol in 3 bits, length in 4/8/19/43 bits)
encoded in 1/2/4/8 bytes; continuation bytes carry 6 payload bits under a
0b10 tag.  Pure re-implementation from the format spec for FMR
inter-operability with the reference."""


def enc_run(c: int, l: int) -> bytes:
    # NB: the 8-byte form stores 1 + 7*6 = 43 length bits (rle_dec1 reads a
    # single bit from the head byte), so the hard ceiling is 2^43, not the
    # 2^45 the reference's encoder asserts.
    assert 0 <= c < 8 and 0 < l < 1 << 43
    if l < 1 << 4:
        return bytes([l << 3 | c])
    if l < 1 << 8:
        return bytes([0xC0 | (l >> 6) << 3 | c, 0x80 | (l & 0x3F)])
    if l < 1 << 19:
        return bytes(
            [
                0xE0 | (l >> 18) << 3 | c,
                0x80 | (l >> 12 & 0x3F),
                0x80 | (l >> 6 & 0x3F),
                0x80 | (l & 0x3F),
            ]
        )
    out = [0xF0 | (l >> 42) << 3 | c]
    for shift in range(36, -1, -6):
        out.append(0x80 | (l >> shift & 0x3F))
    return bytes(out)


def enc_size(l: int) -> int:
    if l < 1 << 4:
        return 1
    if l < 1 << 8:
        return 2
    if l < 1 << 19:
        return 4
    return 8


def dec_runs(payload: bytes):
    """Decode a full block payload into (symbol, length) pairs (rle_dec1)."""
    out = []
    i = 0
    n = len(payload)
    while i < n:
        b0 = payload[i]
        c = b0 & 7
        if b0 & 0x80 == 0:
            l = b0 >> 3
            i += 1
        elif b0 >> 5 == 6:
            l = (b0 & 0x18) << 3 | (payload[i + 1] & 0x3F)
            i += 2
        else:
            nb = ((b0 & 0x10) >> 2) + 4
            l = b0 >> 3 & 1
            for j in range(1, nb):
                l = l << 6 | (payload[i + j] & 0x3F)
            i += nb
        out.append((c, l))
    return out
