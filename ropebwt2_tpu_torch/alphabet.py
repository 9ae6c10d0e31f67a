"""The 6-symbol DNA alphabet: $=0, A=1, C=2, G=3, T=4, N=5, and the three
sorting orders.

A copy of ``ropebwt2_tpu/alphabet.py`` (whose package imports jax at import
time) plus the order constants of ``ropebwt2_tpu/oracle.py``.  Mirrors the
reference's encoding (seq_nt6_table, main.c:17-26) and complement rule
(5-c for A..T, mrope.c:182).
"""

import numpy as np

SENT, A, C, G, T, N = 0, 1, 2, 3, 4, 5
NSYM = 6

SYM_CHARS = "$ACGTN"

# sorting orders: input order, reverse lexicographic, reverse complement
# lexicographic (ropebwt2 -s / -r)
SO_IO, SO_RLO, SO_RCLO = 0, 1, 2

# ASCII -> nt6 code. Everything unknown maps to N=5; only ACGTacgt map to 1..4.
# Bytes >= 128 also map to 5 (main.c:191); byte 0 maps to 0 like
# seq_nt6_table[0] (main.c:17).
NT6_TABLE = np.full(256, 5, dtype=np.uint8)
NT6_TABLE[0] = 0
for _ch, _code in (("A", 1), ("C", 2), ("G", 3), ("T", 4)):
    NT6_TABLE[ord(_ch)] = _code
    NT6_TABLE[ord(_ch.lower())] = _code


def comp6(c):
    """Complement of an nt6 code: A<->T, C<->G; $ and N map to themselves."""
    return 5 - c if 1 <= c <= 4 else c


COMP6_TABLE = np.array([comp6(c) for c in range(6)], dtype=np.uint8)


def encode_nt6(seq: bytes) -> np.ndarray:
    """Encode an ASCII sequence into nt6 codes (uint8 array)."""
    return NT6_TABLE[np.frombuffer(seq, dtype=np.uint8)]


def decode_nt6(codes) -> str:
    """Decode nt6 codes to the '$ACGTN' character set (for debug/tests)."""
    return "".join(SYM_CHARS[c] for c in codes)
