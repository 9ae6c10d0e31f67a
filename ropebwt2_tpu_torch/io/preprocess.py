"""Read preprocessing: the exact pipeline of main.c:188-237.

Transforms one input record into zero or more *insertion-oriented* strings
(i.e. reversed, the orientation mr_insert_multi consumes), applying in order:

  nt6 encoding -> quality hard-mask (-q) -> skip-ambiguous (-N) ->
  reversal -> cut-at-N (-x, possibly yielding several NUL-separated
  segments) -> even-palindrome trim (-C) -> forward strand emit ->
  in-place reverse-complement -> reverse strand emit.
"""

import numpy as np

from ..alphabet import NT6_TABLE


def is_rev_same(s: np.ndarray) -> bool:
    """True iff s equals its own reverse complement (even length only),
    main.c:80-87."""
    l = len(s)
    if l & 1:
        return False
    half = l >> 1
    return bool(
        np.all(
            s[:half].astype(np.int32) + s[l - half :][::-1].astype(np.int32)
            == 5
        )
    )


def _revcomp_inplace(s: np.ndarray) -> np.ndarray:
    """The reference's in-place second-strand transform (main.c:228-234):
    reverse and complement (A<->T, C<->G; $ and N fixed)."""
    out = s[::-1].copy()
    sub = (out >= 1) & (out <= 4)
    out[sub] = 5 - out[sub]
    return out


def preprocess_record(
    seq: bytes,
    qual,
    *,
    min_q: int = 0,
    skip_n: bool = False,
    cut_n: bool = False,
    min_cut_len: int = 0,
    trim_palindrome: bool = False,
    fwd: bool = True,
    rev: bool = True,
):
    """Yield insertion-oriented strings (np.int8 arrays, possibly empty) for
    one record. Flags map to -q/-N/-x/-C/-F/-R (main.c:28-38,100-120)."""
    s = NT6_TABLE[np.frombuffer(seq, dtype=np.uint8)].astype(np.int8)
    if qual and min_q > 0:
        q = np.frombuffer(qual, dtype=np.uint8).astype(np.int32) - 33
        k = min(len(s), len(q))  # tolerate truncated quality strings
        s = s.copy()
        s[:k] = np.where(q[:k] >= min_q, s[:k], np.int8(5))
    if skip_n and bool(np.any(s == 5)):
        return
    s = s[::-1].copy()  # insertion orientation (main.c:200-203)

    if cut_n:
        # split the REVERSED sequence at N, drop short segments, keep the
        # rest NUL-separated in one buffer (main.c:204-218)
        out = []
        b = 0
        for i in range(len(s) + 1):
            if i == len(s) or s[i] == 5:
                seg = s[b:i]
                if len(seg) >= min_cut_len:
                    if trim_palindrome and is_rev_same(seg):
                        if len(seg) == 0:
                            # reference: is_rev_same is vacuously true for an
                            # empty segment, and its --k then overwrites the
                            # previous NUL — the empty segment vanishes
                            # (main.c:210)
                            b = i + 1
                            continue
                        seg = seg[:-1]
                    out.append(seg)
                    out.append(np.zeros(1, dtype=np.int8))
                b = i + 1
        if not out:
            return
        s = np.concatenate(out)[:-1]  # drop trailing NUL (the --k)
        if len(s) == 0:
            return
    if trim_palindrome and is_rev_same(s):
        s = s[:-1]

    if fwd:
        yield from _split_nuls(s)
    if rev:
        s = _revcomp_inplace(s)
        yield from _split_nuls(s)


def _split_nuls(s: np.ndarray):
    """A slot buffer may contain embedded NULs after -x; the batch splitter
    (mrope.c:269-277) treats each NUL-terminated piece as its own string."""
    if not bool(np.any(s == 0)):
        yield s
        return
    start = 0
    for i in np.flatnonzero(s == 0):
        yield s[start:i]
        start = int(i) + 1
    yield s[start:]
