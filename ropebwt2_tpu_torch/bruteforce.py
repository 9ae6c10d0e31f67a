"""Brute-force multi-string BWT by explicit suffix sorting (tiny inputs only;
a copy of ropebwt2_tpu/bruteforce.py).

Independent of the BCR algorithm: used to validate the oracle's semantics.

Definition: for a collection of strings s_0..s_{m-1} (original orientation,
nt6 codes), each string conceptually carries its own sentinel $_k with
$_i < $_j iff i < j, and every $ sorts before every other symbol.  The BWT is
the sequence of characters cyclically preceding the sorted suffixes of all
texts s_k·$_k.

RLO/RCLO are IO after implicitly re-sorting the collection (README.md:10-25):
RLO sorts strings by reverse-lexicographic order (`rev | sort | rev`), RCLO by
reverse-complement-lexicographic order (`rev | tr ACGT TGCA | sort | tr | rev`
— i.e. sort keys are the complemented reversed strings).
"""

from .alphabet import comp6
from .oracle import SO_IO, SO_RLO, SO_RCLO


def bwt_bruteforce(strings, so=SO_IO):
    """Return the BWT (list of nt6 codes) of the collection under order `so`.

    `strings` are in original orientation (NOT reversed), no sentinels."""
    strs = [list(s) for s in strings]
    if so == SO_RLO:
        strs.sort(key=lambda s: tuple(reversed(s)))
    elif so == SO_RCLO:
        strs.sort(key=lambda s: tuple(comp6(c) for c in reversed(s)))
    elif so != SO_IO:
        raise ValueError(so)

    suffixes = []  # (sort key, preceding char)
    for k, s in enumerate(strs):
        text = list(s) + [0]
        n = len(text)
        for i in range(n):
            # char cyclically preceding suffix i; for i=0 it is the sentinel.
            prev = text[i - 1] if i > 0 else text[n - 1]
            # no interior sentinels => appending k breaks only true $-ties
            suffixes.append((tuple(text[i:]) + (k,), prev))
    suffixes.sort(key=lambda t: t[0])
    return [prev for _, prev in suffixes]
