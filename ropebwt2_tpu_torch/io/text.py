"""Plain-text BWT output: '$ACGTN' characters, one trailing newline
(main.c:307-314,323)."""

import numpy as np

_LUT = np.frombuffer(b"$ACGTN?", dtype=np.uint8)


def write_text_bwt(bwt_codes: np.ndarray, out, chunk=1 << 24):
    for i in range(0, len(bwt_codes), chunk):
        out.write(_LUT[bwt_codes[i : i + chunk].astype(np.uint8)].tobytes())
    out.write(b"\n")


def bwt_to_text(bwt_codes: np.ndarray) -> bytes:
    return _LUT[np.asarray(bwt_codes, dtype=np.uint8)].tobytes() + b"\n"
