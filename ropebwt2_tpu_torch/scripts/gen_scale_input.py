"""Write the exact read set that scale_run.py builds (the same stream:
readgen.py with the same SCALE_* environment) as ACGT text lines, for the
reference binary in the Gsym-scale parity check (counterpart of
scripts/gen_scale_input.py: the same bytes).

    python -m ropebwt2_tpu_torch.scripts.gen_scale_input OUT.txt

Env: SCALE_NREADS (10_485_760), SCALE_L (101), SCALE_MBATCH (2^21, the
draw chunking, part of the stream's definition), SCALE_DATA / SCALE_COV /
SCALE_ERR / SCALE_SEED (readgen.py).
"""

import os
import sys

import numpy as np

from . import readgen

LUT = np.frombuffer(b"$ACGTN", dtype=np.uint8)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m ropebwt2_tpu_torch.scripts.gen_scale_input "
              "OUT.txt", file=sys.stderr)
        return 1
    env = os.environ.get
    nreads = int(env("SCALE_NREADS", 10_485_760))
    L = int(env("SCALE_L", 101))
    mbatch = int(env("SCALE_MBATCH", 1 << 21))
    gen = readgen.from_env(None, nreads, L, mbatch)
    done = 0
    with open(argv[0], "wb") as f:
        while done < nreads:
            m = min(mbatch, nreads - done)
            lines = np.empty((m, L + 1), np.uint8)
            lines[:, :L] = LUT[gen.batch(m)]
            lines[:, L] = ord("\n")
            lines.tofile(f)
            done += m
            print(f"[gen] {done}/{nreads}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
