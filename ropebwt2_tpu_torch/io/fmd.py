"""FMD — fermi's static delta-coded FM-index format (rld0.c), the -d output.

Byte-identical re-implementation of the rld0 encoder from the format spec:

* data = superblocks of 2^23 64-bit words; small blocks of ssize=2^sbits
  words (sbits=3 for the CLI, rld_init(6,3), main.c:274)
* each small block: header with the previous blocks' marginal symbol counts
  since the last header, in adaptive 16/32/64-bit ints (type in the top 2
  bits of word 0, enc_next_block, rld0.c:107-135), then bit-packed runs
* a run (l, c) packs Elias-delta(l) followed by the 3-bit symbol, MSB-first
  within 64-bit words; a run never straddles a small-block boundary
  (rld_enc1, rld0.c:137-151)
* after the data: a sampled rank frame index (rld_rank_index,
  rld0.c:163-205)
* file: "RLD\\3" + (asize<<16|sbits) u32 + 8 reserved bytes + n_bytes u64 +
  n_frames u64 + 6 marginal counts u64 + data + frames (rld_dump,
  rld0.c:223-244).
"""

import struct

RLD_LBITS = 23
RLD_LSIZE = 1 << RLD_LBITS
IBITS_PLUS = 4


def _ilog2(v: int) -> int:
    return v.bit_length() - 1 if v > 0 else -1


def _delta_enc(x: int):
    """Elias-delta: gamma(y+1) then the low y bits of x, y = floor(log2 x).
    Returns (value, width) per rld_delta_enc1 (rld0.c:45-51)."""
    y = _ilog2(x)
    z = _ilog2(y + 1)
    width = (z << 1) + 1 + y
    val = (x ^ (1 << y)) | (y + 1) << y
    return val, width


class FmdEncoder:
    """Streaming rld0-compatible encoder (asize=6, abits=3)."""

    def __init__(self, asize=6, sbits=3):
        self.asize = asize
        self.asize1 = asize + 1
        self.abits = _ilog2(asize) + 1
        self.sbits = sbits
        self.ssize = 1 << sbits
        self.offset0 = [
            (self.asize1 * 16 + 63) // 64,
            (self.asize1 * 32 + 63) // 64,
            self.asize1,
        ]
        self.words = [0] * RLD_LSIZE  # current superblock
        self.supers = []  # completed superblocks (lists of words)
        self.cnt = [0] * self.asize1  # cumulative symbol counts
        self.mcnt = [0] * self.asize1  # snapshot at last block header
        # iterator state: block 0 has an implicit all-zero type-0 header
        self.shead = 0  # word index of current block within superblock
        self.p = self.offset0[0]  # current word index
        self.r = 64  # bits remaining in words[p]
        self._set_stail()
        # pending run (rld_enc merging)
        self.pc = -1
        self.pl = 0

    def _set_stail(self):
        end_of_super = self.shead + self.ssize == RLD_LSIZE
        self.stail = self.shead + self.ssize - (2 if end_of_super else 1)

    def _next_block(self):
        if self.stail + 2 == RLD_LSIZE:  # superblock full
            self.supers.append(self.words)
            self.words = [0] * RLD_LSIZE
            self.shead = 0
        else:
            self.shead += self.ssize
        marg = [self.cnt[i] - self.mcnt[i] for i in range(self.asize1)]
        if marg[0] < 0x4000:
            type_ = 0
            for i, v in enumerate(marg):  # 16-bit fields
                w, sh = divmod(i * 16, 64)
                self.words[self.shead + w] |= v << sh
        elif marg[0] < 0x40000000:
            type_ = 1
            for i, v in enumerate(marg):
                w, sh = divmod(i * 32, 64)
                self.words[self.shead + w] |= v << sh
        else:
            type_ = 2
            for i, v in enumerate(marg):
                self.words[self.shead + i] = v
        self.words[self.shead] |= type_ << 62
        self.p = self.shead + self.offset0[type_]
        self._set_stail()
        self.r = 64
        self.mcnt = list(self.cnt)

    def _enc1(self, l: int, c: int):
        val, w = _delta_enc(l)
        x = val << self.abits | c
        w += self.abits
        if w >= self.r and self.p == self.stail:
            self._next_block()
        if w > self.r:
            w -= self.r
            self.words[self.p] |= x >> w
            self.p += 1
            self.r = 64 - w
            self.words[self.p] = (x << self.r) & 0xFFFFFFFFFFFFFFFF
        else:
            self.r -= w
            self.words[self.p] |= (x << self.r) & 0xFFFFFFFFFFFFFFFF
        self.cnt[0] += l
        self.cnt[c + 1] += l

    def enc(self, l: int, c: int):
        if l == 0:
            return
        if self.pc != c:
            if self.pl:
                self._enc1(self.pl, self.pc)
            self.pl, self.pc = l, c
        else:
            self.pl += l

    def finish(self):
        if self.pl:
            self._enc1(self.pl, self.pc)
        self._next_block()
        n_words = len(self.supers) * RLD_LSIZE + self.p
        self.n_bytes = n_words * 8
        self.supers.append(self.words)
        self._build_frames()

    def _word(self, k: int) -> int:
        return self.supers[k >> RLD_LBITS][k & (RLD_LSIZE - 1)]

    def _build_frames(self):
        """rld_rank_index (rld0.c:163-205)."""
        asize, asize1 = self.asize, self.asize1
        n_blks = self.n_bytes * 8 // 64 // self.ssize + 1
        last = (self.n_bytes >> 3) >> self.sbits << self.sbits
        self.ibits = _ilog2(self.mcnt[0] // n_blks) + IBITS_PLUS
        self.n_frames = (
            (self.mcnt[0] + (1 << self.ibits) - 1) >> self.ibits
        ) + 1
        frame = [0] * (self.n_frames * asize1)
        cnt = [0] * asize
        k = 1
        i = self.ssize
        while i <= last:
            w0 = self._word(i)
            type_ = w0 >> 62
            if type_ == 0:
                for j in range(1, asize1):
                    ww, sh = divmod(j * 16, 64)
                    cnt[j - 1] += (self._word(i + ww) >> sh) & 0xFFFF
            elif type_ == 1:
                for j in range(1, asize1):
                    ww, sh = divmod(j * 32, 64)
                    v = (self._word(i + ww) >> sh) & 0xFFFFFFFF
                    cnt[j - 1] += v & 0x3FFFFFFF
            else:
                for j in range(1, asize1):
                    cnt[j - 1] += self._word(i + j)
            s = sum(cnt)
            while s >= k << self.ibits:
                k += 1
            if k < self.n_frames:
                x = k * asize1
                frame[x] = i
                for j in range(asize):
                    frame[x + j + 1] = cnt[j]
            i += self.ssize
        for k in range(1, self.n_frames):
            x = k * asize1
            if frame[x] == 0:
                for j in range(asize1):
                    frame[x + j] = frame[x - asize1 + j]
        self.frame = frame

    def dump(self, out):
        out.write(b"RLD\x03")
        out.write(struct.pack("<I", self.asize << 16 | self.sbits))
        out.write(struct.pack("<Q", 0))
        out.write(struct.pack("<Q", self.n_bytes))
        out.write(struct.pack("<Q", self.n_frames))
        for v in self.mcnt[1:]:
            out.write(struct.pack("<Q", v))
        n_words = self.n_bytes // 8
        for sup in self.supers:
            take = min(n_words, RLD_LSIZE)
            out.write(
                b"".join(struct.pack("<Q", w) for w in sup[:take])
            )
            n_words -= take
            if n_words == 0:
                break
        out.write(b"".join(struct.pack("<Q", v) for v in self.frame))


def read_fmd(path_or_file):
    """Decode an FMD file back to (runs, mcnt) — rld_restore + rld_dec
    equivalents (rld0.c:269-306, rld0.h:79-116).  Also accepts the raw
    5+3 RLE byte-stream fallback the reference supports."""
    f = (
        open(path_or_file, "rb")
        if isinstance(path_or_file, (str, bytes))
        else path_or_file
    )
    close = isinstance(path_or_file, (str, bytes))
    try:
        head = f.read(4)
        if head != b"RLD\x03":
            # raw 5+3 RLE byte stream: byte = len<<3 | sym.  Like the
            # reference (rld_restore_header has already consumed the 4
            # magic bytes before the fallback loop, rld0.c:276-289), the
            # first 4 bytes are dropped.
            runs = []
            data = f.read()
            for byte in data:
                if byte >> 3:
                    c, l = byte & 7, byte >> 3
                    if runs and runs[-1][0] == c:
                        runs[-1][1] += l
                    else:
                        runs.append([c, l])
            mcnt = [0] * 7
            for c, l in runs:
                mcnt[0] += l
                mcnt[c + 1] += l
            return [(c, l) for c, l in runs], mcnt

        (a,) = struct.unpack("<I", f.read(4))
        asize, sbits = a >> 16, a & 0xFFFF
        asize1 = asize + 1
        abits = _ilog2(asize) + 1
        ssize = 1 << sbits
        struct.unpack("<Q", f.read(8))  # reserved
        (n_bytes,) = struct.unpack("<Q", f.read(8))
        (n_frames,) = struct.unpack("<Q", f.read(8))
        mcnt_tail = struct.unpack(f"<{asize}Q", f.read(8 * asize))
        n_words = n_bytes // 8
        words = struct.unpack(f"<{n_words}Q", f.read(8 * n_words))
        # frames follow; not needed for decoding

        offset0 = [
            (asize1 * 16 + 63) // 64,
            (asize1 * 32 + 63) // 64,
            asize1,
        ]
        last = (n_bytes >> 3) >> sbits << sbits
        runs = []
        shead = 0
        while shead != last:
            type_ = words[shead] >> 62
            p = shead + offset0[type_]
            stail = shead + ssize - 1  # superblocks never split here: files
            # smaller than RLD_LSIZE words; guarded below
            if (shead + ssize) % RLD_LSIZE == 0:
                stail -= 1
            r = 64
            while True:
                x = (words[p] << (64 - r)) & 0xFFFFFFFFFFFFFFFF
                if p != stail and r != 64:
                    x |= words[p + 1] >> r
                if x >> 63 == 0:
                    w = (0x333333335555779B >> ((x >> 59) << 2)) & 0xF
                    if w == 0xB and (x >> 58) == 0:
                        break  # end of block padding
                    l_ = (x >> (64 - w)) - 1
                    y = ((x << w) & 0xFFFFFFFFFFFFFFFF) >> (64 - l_) | (
                        1 << l_
                    )
                    w += l_
                else:
                    w = y = 1
                c = ((x << w) & 0xFFFFFFFFFFFFFFFF) >> (64 - abits)
                w += abits
                if c > asize:
                    break
                if r > w:
                    r -= w
                else:
                    p += 1
                    r = 64 + r - w
                if p > stail:
                    break
                if runs and runs[-1][0] == c:
                    runs[-1][1] += y
                else:
                    runs.append([c, int(y)])
            shead += ssize
        mcnt = [sum(mcnt_tail)] + list(mcnt_tail)
        return [(c, l) for c, l in runs], mcnt
    finally:
        if close:
            f.close()


_DELTA_WTAB = 0x333333335555779B


def _dec0(words, p, r, stail):
    """Decode one run at word p / bits-remaining r, stopping at stail
    (rld_dec0, rld0.h:79-96; abits=3 hardcoded like _DNA_ONLY).  Returns
    (c, l, p, r) or None at end-of-block padding."""
    x = (int(words[p]) << (64 - r)) & 0xFFFFFFFFFFFFFFFF
    if p != stail and r != 64:
        x |= int(words[p + 1]) >> r
    if x >> 63 == 0:
        w = (_DELTA_WTAB >> ((x >> 59) << 2)) & 0xF
        if w == 0xB and (x >> 58) == 0:
            return None
        l_ = (x >> (64 - w)) - 1
        y = ((x << w) & 0xFFFFFFFFFFFFFFFF) >> (64 - l_) | (1 << l_)
        w += l_
    else:
        w = y = 1
    c = ((x << w) & 0xFFFFFFFFFFFFFFFF) >> 61
    w += 3
    if c > 6:
        return None
    if r > w:
        r -= w
    else:
        p += 1
        r = 64 + r - w
    if p > stail:
        return None
    return int(c), int(y), p, r


class FmdReader:
    """Lazy, mmap-backed FMD index — the rld_restore_mmap equivalent
    (rld0.c:308-327).  The file is mapped read-only as an array of 64-bit
    words; nothing is decoded until queried.

    Query surface mirrors rld0's: rank1a/rank11/rank2a/rank21 point ranks
    via the sampled frame index (rld_locate_blk + block decode,
    rld0.c:357-471), extend() (rld0.c:473-489), a streaming run iterator
    (rld_dec, rld0.h:98-116), and to_flat() to lift the index into a
    device-resident FlatBwt for the batched query API."""

    HDR = 10  # header words before the data: magic/a, reserved, n_bytes,
    # n_frames, mcnt[1..6]  (rld_dump, rld0.c:223-244)

    def __init__(self, path):
        import numpy as np

        self.words = np.memmap(path, dtype=np.uint64, mode="r")
        w0 = int(self.words[0])
        if w0 & 0xFFFFFFFF != int.from_bytes(b"RLD\x03", "little"):
            raise ValueError(f"{path}: not an FMD file")
        a = w0 >> 32
        self.asize, self.sbits = a >> 16, a & 0xFFFF
        self.asize1 = self.asize + 1
        self.ssize = 1 << self.sbits
        self.n_bytes = int(self.words[2])
        self.n_frames = int(self.words[3])
        mtail = [int(self.words[4 + i]) for i in range(self.asize)]
        self.mcnt = [sum(mtail)] + mtail  # marginal counts (mcnt[0] = total)
        # accumulative counts cnt[a] = # symbols < a (rld_restore_header)
        self.cnt = [0] * self.asize1
        for i in range(1, self.asize1):
            self.cnt[i] = self.cnt[i - 1] + mtail[i - 1]
        self.data0 = self.HDR  # first data word
        self.frame0 = self.HDR + self.n_bytes // 8  # first frame word
        n_blks = self.n_bytes * 8 // 64 // self.ssize + 1
        self.ibits = _ilog2(self.mcnt[0] // n_blks) + IBITS_PLUS
        self.offset0 = [
            (self.asize1 * 16 + 63) // 64,
            (self.asize1 * 32 + 63) // 64,
            self.asize1,
        ]

    # --- block-level helpers ---

    def _stail(self, shead):
        """Last usable word of the small block at flat word index shead."""
        end = shead + self.ssize - self.data0
        return shead + self.ssize - (2 if end % RLD_LSIZE == 0 else 1)

    def _hdr_counts(self, q):
        """(region_total, per-symbol counts) from the block header at q
        (enc_next_block layout, rld0.c:107-135)."""
        w0 = int(self.words[q])
        type_ = w0 >> 62
        out = [0] * self.asize
        if type_ == 0:
            c = w0 & 0xFFFF
            for j in range(1, self.asize1):
                ww, sh = divmod(j * 16, 64)
                out[j - 1] = (int(self.words[q + ww]) >> sh) & 0xFFFF
        elif type_ == 1:
            c = w0 & 0xFFFFFFFF
            for j in range(1, self.asize1):
                ww, sh = divmod(j * 32, 64)
                out[j - 1] = (
                    (int(self.words[q + ww]) >> sh) & 0xFFFFFFFF
                ) & 0x3FFFFFFF
        else:
            c = w0 & 0x3FFFFFFFFFFFFFFF
            for j in range(1, self.asize1):
                out[j - 1] = int(self.words[q + j])
        return c, out

    def _locate_blk(self, k):
        """Seek to the small block whose content brackets position k
        (rld_locate_blk, rld0.c:357-398).  Returns (shead, cnt, z, y):
        decode start, per-symbol counts before the block, symbols before
        the block, and the block's end position."""
        fi = (k >> self.ibits) * self.asize1
        z0 = int(self.words[self.frame0 + fi])
        p = self.data0 + (z0 >> RLD_LBITS) * RLD_LSIZE + (z0 & (RLD_LSIZE - 1))
        cnt = [
            int(self.words[self.frame0 + fi + j])
            for j in range(1, self.asize1)
        ]
        z = sum(cnt)
        while True:
            q = p + self.ssize
            c, hdr = self._hdr_counts(q)
            if z + c > k:
                break
            for j in range(self.asize):
                cnt[j] += hdr[j]
            z += c
            p = q
        return p, cnt, z, z + c

    def _block_runs(self, shead):
        """Decode all runs of one small block."""
        type_ = int(self.words[shead]) >> 62
        p = shead + self.offset0[type_]
        r = 64
        stail = self._stail(shead)
        while True:
            dec = _dec0(self.words, p, r, stail)
            if dec is None:
                return
            c, l, p, r = dec
            yield c, l

    # --- the rld0 query surface ---

    def rank1a(self, k):
        """ok[a] = # of symbol a in B[0:k] (rld_rank1a, rld0.c:402-421)."""
        if k == 0:
            return [0] * self.asize
        shead, ok, z, _ = self._locate_blk(k - 1)
        for c, l in self._block_runs(shead):
            if z + l >= k:
                ok[c] += k - z
                return ok
            z += l
            ok[c] += l
        raise ValueError("rank past end of index")

    def rank11(self, k, c):
        if k == (1 << 64) - 1 or k == -1:
            return 0
        return self.rank1a(k)[c]

    def rank2a(self, k, l):
        """Two-point rank with the same-block shortcut of rld_rank2a
        (rld0.c:430-466)."""
        if k == 0:
            return [0] * self.asize, self.rank1a(l)
        shead, ok, z, y = self._locate_blk(k - 1)
        it = self._block_runs(shead)
        for c, ln in it:
            if z + ln >= k:
                break
            z += ln
            ok[c] += ln
        if y > l:  # l falls in the same block: keep decoding
            ol = list(ok)
            ok[c] += k - z
            if z + ln < l:
                z += ln
                ol[c] += ln
                for c, ln in it:
                    if z + ln >= l:
                        break
                    z += ln
                    ol[c] += ln
            ol[c] += l - z
            return ok, ol
        ok[c] += k - z
        return ok, self.rank1a(l)

    def rank21(self, k, l, c):
        ok, ol = self.rank2a(k, l)
        return ok[c], ol[c]

    def extend(self, ik, is_back=True):
        """One backward/forward extension of a bi-interval (x0, x1, size)
        (rld_extend, rld0.c:473-489).  Returns ok[6] of bi-intervals."""
        x0, x1, sz = ik
        p = x0 if is_back else x1
        tk, tl = self.rank2a(p, p + sz)
        size = [tl[a] - tk[a] for a in range(self.asize)]
        same = [self.cnt[a] + tk[a] for a in range(self.asize)]
        other = [0] * self.asize
        other[0] = x1 if is_back else x0
        other[4] = other[0] + size[0]
        other[3] = other[4] + size[4]
        other[2] = other[3] + size[3]
        other[1] = other[2] + size[2]
        other[5] = other[1] + size[1]
        if is_back:
            return [(same[a], other[a], size[a]) for a in range(self.asize)]
        return [(other[a], same[a], size[a]) for a in range(self.asize)]

    # --- streaming decode (rld_dec semantics) ---

    def runs_arrays(self):
        """Bulk-decode ALL runs to (sym uint8[], len int64[]) numpy arrays
        at native speed (rb2_fmd_decode: single C pass over the mapping,
        >= several hundred MB/s — the production restore path for multi-GB
        FMDs).  Falls back to the Python block decoder."""
        import numpy as np

        from ..native import lib as _nlib

        if getattr(self.words, "filename", None) is not None:
            dec = _nlib.fmd_decode(self.words.filename)
            if dec is not None:
                return dec
        syms, lens = [], []
        for c, l in self.runs():
            syms.append(c)
            lens.append(l)
        return (np.asarray(syms, np.uint8), np.asarray(lens, np.int64))

    def runs(self):
        """Stream all runs, adjacent equal-symbol runs merged (what
        rld_dec + run merging yields)."""
        last_c, last_l = -1, 0
        shead = self.data0
        end = self.data0 + ((self.n_bytes >> 3) >> self.sbits << self.sbits)
        while shead != end:
            for c, l in self._block_runs(shead):
                if c == last_c:
                    last_l += l
                else:
                    if last_l:
                        yield last_c, last_l
                    last_c, last_l = c, l
            nxt = shead + self.ssize
            if (nxt - self.data0) % RLD_LSIZE == 0:
                pass  # superblocks are contiguous in the flat mapping
            shead = nxt
        if last_l:
            yield last_c, last_l

    def to_flat(self, K=256, device=None):
        """Lift into a FlatBwt on ``device`` (None: the card) so the
        batched query API (engine/query.py) runs over a restored FMD.
        Vectorized: bulk run decode (native when available) -> np.repeat
        -> partition counts from the C(a) boundaries."""
        import numpy as np
        import torch

        from ..index.flat import (
            PAD, PAD_TAIL, FlatBwt, resolve_device, table_dtype,
        )
        from ..index.rank import build_block_tables

        device = resolve_device(device, "FmdReader.to_flat")
        syms, lens = self.runs_arrays()
        flat = np.repeat(syms.astype(np.int8), lens)
        n = flat.shape[0]
        psize = np.zeros(self.asize, np.int64)
        pcounts = np.zeros((self.asize, self.asize), np.int64)
        for b in range(self.asize):
            lo, hi = self.cnt[b], self.cnt[b + 1] if b + 1 < self.asize1 \
                else n
            seg = flat[lo:hi]
            psize[b] = seg.shape[0]
            pcounts[b] = np.bincount(seg, minlength=self.asize)[
                : self.asize
            ]
        cap = max(K, -(-n // K) * K)
        buf = np.full(cap + PAD_TAIL, PAD, np.int8)
        buf[:n] = flat
        bwt = torch.from_numpy(buf).to(device)
        return FlatBwt(
            bwt=bwt,
            n=torch.tensor(n, dtype=torch.int64, device=device),
            psize=torch.from_numpy(psize).to(device),
            pcounts=torch.from_numpy(pcounts).to(device),
            blk_prefix=build_block_tables(bwt, K, dtype=table_dtype(cap)),
        )


def dec_enc(enc: FmdEncoder, run_iter, k):
    """Take k symbols from a run stream and append them to an encoder —
    the rld_dec_enc merge helper (rld0.h:119-135).  ``run_iter`` must be a
    stateful iterator with push-back semantics provided by RunTap."""
    while k > 0:
        c, l = run_iter.next_run()
        take = min(k, l)
        enc.enc(take, c)
        if l > take:
            run_iter.push_back(c, l - take)
        k -= take


class RunTap:
    """Stateful run-stream cursor with push-back — the rlditr_t pending-run
    state (itr->c/itr->l) that rld_dec_enc manipulates."""

    def __init__(self, runs):
        self._it = iter(runs)
        self._pending = None

    def next_run(self):
        if self._pending is not None:
            p, self._pending = self._pending, None
            return p
        return next(self._it)

    def push_back(self, c, l):
        self._pending = (c, l)

    def exhausted(self):
        if self._pending is not None:
            return False
        try:
            self._pending = next(self._it)
            return False
        except StopIteration:
            return True


def merge_fmd(readers, out):
    """Interleaved merge of FMD files by symbol position is format-level
    only meaningful with a rank-based merge plan; what rld_dec_enc enables
    in fermi is stream-splicing runs between indexes.  This helper
    re-encodes a sequence of (reader-or-runs, n_symbols) slices into one
    FMD — the dec_enc workflow."""
    enc = FmdEncoder(6, 3)
    for src, k in readers:
        runs = src.runs() if isinstance(src, FmdReader) else iter(src)
        dec_enc(enc, RunTap(runs), k)
    enc.finish()
    enc.dump(out)
    return enc


def write_fmd(runs, out, log_summary=True):
    enc = FmdEncoder(6, 3)
    for c, l in runs:
        enc.enc(l, c)
    enc.finish()
    if log_summary:
        from ..utils import log

        log.message(
            "main",
            "rld: (tot, $, A, C, G, T, N) = (%d, %d, %d, %d, %d, %d, %d)",
            enc.cnt[0],
            *[enc.mcnt[i] for i in range(1, 7)],
        )
    enc.dump(out)
