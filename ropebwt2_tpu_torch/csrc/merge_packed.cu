// Packed merge kernel: apply one BCR round's (or one pending flush's)
// insertions to the 4-bit packed BWT and emit per-plane counts of the 6
// symbols for every packed row.
//
// Replaces: ropebwt2_tpu/index/merge_pallas_packed.py, merge_pallas_packed
// -> _merge_kernel_packed/_merge_body_packed (the TPU kernel).
//
// Layout (index/packed.py): symbol p lives in byte (p >> 8) * 128 +
// (p & 127), low nibble when symbol row p >> 7 is even, high when odd.  So
// the 4096 output symbols [4096 b, 4096 b + 4096) of one CTA are exactly
// the 2048 bytes of packed rows [16 b, 16 b + 16).
//
// What it computes: the same merge as merge.cu.  Output position p takes
// the insertion nibble minus 1 where the packed insertion map has one,
// else old[p - c(p)], with c(p) the number of destinations <= p.  CTAs
// wholly past the live prefix n + #ins write zero counts and return.
//
// What bounds it on the card: bytes by the model (0.5 B of old data and
// 0.5 B of insertion map read and 0.5 B written per live symbol, 48 B of
// counts per 256 symbols: about 1.7 B per symbol).  In fact, at so few
// bytes a symbol, two other things set the pace: whatever a thread does
// once per symbol (a byte load, a compare and an add per symbol and
// letter), and the chain of dependent loads of a CTA (start[b], then the
// window it points at), which 2048 resident threads an SM cannot hide.
//
// What the design does about it: one pass, one CTA per 4096-symbol output
// block, as in merge.cu; the block's insertion prefix start[b] comes from
// outside, so its old symbols are the contiguous run from o0 = p0 -
// start[b].  Everything per symbol is done 16 symbols at a time:
// - Stage packed, unpack wide.  The run lies in at most 17 packed rows;
//   the CTA reads them as 136 16-byte loads (each packed byte once),
//   splits the planes in registers (& 0x0F0F0F0F, >> 4) and writes both as
//   16-byte stores into a symbol-linear window in shared memory.
// - Each thread owns 16 consecutive outputs of one symbol row.  Its
//   insertion nibbles are four words of one 16-byte load; their number is
//   an add, a mask and a __popc a word, and a CTA-wide scan gives the
//   thread's shift.
// - Loads before uses.  A live CTA starts its map load and its window load
//   back to back and counts the map while the window is on its way; a CTA
//   past the live prefix reads neither.  On an NVIDIA H100 80GB HBM3 at
//   700 W, at cap 2,246,049,792 with 6 * 2^20 insertions: 1.96 ms so,
//   2.19 ms with the window staged before the map is loaded.  (Skipping
//   map and scan in a CTA that start[b + 1] == start[b] shows to have no
//   insertion made the map load wait for start: 2.29 ms.)
// - A thread with no insertion among its outputs (19 in 20 at a capacity
//   flush) copies the 16 window bytes at its shift: five aligned words
//   and four __byte_perm.  A thread with insertions walks its 16 symbols.
// - Bit-sliced counts (common.cuh, count16_packed): the 16 output symbols
//   fold into two words of nibbles, a letter's 16 match flags are one
//   logic operation on four bit planes and its count one __popc; the six
//   counts ride in two words through a 6-shuffle reduction over the 8
//   lanes of a row, and a warp's four count rows leave as one 96-byte
//   store.
// - The thread holding the high plane of a byte hands its 16 symbols to
//   the thread holding the low plane (8 lanes below), which stores the 16
//   packed bytes as one 16-byte store.
// None of the TPU kernel's machinery (log-shift ladder, plane-algebra
// rotates, 2048-symbol window alignment, MXU counts, double buffering) is
// needed: it exists because Mosaic has no gather.

#include "common.cuh"

using namespace rb2;

namespace {

constexpr int PROW = 2 * LANE;           // symbols of one packed row
constexpr int WIN_ROWS = BS / PROW + 1;  // packed rows a window can span
constexpr int WIN = WIN_ROWS * PROW;     // 4352 staged symbols
constexpr uint32_t NIB = 0x0F0F0F0Fu;
constexpr uint32_t PAD_BOTH = PAD_WORD | PAD_WORD << 4;  // PAD in both planes

__global__ void __launch_bounds__(THREADS)
merge_packed_kernel(const uint8_t* __restrict__ old,
                    const uint8_t* __restrict__ insmap,
                    const int64_t* __restrict__ start,
                    const int64_t* __restrict__ n_ptr,
                    uint8_t* __restrict__ out, int32_t* __restrict__ rows,
                    int64_t alloc_bytes, int64_t nb) {
  __shared__ __align__(16) uint8_t win[WIN + 16];
  __shared__ int warp_tot[WARPS];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t p0 = b * BS;
  int32_t* cta_rows = rows + b * (BS / LANE) * NSYM;

  const int64_t ins0 = start[b];
  if (p0 >= *n_ptr + start[nb]) {  // wholly past the live prefix
    if (t < BS / LANE * NSYM) cta_rows[t] = 0;
    return;
  }

  // 16 outputs of one plane of one packed row: 16 contiguous map bytes
  // (p0 / 128 is even, so the plane is the thread's own).  This load and
  // the window's below go out together, before either is used.
  const int hi_plane = (t >> 3) & 1;
  const int64_t ob = (b * (BS / PROW) + (t >> 4)) * LANE + (t & 7) * 16;
  const uint4 iv = *reinterpret_cast<const uint4*>(insmap + ob);

  // this block's old symbols are the contiguous run starting at o0: the
  // packed rows that hold it, loaded while the map is counted
  const int64_t o0 = p0 - ins0;
  const int64_t r0 = o0 >> 8;
  const int64_t wb = (r0 + (t >> 3)) * LANE + (t & 7) * 16;
  // alloc_bytes % 16 == 0: a chunk is wholly in the buffer or out of it
  const bool staged = t < WIN_ROWS * (LANE / 16) && wb + 16 <= alloc_bytes;
  uint4 ov = make_uint4(PAD_BOTH, PAD_BOTH, PAD_BOTH, PAD_BOTH);
  if (staged) ov = *reinterpret_cast<const uint4*>(old + wb);

  const int sh = hi_plane * 4;
  const uint32_t nib[4] = {(iv.x >> sh) & NIB, (iv.y >> sh) & NIB,
                           (iv.z >> sh) & NIB, (iv.w >> sh) & NIB};
  const int k = nonzero_bytes(nib[0]) + nonzero_bytes(nib[1]) +
                nonzero_bytes(nib[2]) + nonzero_bytes(nib[3]);

  // the planes split in registers, symbol-linear from the first row's start
  if (t < WIN_ROWS * (LANE / 16)) {
    uint8_t* dst = win + (t >> 3) * PROW + (t & 7) * 16;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(ov.x & NIB, ov.y & NIB, ov.z & NIB, ov.w & NIB);
    *reinterpret_cast<uint4*>(dst + LANE) =
        make_uint4((ov.x >> 4) & NIB, (ov.y >> 4) & NIB, (ov.z >> 4) & NIB,
                   (ov.w >> 4) & NIB);
  }
  // insertions before this thread's first position (also the barrier that
  // publishes the staged window)
  const int c = block_exclusive_scan(k, warp_tot);

  const int off = (int)(o0 - r0 * PROW) + t * PER - c;  // first source symbol
  uint4 o;
  if (k == 0) {
    o = window16(win, off);
  } else {
    uint32_t ow[4];
    int src = off;
#pragma unroll
    for (int wd = 0; wd < 4; ++wd) {
      uint32_t acc = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t nb4 = (nib[wd] >> (8 * j)) & 0xFu;
        const uint32_t v = nb4 ? nb4 - 1 : win[src];
        src += nb4 ? 0 : 1;
        acc |= v << (8 * j);
      }
      ow[wd] = acc;
    }
    o = make_uint4(ow[0], ow[1], ow[2], ow[3]);
  }

  uint32_t ca, cb;
  count16_packed(o, ca, cb);
  write_row_counts_packed(ca, cb, cta_rows + (t >> 3) * NSYM);

  // the high-plane thread of each byte run is 8 lanes above its low one
  o.x |= __shfl_down_sync(0xffffffffu, o.x, 8) << 4;  // nibbles are < 16:
  o.y |= __shfl_down_sync(0xffffffffu, o.y, 8) << 4;  // no carry across
  o.z |= __shfl_down_sync(0xffffffffu, o.z, 8) << 4;  // bytes
  o.w |= __shfl_down_sync(0xffffffffu, o.w, 8) << 4;
  if (!hi_plane && ob + PER <= alloc_bytes)
    *reinterpret_cast<uint4*>(out + ob) = o;
}

}  // namespace

// old: uint8[alloc_bytes] packed; insmap: uint8[nb*2048] packed insertion
// nibbles (sym+1 at destinations, else 0); start: int64[nb+1] exclusive
// per-block insertion prefix; n: int64 scalar on the device; out:
// uint8[alloc_bytes]; rows: int32[nb*32, 6], one row per 128-symbol row
// (packed row r's low plane is row 2r, its high plane row 2r+1).
// alloc_bytes % 128 == 0; old, insmap and out 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int rb2_merge_packed(const void* old, const void* insmap,
                                const void* start, const void* n, void* out,
                                void* rows, long long alloc_bytes,
                                long long nb, void* stream) {
  if (nb > 0) {
    merge_packed_kernel<<<(unsigned)nb, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)old, (const uint8_t*)insmap, (const int64_t*)start,
        (const int64_t*)n, (uint8_t*)out, (int32_t*)rows, alloc_bytes, nb);
  }
  return (int)cudaGetLastError();
}
