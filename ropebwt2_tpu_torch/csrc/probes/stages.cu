// Kernel A's stages alone: each stage of csrc/merge.cu as a kernel that
// loops it `iters` times on its CTA's data.
//
// Replaces: scripts/probe_kernel_stages.py, mk (the Pallas probe that
// looped kernel A's TPU stages stack+align, segprefix, expand and counts
// ITERS times on VMEM-resident data).
//
// The four stages, as they stand in merge.cu:
//   (a) window: staging the CTA's old window in shared memory as the 257
//       aligned 16-byte chunks that cover it, read back at offset o0 & 15,
//       the counterpart of stack+align;
//   (b) scan: the 16-byte insertion-map load, the count of its nonzero
//       bytes and the CTA-wide block_exclusive_scan, the counterpart of
//       segprefix;
//   (c) gather: a thread without insertions copies 16 window bytes at its
//       shift (window16), one with insertions walks its 16 symbols; then
//       the 16-byte store, the counterpart of expand;
//   (d) counts: count16_packed, the 8-lane sum of a row and one warp's
//       scan of the CTA's 32 rows, written as the CTA's int32 row prefix,
//       the counterpart of counts.
// The look-back across CTAs that follows (d) in merge.cu cannot be looped
// inside one CTA; its cost shows in kernel A's time against its bound.
//
// Each pass perturbs its input by one bit of an accumulator that every
// pass feeds (the TPU probe's `acc` trick), so no pass can be hoisted out
// of the loop or merged with the next; the last pass runs unperturbed and
// writes its result, which the wrapper holds against the plain version.
// Stores that belong to a stage (c, d) go to one of two scratch slots on
// every pass but the last, so none is dropped as overwritten.
//
// What bounds it: the loop runs on data that one pass has brought into L1
// and shared memory, so a pass is bound by the bytes it moves through L1
// and shared memory (probes/_timing.py::stage_bound_ms), and its time is
// also set against the HBM time of the bytes the stage moves in kernel A
// (probes/_timing.py::stage_bytes).

#include "../common.cuh"

using namespace rb2;

namespace {

constexpr int CHUNKS = BS / 16 + 2;  // a window at any alignment, + 1 byte
constexpr uint32_t FULL = 0xffffffffu;

__device__ __forceinline__ int perturb(int it, int iters, int acc) {
  return it + 1 < iters ? (acc & 1) : 0;
}

// the aligned 16-byte chunks of old that cover [o0, o0 + 4096 + 17) into
// win (PAD past alloc), as merge.cu stages them; alloc % 16 == 0
__device__ __forceinline__ void stage16(const uint8_t* __restrict__ old,
                                        int64_t o0, int64_t alloc,
                                        uint8_t* win) {
  const int64_t c0 = o0 & ~int64_t(15);
  for (int i = threadIdx.x; i < CHUNKS; i += THREADS) {
    const int64_t q = c0 + 16 * i;
    uint4 w = make_uint4(PAD_WORD, PAD_WORD, PAD_WORD, PAD_WORD);
    if (q + 16 <= alloc) w = *reinterpret_cast<const uint4*>(old + q);
    *reinterpret_cast<uint4*>(win + 16 * i) = w;
  }
}

// (a) old: int8[alloc]; o0: int64[grid] window starts; out: int8[grid*BS]
__global__ void __launch_bounds__(THREADS)
stage_window(const uint8_t* __restrict__ old, const int64_t* __restrict__ o0s,
             uint8_t* __restrict__ out, int* __restrict__ acc_out,
             int64_t alloc, int iters) {
  // two: one barrier a pass
  __shared__ __align__(16) uint8_t win[2][CHUNKS * 16];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  int acc = 0;
  int64_t o0 = o0s[b];
  uint8_t* w = win[0];
  for (int it = 0; it < iters; ++it) {
    w = win[it & 1];
    o0 = o0s[b] + perturb(it, iters, acc);
    stage16(old, o0, alloc, w);
    __syncthreads();
    acc += w[(o0 & 15) + ((t * 17 + it) & (BS - 1))];
  }
  *reinterpret_cast<uint4*>(out + b * BS + t * PER) =
      window16(w, (int)(o0 & 15) + t * PER);
  acc_out[b * THREADS + t] = acc;
}

// (b) insmap: int8[grid*BS + PER]; out: int32[grid*BS], the inclusive
// per-CTA prefix of the insertion flags
__global__ void __launch_bounds__(THREADS)
stage_scan(const uint8_t* __restrict__ insmap, int32_t* __restrict__ out,
           int* __restrict__ acc_out, int iters) {
  __shared__ int warp_tot[2][WARPS];  // two: back-to-back scans
  const int t = threadIdx.x;
  const int64_t pt = (int64_t)blockIdx.x * BS + (int64_t)t * PER;
  int acc = 0, c = 0;
  uint4 iv;
  for (int it = 0; it < iters; ++it) {
    iv = *reinterpret_cast<const uint4*>(
        insmap + pt + PER * perturb(it, iters, acc));
    const int k = nonzero_bytes(iv.x) + nonzero_bytes(iv.y) +
                  nonzero_bytes(iv.z) + nonzero_bytes(iv.w);
    c = block_exclusive_scan(k, warp_tot[it & 1]);
    acc += c;
  }
  const uint32_t iw[4] = {iv.x, iv.y, iv.z, iv.w};
#pragma unroll
  for (int wd = 0; wd < 4; ++wd) {
    int4 r;
    r.x = (c += (iw[wd] & 0xFFu) != 0);
    r.y = (c += (iw[wd] >> 8 & 0xFFu) != 0);
    r.z = (c += (iw[wd] >> 16 & 0xFFu) != 0);
    r.w = (c += (iw[wd] >> 24) != 0);
    *reinterpret_cast<int4*>(out + pt + 4 * wd) = r;
  }
  acc_out[blockIdx.x * THREADS + t] = acc;
}

// (c) the window and the scan once, then the gather looped.  out:
// int8[3 * grid*BS], slot 0 the result, slots 1 and 2 scratch
__global__ void __launch_bounds__(THREADS)
stage_gather(const uint8_t* __restrict__ old,
             const int64_t* __restrict__ o0s,
             const uint8_t* __restrict__ insmap, uint8_t* __restrict__ out,
             int* __restrict__ acc_out, int64_t alloc, int64_t slot,
             int iters) {
  __shared__ __align__(16) uint8_t win[CHUNKS * 16];
  __shared__ int warp_tot[WARPS];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t o0 = o0s[b];
  stage16(old, o0, alloc, win);
  const int64_t pt = b * BS + (int64_t)t * PER;
  const uint4 iv = *reinterpret_cast<const uint4*>(insmap + pt);
  const int k = nonzero_bytes(iv.x) + nonzero_bytes(iv.y) +
                nonzero_bytes(iv.z) + nonzero_bytes(iv.w);
  const int c0 = block_exclusive_scan(k, warp_tot);

  int acc = 0;
  for (int it = 0; it < iters; ++it) {
    const int d = perturb(it, iters, acc);
    // d: reads one symbol later, still inside win
    const int off = (int)(o0 & 15) + t * PER - c0 + d;
    uint4 o;
    if (k == 0) {
      o = window16(win, off);
    } else {
      const uint32_t iw[4] = {iv.x, iv.y, iv.z, iv.w};
      uint32_t ow[4];
      int src = off;
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        uint32_t a = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t ib = (iw[wd] >> (8 * j)) & 0xFFu;
          const uint32_t v = ib ? ib - 1 : win[src];
          src += ib ? 0 : 1;
          a |= v << (8 * j);
        }
        ow[wd] = a;
      }
      o = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    }
    const int64_t s = d ? 1 + (it & 1) : 0;
    *reinterpret_cast<uint4*>(out + s * slot + pt) = o;
    acc += (int)(o.x ^ o.w) & 0xff;
  }
  acc_out[b * THREADS + t] = acc;
}

// (d) sym: int8[grid*BS], every byte < 15; rows: int32[3 * grid*32, 6],
// slot 0 the result: the inclusive prefix of the counts over the CTA's 32
// rows
__global__ void __launch_bounds__(THREADS)
stage_counts(const uint8_t* __restrict__ sym, int32_t* __restrict__ rows,
             int* __restrict__ acc_out, int64_t slot, int iters) {
  __shared__ uint2 row_cnt[BS / LANE];
  __shared__ uint32_t row_pre[BS / LANE][3];
  const int t = threadIdx.x, lane = t & 31;
  const int64_t b = blockIdx.x;
  const uint4 v = *reinterpret_cast<const uint4*>(sym + b * BS +
                                                  (int64_t)t * PER);
  int acc = 0;
  for (int it = 0; it < iters; ++it) {
    const uint32_t d = 0x01010101u * perturb(it, iters, acc);
    uint32_t ca, cb;
    count16_packed(make_uint4(v.x + d, v.y + d, v.z + d, v.w + d), ca, cb);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      ca += __shfl_xor_sync(FULL, ca, o);
      cb += __shfl_xor_sync(FULL, cb, o);
    }
    if ((t & 7) == 0) row_cnt[t >> 3] = make_uint2(ca, cb);
    __syncthreads();
    if (t < 32) {
      const uint2 r = row_cnt[lane];
      uint32_t f[3] = {(r.x & 0xFFu) | (r.x & 0xFF00u) << 8,
                       (r.x >> 16 & 0xFFu) | (r.y & 0xFFu) << 16,
                       (r.y >> 8 & 0xFFu) | (r.y & 0xFF0000u)};
#pragma unroll
      for (int dd = 1; dd < 32; dd <<= 1) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const uint32_t y = __shfl_up_sync(FULL, f[i], dd);
          if (lane >= dd) f[i] += y;
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) row_pre[lane][i] = f[i];
    }
    __syncthreads();
    if (t < (BS / LANE) * NSYM) {
      const int r = t / NSYM, s = t % NSYM;
      const int32_t x = (row_pre[r][s >> 1] >> (16 * (s & 1))) & 0xFFFF;
      const int64_t sl = d ? 1 + (it & 1) : 0;
      rows[(sl * slot + b * (BS / LANE)) * NSYM + t] = x;
    }
    acc += (int)row_pre[t >> 3][0];
  }
  acc_out[b * THREADS + t] = acc;
}

}  // namespace

// Every entry point: grid CTAs of THREADS threads, acc: int32[grid*THREADS]
// (written so that no pass is dead code).  Returns cudaGetLastError().
extern "C" int rb2_stage_window(const void* old, const void* o0, void* out,
                                void* acc, long long alloc, long long iters,
                                long long grid, void* stream) {
  if (grid > 0 && iters > 0)
    stage_window<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)old, (const int64_t*)o0, (uint8_t*)out, (int*)acc,
        alloc, (int)iters);
  return (int)cudaGetLastError();
}

extern "C" int rb2_stage_scan(const void* insmap, void* out, void* acc,
                              long long iters, long long grid, void* stream) {
  if (grid > 0 && iters > 0)
    stage_scan<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)insmap, (int32_t*)out, (int*)acc, (int)iters);
  return (int)cudaGetLastError();
}

extern "C" int rb2_stage_gather(const void* old, const void* o0,
                                const void* insmap, void* out, void* acc,
                                long long alloc, long long slot,
                                long long iters, long long grid,
                                void* stream) {
  if (grid > 0 && iters > 0)
    stage_gather<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)old, (const int64_t*)o0, (const uint8_t*)insmap,
        (uint8_t*)out, (int*)acc, alloc, slot, (int)iters);
  return (int)cudaGetLastError();
}

extern "C" int rb2_stage_counts(const void* sym, void* rows, void* acc,
                                long long slot, long long iters,
                                long long grid, void* stream) {
  if (grid > 0 && iters > 0)
    stage_counts<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)sym, (int32_t*)rows, (int*)acc, slot, (int)iters);
  return (int)cudaGetLastError();
}
