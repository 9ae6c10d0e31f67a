// Hopper feature probes: the card features a redesign of kernels A, B or C
// would use, each a small kernel whose result the wrapper
// (probes/kernel_features.py) holds against a plain version.
//
// Replaces: scripts/probe_kfeat_tpu.py, try_kernel (the Mosaic probes of
// int8 selects, unaligned dynamic sublane slices and dynamic rolls, each
// compiled alone and reported OK or FAIL).
//
// One source, one section per feature: _build.py compiles it once for each
// RB2_FEATURE value, so a feature this toolchain refuses fails its own unit
// only and is reported, as the script reported FAIL and went on.
//   0  the window staging of merge.cu as it is (byte loads) and with
//      16-byte loads of the aligned superset (required, not a feature);
//   1  a 1-D TMA bulk copy (cp.async.bulk + mbarrier complete_tx) of the
//      aligned superset of an unaligned 4096-byte window, shifted in
//      shared memory: the counterpart of the unaligned slice;
//   2  the same superset by cp.async 16-byte copies and wait_group;
//   3  a 4096-symbol window at any symbol offset unpacked from
//      index/packed.py's nibble planes 16 bytes at a time (masks, shifts,
//      __byte_perm), and packed back into 16 packed rows;
//   4  per-128-symbol counts of the 6 symbols with __vcmpeq4 + __popc;
//   5  a 2-CTA cluster in which each CTA reads its neighbour's shared
//      memory (cluster.map_shared_rank);
//   6  dynamic shared memory above 48 KB (cudaFuncSetAttribute).
//
// What bounds them: bytes; each moves its input once and its output once.
// The four window stagings (0, 1, 2) are timed at kernel A's flush shape:
// that timing says whether staging is what holds kernels A and C back.

#ifndef RB2_FEATURE
#error "compile with -DRB2_FEATURE=<0..6>"
#endif

#include "../common.cuh"
#include "probe.cuh"

#if RB2_FEATURE == 5
#include <cooperative_groups.h>
#endif

using namespace rb2;
using namespace rb2probe;

namespace {

#if RB2_FEATURE <= 3  // the window stagings
constexpr int SUPER_BYTES = BS + 16;  // an aligned superset of a window

// Thread t's 16 bytes of the window at offset s of the staged superset.
__device__ __forceinline__ void store_window(const uint8_t* buf, int s,
                                             int8_t* out, int64_t b) {
  *reinterpret_cast<uint4*>(out + b * BS + threadIdx.x * PER) =
      shifted16(buf, s + threadIdx.x * PER);
}

// The aligned superset [a0, a0 + bytes) of window [o0, o0 + BS), of which
// the first `inside` bytes lie in the buffer of `alloc` bytes (alloc % 16
// == 0); the rest is staged as PAD, as merge.cu stages past alloc.
struct Superset {
  int64_t a0;
  int s;
  uint32_t bytes, inside;
  __device__ Superset(int64_t o0, int64_t alloc)
      : a0(o0 & ~int64_t(15)),
        s((int)(o0 & 15)),
        bytes((uint32_t)(((o0 + BS + 15) & ~int64_t(15)) - a0)),
        inside((uint32_t)(alloc - a0 >= bytes ? bytes
                          : alloc > a0  ? alloc - a0
                                        : 0)) {}
};

constexpr uint32_t PAD4 = 0x01010101u * PAD;

// 16 PAD bytes at every chunk of buf from byte `from` (a multiple of 16)
// to `to`
__device__ __forceinline__ void pad_chunks(uint8_t* buf, uint32_t from,
                                           uint32_t to) {
  for (uint32_t i = from / 16 + threadIdx.x; i < to / 16; i += THREADS)
    reinterpret_cast<uint4*>(buf)[i] = make_uint4(PAD4, PAD4, PAD4, PAD4);
}
#endif

#if RB2_FEATURE == 0
// merge.cu:59-63 as it is: one byte load a thread per step
__global__ void __launch_bounds__(THREADS)
stage_bytes(const int8_t* __restrict__ old, const int64_t* __restrict__ o0s,
            int8_t* __restrict__ out, int64_t alloc) {
  __shared__ __align__(16) uint8_t buf[SUPER_BYTES];
  const int64_t b = blockIdx.x;
  const int64_t o0 = o0s[b];
  for (int i = threadIdx.x; i < BS; i += THREADS) {
    const int64_t q = o0 + i;
    buf[i] = q < alloc ? old[q] : PAD;
  }
  __syncthreads();
  store_window(buf, 0, out, b);
}

// 16-byte loads of the aligned superset (257 chunks at most: thread 0
// issues its second load before it stores either), then the shifted read
__global__ void __launch_bounds__(THREADS)
stage_vec16(const int8_t* __restrict__ old, const int64_t* __restrict__ o0s,
            int8_t* __restrict__ out, int64_t alloc) {
  __shared__ __align__(16) uint8_t buf[SUPER_BYTES];
  const int64_t b = blockIdx.x;
  const Superset w(o0s[b], alloc);
  const uint4* src = reinterpret_cast<const uint4*>(old + w.a0);
  const int t = threadIdx.x, n16 = (int)(w.inside / 16);
  const uint4 pad = make_uint4(PAD4, PAD4, PAD4, PAD4);
  const uint4 v0 = t < n16 ? src[t] : pad;
  const uint4 v1 = t + THREADS < n16 ? src[t + THREADS] : pad;
  reinterpret_cast<uint4*>(buf)[t] = v0;
  if (t + THREADS < SUPER_BYTES / 16) reinterpret_cast<uint4*>(buf)[t + THREADS] = v1;
  __syncthreads();
  store_window(buf, w.s, out, b);
}
#endif

#if RB2_FEATURE == 1
__global__ void __launch_bounds__(THREADS)
feat_tma(const int8_t* __restrict__ old, const int64_t* __restrict__ o0s,
         int8_t* __restrict__ out, int64_t alloc) {
  __shared__ __align__(128) uint8_t buf[SUPER_BYTES];
  __shared__ __align__(8) uint64_t bar;
  const int64_t b = blockIdx.x;
  const Superset w(o0s[b], alloc);
  const uint32_t bar_addr = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     bar_addr),
                 "r"(w.inside)
                 : "memory");
    if (w.inside > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(buf)),
          "l"(old + w.a0), "r"(w.inside), "r"(bar_addr)
          : "memory");
  }
  pad_chunks(buf, w.inside, w.bytes);  // past the buffer: not the copy's
  __syncthreads();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar_addr)
        : "memory");
  }
  store_window(buf, w.s, out, b);
}
#endif

#if RB2_FEATURE == 2
__global__ void __launch_bounds__(THREADS)
feat_cp_async(const int8_t* __restrict__ old, const int64_t* __restrict__ o0s,
              int8_t* __restrict__ out, int64_t alloc) {
  __shared__ __align__(16) uint8_t buf[SUPER_BYTES];
  const int64_t b = blockIdx.x;
  const Superset w(o0s[b], alloc);
  pad_chunks(buf, w.inside, w.bytes);
  for (int i = threadIdx.x; i < (int)(w.inside / 16); i += THREADS) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(buf + 16 * i)),
                 "l"(old + w.a0 + 16 * i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  store_window(buf, w.s, out, b);
}
#endif

#if RB2_FEATURE == 3
// packed: uint8, symbol q in byte (q >> 8) * 128 + (q & 127), low nibble
// when q >> 7 is even.  unpacked: int8[nwin * BS]; repacked: uint8[nwin *
// BS / 2], the window as 16 packed rows.
__global__ void __launch_bounds__(THREADS)
feat_nibble(const uint8_t* __restrict__ packed,
            const int64_t* __restrict__ o0s, int8_t* __restrict__ unpacked,
            uint8_t* __restrict__ repacked, int64_t cap) {
  __shared__ __align__(16) uint8_t buf[SUPER_BYTES];
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t o0 = o0s[b];
  const int64_t a0 = o0 & ~int64_t(15);
  const int s = (int)(o0 - a0);
  // 16 aligned symbols lie in one symbol row: 16 bytes of one plane
  for (int i = t; i < SUPER_BYTES / 16; i += THREADS) {
    const int64_t q = a0 + 16 * i;
    if (q + 16 > cap) {  // past the buffer: PAD, as merge_packed.cu stages
      reinterpret_cast<uint4*>(buf)[i] = make_uint4(PAD4, PAD4, PAD4, PAD4);
      continue;
    }
    const uint4 v = *reinterpret_cast<const uint4*>(
        packed + (q >> 8) * LANE + (q & (LANE - 1)));
    const int sh = (int)((q >> 7) & 1) * 4;
    uint4 u;
    u.x = (v.x >> sh) & 0x0F0F0F0Fu;
    u.y = (v.y >> sh) & 0x0F0F0F0Fu;
    u.z = (v.z >> sh) & 0x0F0F0F0Fu;
    u.w = (v.w >> sh) & 0x0F0F0F0Fu;
    reinterpret_cast<uint4*>(buf)[i] = u;
  }
  __syncthreads();
  store_window(buf, s, unpacked, b);
  // packed row r, bytes j..j+7: symbols 256 r + j (low) and + 128 (high)
  const int k = t * 8, r = k >> 7, j = k & (LANE - 1);
  const uint2 lo = shifted8(buf, s + 2 * r * LANE + j);
  const uint2 hi = shifted8(buf, s + (2 * r + 1) * LANE + j);
  *reinterpret_cast<uint2*>(repacked + b * (BS / 2) + k) =
      make_uint2(lo.x | (hi.x << 4), lo.y | (hi.y << 4));
}
#endif

#if RB2_FEATURE == 4
// sym: int8[nrows * 128]; rows: int32[nrows, 6]; nrows % 32 == 0
__global__ void __launch_bounds__(THREADS)
feat_simd_count(const int8_t* __restrict__ sym, int32_t* __restrict__ rows) {
  const int64_t row = (int64_t)blockIdx.x * (BS / LANE) + (threadIdx.x >> 3);
  const uint4 v = *reinterpret_cast<const uint4*>(
      sym + (int64_t)blockIdx.x * BS + threadIdx.x * PER);
  int cs[NSYM];
#pragma unroll
  for (int s = 0; s < NSYM; ++s) {
    const uint32_t m = 0x01010101u * (uint32_t)s;
    cs[s] = (__popc(__vcmpeq4(v.x, m)) + __popc(__vcmpeq4(v.y, m)) +
             __popc(__vcmpeq4(v.z, m)) + __popc(__vcmpeq4(v.w, m))) >> 3;
  }
  // shuffles of groups of 8 lanes; a warp holds 4 whole groups
  write_row_counts(cs, rows + row * NSYM);
}
#endif

#if RB2_FEATURE == 5
namespace cg = cooperative_groups;

// x, out: int8[nchunks * BS]; CTA pairs swap their chunks through each
// other's shared memory
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS)
feat_cluster(const int8_t* __restrict__ x, int8_t* __restrict__ out) {
  __shared__ __align__(16) int8_t buf[BS];
  cg::cluster_group cluster = cg::this_cluster();
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  reinterpret_cast<uint4*>(buf)[t] =
      *reinterpret_cast<const uint4*>(x + b * BS + t * PER);
  cluster.sync();
  const int8_t* peer = cluster.map_shared_rank(buf, cluster.block_rank() ^ 1);
  *reinterpret_cast<uint4*>(out + b * BS + t * PER) =
      reinterpret_cast<const uint4*>(peer)[t];
  cluster.sync();  // the neighbour's shared memory lives until it is read
}
#endif

#if RB2_FEATURE == 6
// x, out: int8[nctas * bytes]; each CTA reverses its chunk through one
// dynamic shared buffer of `bytes`
__global__ void __launch_bounds__(THREADS)
feat_dynsmem(const int8_t* __restrict__ x, int8_t* __restrict__ out,
             int64_t bytes) {
  extern __shared__ __align__(16) uint8_t dyn[];
  const int64_t b = blockIdx.x;
  const int n16 = (int)(bytes / 16);
  const uint4* src = reinterpret_cast<const uint4*>(x + b * bytes);
  for (int i = threadIdx.x; i < n16; i += THREADS)
    reinterpret_cast<uint4*>(dyn)[i] = src[i];
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(out + b * bytes);
  for (int i = threadIdx.x; i < n16; i += THREADS) {
    const uint4 v = reinterpret_cast<const uint4*>(dyn)[n16 - 1 - i];
    dst[i] = make_uint4(__byte_perm(v.w, 0, 0x0123), __byte_perm(v.z, 0, 0x0123),
                        __byte_perm(v.y, 0, 0x0123), __byte_perm(v.x, 0, 0x0123));
  }
}
#endif

}  // namespace

// Window stagings: old: int8[alloc], alloc % 16 == 0; o0: int64[nwin]
// window starts >= 0; out: int8[nwin * BS], PAD past alloc.
// Each returns cudaGetLastError().
#if RB2_FEATURE == 0
extern "C" int rb2_stage_bytes(const void* old, const void* o0, void* out,
                               long long nwin, long long alloc,
                               void* stream) {
  if (nwin > 0)
    stage_bytes<<<(unsigned)nwin, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)old, (const int64_t*)o0, (int8_t*)out, alloc);
  return (int)cudaGetLastError();
}

extern "C" int rb2_stage_vec16(const void* old, const void* o0, void* out,
                               long long nwin, long long alloc,
                               void* stream) {
  if (nwin > 0)
    stage_vec16<<<(unsigned)nwin, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)old, (const int64_t*)o0, (int8_t*)out, alloc);
  return (int)cudaGetLastError();
}
#elif RB2_FEATURE == 1
extern "C" int rb2_feat_tma(const void* old, const void* o0, void* out,
                            long long nwin, long long alloc, void* stream) {
  if (nwin > 0)
    feat_tma<<<(unsigned)nwin, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)old, (const int64_t*)o0, (int8_t*)out, alloc);
  return (int)cudaGetLastError();
}
#elif RB2_FEATURE == 2
extern "C" int rb2_feat_cp_async(const void* old, const void* o0, void* out,
                                 long long nwin, long long alloc,
                                 void* stream) {
  if (nwin > 0)
    feat_cp_async<<<(unsigned)nwin, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)old, (const int64_t*)o0, (int8_t*)out, alloc);
  return (int)cudaGetLastError();
}
#elif RB2_FEATURE == 3
// packed: uint8[cap / 2], cap % 256 == 0; o0: int64[nwin] symbol
// offsets; unpacked: int8[nwin * BS]; repacked: uint8[nwin * BS / 2]
extern "C" int rb2_feat_nibble(const void* packed, const void* o0,
                               void* unpacked, void* repacked, long long nwin,
                               long long cap, void* stream) {
  if (nwin > 0)
    feat_nibble<<<(unsigned)nwin, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const int64_t*)o0, (int8_t*)unpacked,
        (uint8_t*)repacked, cap);
  return (int)cudaGetLastError();
}
#elif RB2_FEATURE == 4
// sym: int8[nrows * 128] with nrows % 32 == 0; rows: int32[nrows, 6]
extern "C" int rb2_feat_simd_count(const void* sym, void* rows,
                                   long long nrows, void* stream) {
  if (nrows > 0)
    feat_simd_count<<<(unsigned)(nrows / 32), THREADS, 0,
                      (cudaStream_t)stream>>>((const int8_t*)sym,
                                              (int32_t*)rows);
  return (int)cudaGetLastError();
}
#elif RB2_FEATURE == 5
// x, out: int8[nchunks * BS], nchunks even
extern "C" int rb2_feat_cluster(const void* x, void* out, long long nchunks,
                                void* stream) {
  if (nchunks > 0)
    feat_cluster<<<(unsigned)nchunks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (int8_t*)out);
  return (int)cudaGetLastError();
}
#elif RB2_FEATURE == 6
// x, out: int8[nctas * bytes], bytes % 16 == 0
extern "C" int rb2_feat_dynsmem(const void* x, void* out, long long bytes,
                                long long nctas, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      feat_dynsmem, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (nctas > 0)
    feat_dynsmem<<<(unsigned)nctas, THREADS, (size_t)bytes,
                   (cudaStream_t)stream>>>((const int8_t*)x, (int8_t*)out,
                                           bytes);
  return (int)cudaGetLastError();
}
#endif
