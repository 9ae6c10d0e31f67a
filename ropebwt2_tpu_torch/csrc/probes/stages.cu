// Kernel A's stages alone: each stage of csrc/merge.cu as a kernel that
// loops it `iters` times on its CTA's data.
//
// Replaces: scripts/probe_kernel_stages.py, mk (the Pallas probe that
// looped kernel A's TPU stages stack+align, segprefix, expand and counts
// ITERS times on VMEM-resident data).
//
// The four stages, as they stand in merge.cu:
//   (a) window: staging the CTA's old window in shared memory with byte
//       loads (merge.cu:59-63), the counterpart of stack+align;
//   (b) scan: the 16-byte insertion-map load, the flag count and the
//       CTA-wide block_exclusive_scan (merge.cu:65-73), the counterpart of
//       segprefix;
//   (c) gather: the per-thread gather from the staged window and the
//       16-byte store (merge.cu:75-90), the counterpart of expand;
//   (d) counts: the per-symbol compares and write_row_counts
//       (merge.cu:88-91), the counterpart of counts.
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

union Chunk {
  uint4 v;
  int8_t b[PER];
};

__device__ __forceinline__ int perturb(int it, int iters, int acc) {
  return it + 1 < iters ? (acc & 1) : 0;
}

// (a) old: int8[alloc]; o0: int64[grid] window starts; out: int8[grid*BS]
__global__ void __launch_bounds__(THREADS)
stage_window(const int8_t* __restrict__ old, const int64_t* __restrict__ o0s,
             int8_t* __restrict__ out, int* __restrict__ acc_out,
             int64_t alloc, int iters) {
  __shared__ __align__(16) int8_t win[2][BS];  // two: one barrier a pass
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  int acc = 0;
  int8_t* w = win[0];
  for (int it = 0; it < iters; ++it) {
    w = win[it & 1];
    const int64_t o0 = o0s[b] + perturb(it, iters, acc);
    for (int i = t; i < BS; i += THREADS) {
      const int64_t q = o0 + i;
      w[i] = q < alloc ? old[q] : PAD;
    }
    __syncthreads();
    acc += w[(t * 17 + it) & (BS - 1)];
  }
  *reinterpret_cast<uint4*>(out + b * BS + t * PER) =
      *reinterpret_cast<const uint4*>(w + t * PER);
  acc_out[b * THREADS + t] = acc;
}

// (b) insmap: int8[grid*BS + PER]; out: int32[grid*BS], the inclusive
// per-CTA prefix of the insertion flags
__global__ void __launch_bounds__(THREADS)
stage_scan(const int8_t* __restrict__ insmap, int32_t* __restrict__ out,
           int* __restrict__ acc_out, int iters) {
  __shared__ int warp_tot[2][WARPS];  // two: back-to-back scans
  const int t = threadIdx.x;
  const int64_t pt = (int64_t)blockIdx.x * BS + (int64_t)t * PER;
  int acc = 0, c = 0;
  Chunk ins;
  for (int it = 0; it < iters; ++it) {
    ins.v = *reinterpret_cast<const uint4*>(
        insmap + pt + PER * perturb(it, iters, acc));
    int k = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) k += ins.b[j] != 0;
    c = block_exclusive_scan(k, warp_tot[it & 1]);
    acc += c;
  }
#pragma unroll
  for (int j = 0; j < PER; j += 4) {
    int4 r;
    r.x = (c += ins.b[j] != 0);
    r.y = (c += ins.b[j + 1] != 0);
    r.z = (c += ins.b[j + 2] != 0);
    r.w = (c += ins.b[j + 3] != 0);
    *reinterpret_cast<int4*>(out + pt + j) = r;
  }
  acc_out[blockIdx.x * THREADS + t] = acc;
}

// (c) the window and the scan once, then the gather looped.  out:
// int8[3 * grid*BS], slot 0 the result, slots 1 and 2 scratch
__global__ void __launch_bounds__(THREADS)
stage_gather(const int8_t* __restrict__ old, const int64_t* __restrict__ o0s,
             const int8_t* __restrict__ insmap, int8_t* __restrict__ out,
             int* __restrict__ acc_out, int64_t alloc, int64_t slot,
             int iters) {
  __shared__ __align__(16) int8_t win[BS + PER];  // + PER: perturbed reads
  __shared__ int warp_tot[WARPS];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t o0 = o0s[b];
  for (int i = t; i < BS + PER; i += THREADS) {
    const int64_t q = o0 + i;
    win[i] = q < alloc ? old[q] : PAD;
  }
  const int64_t pt = b * BS + (int64_t)t * PER;
  Chunk ins;
  ins.v = *reinterpret_cast<const uint4*>(insmap + pt);
  int k = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) k += ins.b[j] != 0;
  const int c0 = block_exclusive_scan(k, warp_tot);

  int acc = 0;
  for (int it = 0; it < iters; ++it) {
    const int d = perturb(it, iters, acc);
    int c = c0 - d;  // reads one symbol later: still inside win
    Chunk o;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int8_t v;
      if (ins.b[j]) {
        v = ins.b[j] - 1;
        ++c;
      } else {
        v = win[t * PER + j - c];
      }
      o.b[j] = v;
    }
    const int64_t s = d ? 1 + (it & 1) : 0;
    *reinterpret_cast<uint4*>(out + s * slot + pt) = o.v;
    acc += (int)(o.v.x ^ o.v.w) & 0xff;
  }
  acc_out[b * THREADS + t] = acc;
}

// (d) sym: int8[grid*BS]; rows: int32[3 * grid*32, 6], slot 0 the result
__global__ void __launch_bounds__(THREADS)
stage_counts(const int8_t* __restrict__ sym, int32_t* __restrict__ rows,
             int* __restrict__ acc_out, int64_t slot, int iters) {
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  Chunk o;
  o.v = *reinterpret_cast<const uint4*>(sym + b * BS + (int64_t)t * PER);
  int acc = 0;
  for (int it = 0; it < iters; ++it) {
    const int d = perturb(it, iters, acc);
    int cs[NSYM] = {0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int v = o.b[j] + d;
#pragma unroll
      for (int s = 0; s < NSYM; ++s) cs[s] += v == s;
    }
    const int64_t s = d ? 1 + (it & 1) : 0;
    write_row_counts(cs, rows + s * slot * NSYM +
                             (b * (BS / LANE) + (t >> 3)) * NSYM);
    acc += cs[0];
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
        (const int8_t*)old, (const int64_t*)o0, (int8_t*)out, (int*)acc,
        alloc, (int)iters);
  return (int)cudaGetLastError();
}

extern "C" int rb2_stage_scan(const void* insmap, void* out, void* acc,
                              long long iters, long long grid, void* stream) {
  if (grid > 0 && iters > 0)
    stage_scan<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)insmap, (int32_t*)out, (int*)acc, (int)iters);
  return (int)cudaGetLastError();
}

extern "C" int rb2_stage_gather(const void* old, const void* o0,
                                const void* insmap, void* out, void* acc,
                                long long alloc, long long slot,
                                long long iters, long long grid,
                                void* stream) {
  if (grid > 0 && iters > 0)
    stage_gather<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)old, (const int64_t*)o0, (const int8_t*)insmap,
        (int8_t*)out, (int*)acc, alloc, slot, (int)iters);
  return (int)cudaGetLastError();
}

extern "C" int rb2_stage_counts(const void* sym, void* rows, void* acc,
                                long long slot, long long iters,
                                long long grid, void* stream) {
  if (grid > 0 && iters > 0)
    stage_counts<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)sym, (int32_t*)rows, (int*)acc, slot, (int)iters);
  return (int)cudaGetLastError();
}
