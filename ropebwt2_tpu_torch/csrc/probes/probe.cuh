// Shared pieces of the feature probes: shared-memory addresses for PTX and
// an unaligned 16-byte read from shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rb2probe {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 16 bytes at byte offset `off` (any alignment) of a 16-byte-aligned
// shared buffer: five aligned words funnel-shifted with __byte_perm.  The
// buffer must hold 4 readable bytes past off + 16 rounded down to a word.
__device__ __forceinline__ uint4 shifted16(const uint8_t* buf, int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf) + (off >> 2);
  const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)(off & 3);
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
  return make_uint4(__byte_perm(w0, w1, sel), __byte_perm(w1, w2, sel),
                    __byte_perm(w2, w3, sel), __byte_perm(w3, w4, sel));
}

// The 8 bytes at byte offset `off` (any alignment), as shifted16.
__device__ __forceinline__ uint2 shifted8(const uint8_t* buf, int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf) + (off >> 2);
  const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)(off & 3);
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  return make_uint2(__byte_perm(w0, w1, sel), __byte_perm(w1, w2, sel));
}

}  // namespace rb2probe
