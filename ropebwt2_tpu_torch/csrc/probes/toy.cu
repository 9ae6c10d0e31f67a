// Toy kernel: y = x * 2 + 1 on int32, one thread an element.
//
// Replaces: scripts/probe_warmup_aot.py, build_fns.pallas_fn (the Pallas
// toy `x*2+1` on an int32 (8, 128) block, used to time a cold compile
// against loading a cached executable in a fresh process).
//
// What bounds it: nothing on the card at its (8, 128) shape: a launch.
// It exists so that probes/warmup_build.py can time nvcc, the library
// load and a fresh process's first launch without the main kernels'
// build in the way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void toy_kernel(const int32_t* __restrict__ x,
                           int32_t* __restrict__ y, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2 + 1;
}

}  // namespace

// x, y: int32[n] on the device.  Returns cudaGetLastError().
extern "C" int rb2_toy(const void* x, void* y, long long n, void* stream) {
  if (n > 0)
    toy_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (int32_t*)y, n);
  return (int)cudaGetLastError();
}
