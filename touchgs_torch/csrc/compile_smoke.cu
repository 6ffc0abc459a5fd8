// K4: build-and-launch check, out = x·2.
//
// Replaces bench.py::pallas_compile_smoke (:102-118, the pallas_call at
// :113), which failed fast when Mosaic could not compile a trivial kernel.
// Here it shows that nvcc built a library for sm_90a, that ctypes loads it
// and that a kernel launches and computes on the card.
//
// Bound on an H100: bytes (read x once, write out once); at the (8, 128)
// shape of the check its time is launch latency.
//
// Design: one thread per element, 256 threads a block.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
compile_smoke_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.f;
}

}  // namespace

extern "C" int compile_smoke_launch(const float* x, float* out, int n,
                                    void* stream) {
  if (n > 0) {
    compile_smoke_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}
