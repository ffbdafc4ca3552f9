// The least device time one kernel launch costs, to read the small-ring
// NTT's times against (csrc/ntt_small.cu).
//
// A kernel of one block that does nothing, behind a plain C entry point
// with the kernel library's calling convention. It is built on its own,
// not into the library (``_build.bench_library("launch_floor")``), and
// chip_smoke.py phase 2 times it by the same CUDA-graph replay it times
// every kernel with: what a replayed launch costs when the kernel itself
// costs nothing.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One launch of one block of `threads` threads on `stream`.
extern "C" int launch_empty(int threads, cudaStream_t stream) {
  empty_kernel<<<1, threads, 0, stream>>>();
  return (int)cudaGetLastError();
}
