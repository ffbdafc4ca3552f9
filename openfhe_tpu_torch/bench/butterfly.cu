// Dispatch cost of the NTT's lazy butterflies on one GPU, away from memory.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -o butterfly butterfly.cu && ./butterfly
//
// Every thread holds 16 residues and 8 twiddle pairs in registers and runs
// radix-16 rounds on them (four stages of eight butterflies, as a round of
// ntt.cu does) with no memory traffic. With six blocks of four warps on
// every SM, the time of a launch over the butterflies each SM partition
// ran is the partition's clocks per warp-wide butterfly: the integer
// pipe's real floor for the kernel, to set beside the operation count of its
// bound. Prints one line per variant: name, milliseconds, clocks. The clock
// is the device's rated SM clock (cudaDevAttrClockRate); a card held below
// it by its power limit reads high.
#include <cstdio>
#include <cuda_runtime.h>

#include "../csrc/modarith.cuh"

namespace {

constexpr int kThreads = 128, kBlocksPerSm = 6, kRounds = 2000;

template <int V>
__device__ __forceinline__ void butterfly(u64& x, u64& y, u64 w, u64 wp, u64 q,
                                          u64 q2) {
  if (V == 0) ct_lazy(x, y, w, wp, q, q2);
  if (V == 1) gs_lazy(x, y, w, wp, q, q2);
  if (V == 2) {  // the Shoup product alone, kept live by one addition
    y = mul_shoup_lazy(y, w, wp, q);
    x += y;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
rounds(u64* out, const u64* tw, u64 q, int n_rounds) {
  u64 v[16], w[8], wp[8];
  const u64 q2 = 2 * q;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = (threadIdx.x * 977u + i * 131u + blockIdx.x) % q;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = tw[2 * i];
    wp[i] = tw[2 * i + 1];
  }
  for (int r = 0; r < n_rounds; ++r) {
#pragma unroll
    for (int lam = 3; lam >= 0; --lam) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int f = ((j >> lam) << (lam + 1)) | (j & ((1 << lam) - 1));
        butterfly<V>(v[f], v[f | (1 << lam)], w[j >> lam], wp[j >> lam], q, q2);
      }
    }
  }
  u64 s = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += v[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int V>
int run(const char* name, const u64* tw, u64 q, int sms, double clock_hz) {
  const int blocks = sms * kBlocksPerSm;
  u64* out;
  if (cudaMalloc(&out, (size_t)blocks * kThreads * sizeof(u64))) return 1;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  rounds<V><<<blocks, kThreads>>>(out, tw, q, 16);  // warm-up
  cudaEventRecord(e0);
  rounds<V><<<blocks, kThreads>>>(out, tw, q, kRounds);
  cudaEventRecord(e1);
  if (cudaEventSynchronize(e1) != cudaSuccess || cudaGetLastError()) return 1;
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  // warps per partition (4 to an SM) x rounds x 32 butterflies a round
  const double done = kBlocksPerSm * (kThreads / 32) / 4.0 * kRounds * 32.0;
  printf("%s %.4f ms %.2f clocks\n", name, ms, ms * 1e-3 * clock_hz / done);
  cudaFree(out);
  return 0;
}

}  // namespace

int main() {
  const u64 q = 1152921504606584833ull;  // a 60-bit NTT prime
  u64 h[16];
  for (int i = 0; i < 8; ++i) {
    h[2 * i] = (q / 3 + 12345ull * i) % q;
    h[2 * i + 1] = (u64)(((unsigned __int128)h[2 * i] << 64) / q);
  }
  int sms = 0, khz = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) ||
      cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0))
    return 1;
  u64* tw;
  if (cudaMalloc(&tw, sizeof(h)) ||
      cudaMemcpy(tw, h, sizeof(h), cudaMemcpyHostToDevice))
    return 1;
  const double hz = 1e3 * khz;
  return run<0>("ct_lazy", tw, q, sms, hz) | run<1>("gs_lazy", tw, q, sms, hz) |
         run<2>("mul_shoup_lazy", tw, q, sms, hz);
}
