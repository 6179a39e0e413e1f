// Class-sum vote tally for Hopper (sm_90a): fired (B, C) @ votes (C, K).
//
// Replaces the Pallas TPU kernel repro/kernels/class_sum.py:
// _class_sum_kernel (launched by class_sum), the paper's class-sum adder
// bank behind the clause chain.  out[b, k] = sum_c fired[b, c] * votes[c, k]
// in int32, computed here (no library matrix product), so it is exact and
// does not depend on the order of the adds.
//
// Bounds on the H100: B x C x K multiply-adds against B x C + C x K x 4
// bytes; at tm-mnist (K = 10) it is a few microseconds of either, so the
// design is the simplest that reads memory in order: one CUDA block per
// sample, one warp per class, the warp's lanes striding over the clause
// axis (32 consecutive fired bytes per step) and meeting in a shuffle
// reduction.  The TPU grid's sequential clause axis is the lane loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void class_sum_kernel(const int8_t* __restrict__ fired,
                                 const int32_t* __restrict__ votes,
                                 int32_t* __restrict__ out, int c_total, int k) {
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int8_t* f = fired + static_cast<size_t>(b) * c_total;
  for (int kk = warp; kk < k; kk += kWarps) {
    int32_t acc = 0;
    for (int c = lane; c < c_total; c += 32) {
      acc += static_cast<int32_t>(f[c]) * __ldg(votes + static_cast<size_t>(c) * k + kk);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[static_cast<size_t>(b) * k + kk] = acc;
  }
}

}  // namespace

extern "C" int class_sum_launch(const int8_t* fired, const int32_t* votes,
                                int32_t* out, int b_total, int c_total, int k,
                                void* stream) {
  if (b_total <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  class_sum_kernel<<<b_total, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fired, votes, out, c_total, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* class_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
