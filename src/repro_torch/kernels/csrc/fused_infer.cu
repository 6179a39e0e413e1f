// Dense fused TM inference for Hopper (sm_90a): clause chain + vote fold.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_infer.py:
// _fused_infer_kernel (launched by fused_tm_forward).  For every (sample,
// clause) pair it ANDs the chain `(inc & ~lit) == 0` over all packed words,
// masks empty clauses with `nonempty`, and folds fired @ votes into int32
// class sums without writing the fired matrix to device memory.
//
// Bounds on the H100: B x C x W word operations (1 AND-NOT + OR each) with
// a few hundred KB of operands, so it is bound by integer issue rate, not
// by memory.  The design stages a 32-sample x 32-word literal tile and a
// 64-clause x 32-word include tile in shared memory (padded rows: no bank
// conflicts) and gives each thread 8 (sample, clause) pairs.  The TPU
// grid's sequential clause axis, which carries the class-sum block across
// steps, becomes independent CUDA blocks whose partial sums meet in `out`
// (zeroed by the caller) through int32 atomics; integer adds commute, so
// the result is exact and order-free.  The fold is computed here, with no
// library matrix product.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBB = 32;                  // samples per CUDA block
constexpr int kBC = 64;                  // clauses per CUDA block
constexpr int kWC = 32;                  // words per shared-memory chunk
constexpr int kThreads = 256;
constexpr int kPairs = kBB * kBC / kThreads;

__global__ void fused_infer_kernel(
    const uint32_t* __restrict__ lit, const uint32_t* __restrict__ inc,
    const int32_t* __restrict__ votes, const int32_t* __restrict__ nonempty,
    int32_t* __restrict__ out, int b_total, int c_total, int w_total, int k) {
  __shared__ uint32_t lit_s[kBB][kWC + 1];
  __shared__ uint32_t inc_s[kBC][kWC + 1];
  __shared__ uint8_t fired_s[kBC][kBB];
  const int b0 = blockIdx.x * kBB;
  const int c0 = blockIdx.y * kBC;
  const int tid = threadIdx.x;

  bool ok[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) ok[q] = true;

  for (int w0 = 0; w0 < w_total; w0 += kWC) {
    const int wn = min(kWC, w_total - w0);
    for (int i = tid; i < kBB * kWC; i += kThreads) {
      const int b = i / kWC, w = i % kWC;
      lit_s[b][w] = (b0 + b < b_total && w < wn)
          ? lit[static_cast<size_t>(b0 + b) * w_total + w0 + w] : 0u;
    }
    for (int i = tid; i < kBC * kWC; i += kThreads) {
      const int c = i / kWC, w = i % kWC;
      inc_s[c][w] = (c0 + c < c_total && w < wn)
          ? inc[static_cast<size_t>(c0 + c) * w_total + w0 + w] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int p = tid + q * kThreads;
      const int b = p % kBB, c = p / kBB;    // a warp: 32 samples, 1 clause
      uint32_t viol = 0u;
      for (int w = 0; w < wn; ++w) viol |= inc_s[c][w] & ~lit_s[b][w];
      ok[q] = ok[q] && viol == 0u;
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int p = tid + q * kThreads;
    const int b = p % kBB, c = p / kBB;
    fired_s[c][b] = (ok[q] && c0 + c < c_total && nonempty[c0 + c] != 0) ? 1 : 0;
  }
  __syncthreads();

  const int n_c = min(kBC, c_total - c0);
  for (int i = tid; i < kBB * k; i += kThreads) {
    const int b = i / k, kk = i % k;
    if (b0 + b >= b_total) continue;
    int32_t acc = 0;
    for (int c = 0; c < n_c; ++c) {
      if (fired_s[c][b]) acc += __ldg(votes + static_cast<size_t>(c0 + c) * k + kk);
    }
    if (acc != 0) atomicAdd(out + static_cast<size_t>(b0 + b) * k + kk, acc);
  }
}

}  // namespace

extern "C" int fused_infer_launch(
    const uint32_t* lit, const uint32_t* inc, const int32_t* votes,
    const int32_t* nonempty, int32_t* out, int b_total, int c_total,
    int w_total, int k, void* stream) {
  if (b_total <= 0 || c_total <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((b_total + kBB - 1) / kBB, (c_total + kBC - 1) / kBC);
  fused_infer_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lit, inc, votes, nonempty, out, b_total, c_total, w_total, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_infer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
