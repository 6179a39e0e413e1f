// Unfused clause evaluation for Hopper (sm_90a): the (B, C) fire matrix.
//
// Replaces the Pallas TPU kernel repro/kernels/clause_eval.py:
// _clause_fire_kernel (launched by clause_fire).  fire[b, c] = 1 iff
// (inc[c, w] & ~lit[b, w]) == 0 for every packed word w; an empty clause
// fires (vacuous AND; inference masks it in the caller).
//
// Bounds on the H100: B x C x W word operations against (B + C) x W x 4
// bytes in and B x C bytes out, so integer issue rate at tm-mnist widths.
// It is fused_infer.cu's chain without the vote fold: a 16-sample x
// 32-word literal tile and a 64-clause x 32-word include tile staged in
// padded shared memory (no bank conflicts), each thread carrying 4
// (sample, clause) chains across word chunks.  A warp covers 32
// consecutive clauses of one sample, so the int8 output row is written in
// 32-byte runs; the TPU grid's sequential word axis is the loop over word
// chunks inside the block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBB = 16;                  // samples per CUDA block
constexpr int kBC = 64;                  // clauses per CUDA block
constexpr int kWC = 32;                  // words per shared-memory chunk
constexpr int kThreads = 256;
constexpr int kPairs = kBB * kBC / kThreads;

__global__ void clause_eval_kernel(
    const uint32_t* __restrict__ lit, const uint32_t* __restrict__ inc,
    int8_t* __restrict__ out, int b_total, int c_total, int w_total) {
  __shared__ uint32_t lit_s[kBB][kWC + 1];
  __shared__ uint32_t inc_s[kBC][kWC + 1];
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
      const int c = p % kBC, b = p / kBC;    // a warp: 32 clauses, 1 sample
      uint32_t viol = 0u;
      for (int w = 0; w < wn; ++w) viol |= inc_s[c][w] & ~lit_s[b][w];
      ok[q] = ok[q] && viol == 0u;
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int p = tid + q * kThreads;
    const int c = p % kBC, b = p / kBC;
    if (b0 + b < b_total && c0 + c < c_total) {
      out[static_cast<size_t>(b0 + b) * c_total + c0 + c] = ok[q] ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int clause_eval_launch(const uint32_t* lit, const uint32_t* inc,
                                  int8_t* out, int b_total, int c_total,
                                  int w_total, void* stream) {
  if (b_total <= 0 || c_total <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((b_total + kBB - 1) / kBB, (c_total + kBC - 1) / kBC);
  clause_eval_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lit, inc, out, b_total, c_total, w_total);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* clause_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
