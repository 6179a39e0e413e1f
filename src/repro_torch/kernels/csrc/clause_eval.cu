// Unfused clause evaluation for Hopper (sm_90a): the (B, C) fire matrix.
//
// Replaces the Pallas TPU kernel repro/kernels/clause_eval.py:
// _clause_fire_kernel (launched by clause_fire).  fire[b, c] = 1 iff
// (inc[c, w] & ~lit[b, w]) == 0 for every packed word w; an empty clause
// fires (vacuous AND; inference masks it in the caller).
//
// Bounds on the H100: B x C x W three-input logic ops against (B + C) x W
// x 4 bytes in and B x C bytes out, so integer issue rate at tm-mnist
// widths (0.38 us at training's batch 64, C 2048, W 49, where the launch
// is the floor).  It is fused_infer.cu's chain without the vote fold: the
// register-tiled, cp.async double-buffered chain of clause_chain.cuh,
// whose grid covers the card at batch 64 by splitting the words of each
// pair across warps.  The epilogue turns a sample's 16-bit fire mask into
// 16 bytes and writes them as one 16-byte store along C (byte stores at a
// ragged edge or where rows are not 16-byte aligned), so the int8 matrix
// leaves in full sectors.

#include <cstdint>
#include <cuda_runtime.h>

#include "clause_chain.cuh"

namespace {

using namespace clause_chain;

// bits 0..3 of x as the bytes 0/1 of a little-endian word
__device__ __forceinline__ uint32_t bytes4(uint32_t x) {
  return ((x & 0xfu) * 0x00204081u) & 0x01010101u;
}

template <int KS>
__global__ void __launch_bounds__(kThreads, kMinBlocks) clause_eval_kernel(
    const uint32_t* __restrict__ lit, const uint32_t* __restrict__ inc,
    int8_t* __restrict__ out, int b_total, int c_total, int w_total, int vec16) {
  constexpr int kBC = Shape<KS>::kBC;
  constexpr int kPieces = Shape<KS>::kPieces;
  __shared__ Tile<KS> t;
  const int b0 = blockIdx.x * kBB, c0 = blockIdx.y * kBC;
  fire_tile<KS>(t, lit, inc, b0, c0, b_total, c_total, w_total, [] {});
  __syncthreads();

  // consecutive threads take consecutive 16-clause pieces of a row
  for (int p = threadIdx.x; p < kBB * kPieces; p += kThreads) {
    const int b = p / kPieces, piece = p - b * kPieces;
    const int c = c0 + piece * 16;
    if (b0 + b >= b_total) break;        // p only grows
    if (c >= c_total) continue;
    uint32_t m = 0xffffu;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) m &= t.fire[ks][b][piece];
    int8_t* dst = out + static_cast<size_t>(b0 + b) * c_total + c;
    if (vec16 && c + 16 <= c_total) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(bytes4(m), bytes4(m >> 4), bytes4(m >> 8),
                                                  bytes4(m >> 12));
    } else {
      const int n = min(16, c_total - c);
      for (int j = 0; j < n; ++j) dst[j] = static_cast<int8_t>((m >> j) & 1u);
    }
  }
}

template <int KS>
int launch(const uint32_t* lit, const uint32_t* inc, int8_t* out, int b_total, int c_total,
           int w_total, cudaStream_t stream) {
  // 16-byte stores need every row start 16-byte aligned
  const int vec16 = c_total % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  clause_eval_kernel<KS><<<grid(b_total, c_total, KS), kThreads, 0, stream>>>(
      lit, inc, out, b_total, c_total, w_total, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int clause_eval_launch(const uint32_t* lit, const uint32_t* inc,
                                  int8_t* out, int b_total, int c_total,
                                  int w_total, void* stream) {
  if (b_total <= 0 || c_total <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return word_split(b_total, c_total) == 1
             ? launch<1>(lit, inc, out, b_total, c_total, w_total, s)
             : launch<4>(lit, inc, out, b_total, c_total, w_total, s);
}

// Registers, threads, blocks an SM, shared bytes, spill bytes, grid x, grid
// y and word split of the launch at (B, C) into info[0..7] (W changes
// neither the grid nor the static shared memory).
extern "C" int clause_eval_occupancy(int b_total, int c_total, int* info) {
  const int ks = word_split(b_total, c_total);
  const dim3 g = grid(b_total, c_total, ks);
  const cudaError_t err = ks == 1 ? occupancy(clause_eval_kernel<1>, g, ks, info)
                                  : occupancy(clause_eval_kernel<4>, g, ks, info);
  return static_cast<int>(err);
}

extern "C" const char* clause_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
