// Dense fused TM inference for Hopper (sm_90a): clause chain + vote fold.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_infer.py:
// _fused_infer_kernel (launched by fused_tm_forward).  For every (sample,
// clause) pair it ANDs the chain `(inc & ~lit) == 0` over all packed words,
// masks empty clauses with `nonempty`, and folds fired @ votes into int32
// class sums without writing the fired matrix to device memory.
//
// Bounds on the H100: B x C x W three-input logic ops (the chain) and
// fired x K adds (the fold) with a few hundred KB of operands: integer
// issue rate, not memory (0.0030 ms at the serve bucket, B 512, C 2000, W
// 49).  At training's batch 64 (C 2048) the bound is 0.4 us and the launch
// is the floor, so there the kernel is about latency.  The chain is
// clause_chain.cuh's (register-tiled 4 x 4, cp.async double-buffered, a
// grid that covers the card by splitting the words at small B).  The fold:
//   * the block's votes rows (up to 32 classes at a time) and its
//     `nonempty` bits are staged with the first word chunk, so no global
//     load sits inside the fold;
//   * a sample's fired, nonempty clauses are one 64-bit mask in shared
//     memory, made once a sample; a warp's lanes take (sample, class)
//     pairs, 32 / K samples at once, and walk only the set bits
//     (__ffsll), four a round so that four vote loads from shared memory
//     are in flight (a zero row pads the last round): at batch 64 the
//     fold is bound by load latency, not by its adds;
//   * the TPU grid's sequential clause axis, which carries the class-sum
//     block across steps, becomes independent blocks whose partial sums
//     meet in `out` through one int32 atomicAdd a (sample, class) a block
//     (integer adds commute: exact and order-free).  `out` is zeroed by a
//     cudaMemsetAsync on the same stream before the launch.
// The fold is computed here, with no library matrix product.

#include <cstdint>
#include <cuda_runtime.h>

#include "clause_chain.cuh"

namespace {

using namespace clause_chain;

constexpr int kKC = 32;                  // classes a staged votes chunk

// votes rows [c0, c0 + BC) x classes [kc, kc + kn) into votes_s[c * kn + kk];
// with every class at once (kn == k) the rows are one contiguous run
template <int BC>
__device__ __forceinline__ void stage_votes(int32_t* votes_s, const int32_t* votes, int c0,
                                            int c_total, int k, int kc, int kn) {
  const int n = min(BC, c_total - c0) * kn;
  if (kn == k) {
    const int32_t* rows = votes + static_cast<size_t>(c0) * k;
    for (int e = threadIdx.x; e < n; e += kThreads) cp_async4(votes_s + e, rows + e, true);
    return;
  }
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int c = e / kn, kk = e - c * kn;
    cp_async4(votes_s + e, votes + static_cast<size_t>(c0 + c) * k + kc + kk, true);
  }
}

template <int KS>
__global__ void __launch_bounds__(kThreads, kMinBlocks) fused_infer_kernel(
    const uint32_t* __restrict__ lit, const uint32_t* __restrict__ inc,
    const int32_t* __restrict__ votes, const int32_t* __restrict__ nonempty,
    int32_t* __restrict__ out, int b_total, int c_total, int w_total, int k) {
  constexpr int kBC = Shape<KS>::kBC;
  __shared__ Tile<KS> t;
  __shared__ alignas(16) int32_t votes_s[(kBC + 1) * kKC];   // + a zero row
  __shared__ uint32_t ne_s[(kBC + 31) / 32];
  __shared__ uint64_t mask_s[kBB];       // a sample's fired, nonempty clauses
  const int b0 = blockIdx.x * kBB, c0 = blockIdx.y * kBC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // issued now, used after the chain
  const int32_t ne = (tid < kBC && c0 + tid < c_total) ? nonempty[c0 + tid] : 0;
  const int kn0 = min(k, kKC);
  if (tid < kn0) votes_s[kBC * kn0 + tid] = 0;

  fire_tile<KS>(t, lit, inc, b0, c0, b_total, c_total, w_total,
                [&] { stage_votes<kBC>(votes_s, votes, c0, c_total, k, 0, kn0); });
  if (tid < (kBC + 31) / 32 * 32) {      // whole warps: ne is 0 past kBC
    const unsigned bal = __ballot_sync(0xffffffffu, ne != 0);
    if (lane == 0) ne_s[warp] = bal;
  }
  __syncthreads();
  if (tid < kBB) {
    uint64_t ne_mask = ne_s[0];
    if (kBC > 32) ne_mask |= static_cast<uint64_t>(ne_s[1]) << 32;
    mask_s[tid] = fired<KS>(t, tid) & ne_mask;
  }
  __syncthreads();

  // lane -> (sample of the warp's group, class): a warp folds 32 / kn
  // samples at once, its lanes of one sample walking the same bits
  for (int kc = 0; kc < k; kc += kKC) {
    const int kn = min(kKC, k - kc);
    if (kc > 0) {                        // more than 32 classes: the next chunk
      __syncthreads();
      stage_votes<kBC>(votes_s, votes, c0, c_total, k, kc, kn);
      if (tid < kn) votes_s[kBC * kn + tid] = 0;
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    const int per_warp = 32 / kn, sub = lane / kn, kk = lane - sub * kn;
    if (sub >= per_warp) continue;
    for (int b = warp * per_warp + sub; b < kBB && b0 + b < b_total; b += kWarps * per_warp) {
      uint64_t m = mask_s[b];
      int32_t acc = 0;
      while (m != 0) {                   // four set bits a round, four loads in flight
        int c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          c[i] = m != 0 ? __ffsll(static_cast<long long>(m)) - 1 : kBC;   // kBC: the zero row
          m &= m - 1;
        }
        acc += (votes_s[c[0] * kn + kk] + votes_s[c[1] * kn + kk])
             + (votes_s[c[2] * kn + kk] + votes_s[c[3] * kn + kk]);
      }
      if (acc != 0) atomicAdd(out + static_cast<size_t>(b0 + b) * k + kc + kk, acc);
    }
  }
}

template <int KS>
int launch(const uint32_t* lit, const uint32_t* inc, const int32_t* votes,
           const int32_t* nonempty, int32_t* out, int b_total, int c_total, int w_total,
           int k, cudaStream_t stream) {
  fused_infer_kernel<KS><<<grid(b_total, c_total, KS), kThreads, 0, stream>>>(
      lit, inc, votes, nonempty, out, b_total, c_total, w_total, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ks: the warps that split each pair's words (1, 2 or 4), 0 for the
// heuristic (clause_chain.cuh: word_split).
extern "C" int fused_infer_launch(
    const uint32_t* lit, const uint32_t* inc, const int32_t* votes,
    const int32_t* nonempty, int32_t* out, int b_total, int c_total,
    int w_total, int k, int ks, void* stream) {
  const int split = resolve_split(ks, b_total, c_total);
  if (split == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b_total <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(b_total) * k * sizeof(int32_t), s);
  if (err != cudaSuccess || c_total <= 0) return static_cast<int>(err);
  switch (split) {
    case 1: return launch<1>(lit, inc, votes, nonempty, out, b_total, c_total, w_total, k, s);
    case 2: return launch<2>(lit, inc, votes, nonempty, out, b_total, c_total, w_total, k, s);
    default: return launch<4>(lit, inc, votes, nonempty, out, b_total, c_total, w_total, k, s);
  }
}

// Registers, threads, blocks an SM, shared bytes, spill bytes, grid x, grid
// y and word split of the launch at (B, C) with split ks (0: the
// heuristic's) into info[0..7] (W and K change neither the grid nor the
// static shared memory).
extern "C" int fused_infer_occupancy(int b_total, int c_total, int ks, int* info) {
  const int split = resolve_split(ks, b_total, c_total);
  if (split == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 g = grid(b_total, c_total, split);
  cudaError_t err;
  switch (split) {
    case 1: err = occupancy(fused_infer_kernel<1>, g, split, info); break;
    case 2: err = occupancy(fused_infer_kernel<2>, g, split, info); break;
    default: err = occupancy(fused_infer_kernel<4>, g, split, info); break;
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_infer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
