// Chain walk and vote fold shared by the two schedule kernels
// (sparse_infer.cu and term_infer.cu's stage 2).
//
// A compiled schedule gives every clause a chain of row ids into a table of
// sample-parallel bit rows: row r packs one literal (sparse_infer) or one
// AND term (term_infer) of 32 consecutive samples into one uint32 word, so
// `rows[r * sw_total + s]` holds 32 samples of word s.  A clause fires for a
// sample iff every row on its chain has that sample's bit set.  Sentinel ids
// point at an all-ones row, so ragged chains are exact.  Chains are cut into
// tiles of `block_j` ids; the tiles of clause block `cb` are the contiguous
// tile-table range [tile_off + indptr[cb], tile_off + indptr[cb + 1]), and
// the block's votes fold only when the last tile of that range carries
// tile_last == 1 (a budgeted prefix schedule cuts a block short by leaving
// its last tile out, and such a block adds nothing).
//
// The TPU kernels walk this table as a sequential grid and carry the clause
// state across grid steps.  Hopper blocks run in no order, so here one
// thread walks one clause's whole chain for one sample word in registers.
//
// Bounds on the H100: a chain step is one 4-byte gather of a row that the
// chain picks, so the walk is bound by L1/L2 gather latency, not by device
// memory (the literal table of a 512-sample bucket is 100 KB and stays in
// L2).  Consecutive threads take consecutive sample words of one clause, so
// a warp's gathers of one row coalesce; a thread stops walking as soon as
// its clause is dead for all 32 samples.  The vote fold is computed here
// (no library matrix product): exact mode adds each CUDA block's partial
// class sums into the output with int32 atomics, which commute, so the
// result does not depend on block order.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kThreads = 256;                // a multiple of the warp size
constexpr int kNegSum = -(1 << 28);     // below any real class sum
constexpr int kMaxSlabWords = 16;       // sample words per CUDA block (exact mode)

// Bit transpose of the packed literals: (B, W) words, sample-major ->
// (W * 32 + 1, sw_total) words, literal-major, where row 32 * w + i, word s
// holds bit i of word w of samples 32 * s .. 32 * s + 31 (LSB = first
// sample), and the last row is all ones (the chain sentinel).  Padding
// samples read as 0.  One warp per (w, s): lane j loads sample 32 s + j's
// word, and 32 warp ballots turn the 32 x 32 bit block around in registers.
__global__ void bit_transpose_kernel(
    const uint32_t* __restrict__ lit, int b_total, int w_total, int sw_total,
    uint32_t* __restrict__ lit_t) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= w_total * sw_total) return;            // uniform per warp
  const int w = warp / sw_total;
  const int s = warp % sw_total;
  const int b = s * 32 + lane;
  const uint32_t x = b < b_total ? lit[static_cast<size_t>(b) * w_total + w] : 0u;
  uint32_t mine = 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const uint32_t v = __ballot_sync(0xFFFFFFFFu, (x >> i) & 1u);
    if (lane == i) mine = v;
  }
  lit_t[static_cast<size_t>(w * 32 + lane) * sw_total + s] = mine;
  if (w == 0 && lane == 0) {
    lit_t[static_cast<size_t>(w_total) * 32 * sw_total + s] = 0xFFFFFFFFu;
  }
}

inline cudaError_t launch_bit_transpose(const uint32_t* lit, int b_total,
                                        int w_total, int sw_total,
                                        uint32_t* lit_t, cudaStream_t stream) {
  const long long threads = static_cast<long long>(w_total) * sw_total * 32;
  if (threads > 0) {
    const long long blocks = (threads + kThreads - 1) / kThreads;
    bit_transpose_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        lit, b_total, w_total, sw_total, lit_t);
  } else if (sw_total > 0) {
    // no literal words: only the sentinel row, written by a plain memset
    return cudaMemsetAsync(lit_t, 0xFF, sizeof(uint32_t) * sw_total, stream);
  }
  return cudaGetLastError();
}

__device__ __forceinline__ uint32_t chain_and(
    const uint32_t* __restrict__ rows, int sw_total, int s,
    const int32_t* __restrict__ chain_row, const int32_t* __restrict__ tile_jb,
    int t0, int t1, int block_j) {
  uint32_t ok = 0xFFFFFFFFu;
  for (int t = t0; t < t1 && ok != 0u; ++t) {
    const int32_t* ids = chain_row + static_cast<size_t>(tile_jb[t]) * block_j;
    for (int j = 0; j < block_j; ++j) {
      ok &= __ldg(rows + static_cast<size_t>(ids[j]) * sw_total + s);
    }
  }
  return ok;
}

// Exact mode.  Grid: (clause blocks x clause chunks, sample-word slabs).
// A CUDA block owns `blockDim.x / sw` clauses of one clause block and `sw`
// sample words; it folds their fired bits into its slab's class sums and
// adds them into `out` (zeroed by the caller) with atomics.
__global__ void chain_exact_kernel(
    const uint32_t* __restrict__ rows, int sw_total,
    const int32_t* __restrict__ chain, int jp,
    const int32_t* __restrict__ votes, int n_rows, int k,
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ tile_jb,
    const int32_t* __restrict__ tile_last, int tile_off,
    int block_c, int block_j, int sw, int32_t* __restrict__ out) {
  extern __shared__ uint32_t ok_s[];                 // [cpb][sw]
  const int cpb = blockDim.x / sw;
  const int chunks = (block_c + cpb - 1) / cpb;
  const int cb = blockIdx.x / chunks;
  const int c_lo = cb * block_c + (blockIdx.x % chunks) * cpb;
  const int c_end = min(min(c_lo + cpb, (cb + 1) * block_c), n_rows);
  const int t0 = tile_off + indptr[cb];
  const int t1 = tile_off + indptr[cb + 1];
  // uniform over the block: nothing votes, or the block never folds
  if (c_end <= c_lo || t1 <= t0 || tile_last[t1 - 1] != 1) return;

  const int lc = threadIdx.x / sw;
  const int s0 = blockIdx.y * sw;
  const int s = s0 + threadIdx.x % sw;
  uint32_t ok = 0u;
  if (c_lo + lc < c_end && s < sw_total) {
    ok = chain_and(rows, sw_total, s, chain + static_cast<size_t>(c_lo + lc) * jp,
                   tile_jb, t0, t1, block_j);
  }
  ok_s[threadIdx.x] = ok;                            // == ok_s[lc * sw + s - s0]
  __syncthreads();

  const int n_c = c_end - c_lo;
  const int n_out = 32 * sw * k;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int kk = i % k;
    const int r = i / k;                             // slab row: word * 32 + bit
    const int ws = r >> 5;
    const int bit = r & 31;
    if (s0 + ws >= sw_total) continue;
    int32_t acc = 0;
    for (int q = 0; q < n_c; ++q) {
      if ((ok_s[q * sw + ws] >> bit) & 1u) {
        acc += __ldg(votes + static_cast<size_t>(c_lo + q) * k + kk);
      }
    }
    if (acc != 0) {
      atomicAdd(out + static_cast<size_t>((s0 + ws) * 32 + bit) * k + kk, acc);
    }
  }
}

// Exact early-exit mode.  Grid: one CUDA block per sample word (32 samples).
// The block walks the clause blocks in table order, keeps its slab's class
// sums in shared memory, and after each fold stops once every real sample's
// lead (top1 - top2, 0 on a tie) strictly exceeds the residual vote swing
// `margin[t]` of the fold tile: no later tile can change any argmax.
__global__ void chain_early_kernel(
    const uint32_t* __restrict__ rows, int sw_total,
    const int32_t* __restrict__ chain, int jp,
    const int32_t* __restrict__ votes, int n_rows, int k,
    const int32_t* __restrict__ indptr, int n_cblocks,
    const int32_t* __restrict__ tile_jb, const int32_t* __restrict__ tile_last,
    int tile_off, const int32_t* __restrict__ margin,
    int block_c, int block_j, int n_samples, int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  int32_t* sums = smem;                                        // [32][k]
  uint32_t* ok_s = reinterpret_cast<uint32_t*>(smem + 32 * k); // [blockDim.x]
  __shared__ int done;
  const int s = blockIdx.x;
  for (int i = threadIdx.x; i < 32 * k; i += blockDim.x) sums[i] = 0;
  if (threadIdx.x == 0) done = 0;
  __syncthreads();

  for (int cb = 0; cb < n_cblocks; ++cb) {
    const int t0 = tile_off + indptr[cb];
    const int t1 = tile_off + indptr[cb + 1];
    if (t1 <= t0 || tile_last[t1 - 1] != 1) continue;
    const int c_stop = min((cb + 1) * block_c, n_rows);
    for (int c_lo = cb * block_c; c_lo < c_stop; c_lo += blockDim.x) {
      const int c = c_lo + threadIdx.x;
      uint32_t ok = 0u;
      if (c < c_stop) {
        ok = chain_and(rows, sw_total, s, chain + static_cast<size_t>(c) * jp,
                       tile_jb, t0, t1, block_j);
      }
      ok_s[threadIdx.x] = ok;
      __syncthreads();
      const int n_c = min(static_cast<int>(blockDim.x), c_stop - c_lo);
      for (int i = threadIdx.x; i < 32 * k; i += blockDim.x) {
        const int bit = i / k;
        const int kk = i % k;
        int32_t acc = 0;
        for (int q = 0; q < n_c; ++q) {
          if ((ok_s[q] >> bit) & 1u) {
            acc += __ldg(votes + static_cast<size_t>(c_lo + q) * k + kk);
          }
        }
        sums[i] += acc;                              // one owner per entry
      }
      __syncthreads();
    }
    if (threadIdx.x < 32) {                          // warp 0: certify the slab
      const int bit = threadIdx.x;
      int lead = -kNegSum;                           // padding samples certify
      if (s * 32 + bit < n_samples) {
        const int32_t* row = sums + bit * k;
        int top1 = kNegSum;
        for (int kk = 0; kk < k; ++kk) top1 = max(top1, row[kk]);
        int n_top = 0;
        int second = kNegSum;
        for (int kk = 0; kk < k; ++kk) {
          if (row[kk] == top1) {
            ++n_top;
          } else {
            second = max(second, row[kk]);
          }
        }
        lead = n_top > 1 ? 0 : top1 - second;
      }
      const unsigned all = __all_sync(0xFFFFFFFFu, lead > margin[t1 - 1]);
      if (bit == 0 && all) done = 1;
    }
    __syncthreads();
    if (done) break;
  }
  for (int i = threadIdx.x; i < 32 * k; i += blockDim.x) {
    out[static_cast<size_t>(s) * 32 * k + i] = sums[i];
  }
}

// Launch the exact or (margin != nullptr) early-exit walk on `stream`.
inline cudaError_t launch_chain(
    const uint32_t* rows, int sw_total, const int32_t* chain, int jp,
    const int32_t* votes, int n_rows, int k, const int32_t* indptr,
    int n_cblocks, const int32_t* tile_jb, const int32_t* tile_last,
    int tile_off, const int32_t* margin, int block_c, int block_j,
    int n_samples, int32_t* out, cudaStream_t stream) {
  if (n_cblocks <= 0 || sw_total <= 0) return cudaSuccess;
  if (margin == nullptr) {
    int sw = 1;
    while (sw < sw_total && sw < kMaxSlabWords) sw <<= 1;
    const int cpb = kThreads / sw;
    const int chunks = (block_c + cpb - 1) / cpb;
    const dim3 grid(n_cblocks * chunks, (sw_total + sw - 1) / sw);
    const size_t shm = static_cast<size_t>(kThreads) * sizeof(uint32_t);
    chain_exact_kernel<<<grid, kThreads, shm, stream>>>(
        rows, sw_total, chain, jp, votes, n_rows, k, indptr, tile_jb,
        tile_last, tile_off, block_c, block_j, sw, out);
  } else {
    const size_t shm = (static_cast<size_t>(32) * k + kThreads) * sizeof(int32_t);
    if (shm > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          chain_early_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shm));
      if (e != cudaSuccess) return e;
    }
    chain_early_kernel<<<sw_total, kThreads, shm, stream>>>(
        rows, sw_total, chain, jp, votes, n_rows, k, indptr, n_cblocks,
        tile_jb, tile_last, tile_off, margin, block_c, block_j, n_samples, out);
  }
  return cudaGetLastError();
}

}  // namespace repro_torch
