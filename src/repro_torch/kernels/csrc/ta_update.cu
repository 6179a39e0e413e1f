// Batch-summed Tsetlin-automaton feedback delta for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ta_update.py:
// _ta_delta_kernel (launched by ta_delta).  Given each (sample, clause)
// pair's fire bit and feedback type, out[c, l] sums over the batch:
// Type I (ftype 1): +1 with P = p_act on a fired clause's lit literal,
// else -1 with P = p_inact; Type II (ftype 2): +1 on a fired clause's
// unlit, excluded literal.  The draw of (b, c, l) is
// hash_u32(((b + b_off) * c_dim + c_base + c) * L + l, seed), uint32
// wrapping (hash_rng.cuh), so no (B, C, L) random field exists anywhere.
//
// Bounds on the H100: about ten integer operations per draw made (one per
// sample, Type I clause and literal), against the bank in and the (C, L)
// int32 delta out; the walk that does them is ta_delta.cuh's, shared with
// fused_train.cu.  This file is its front end.  A block per clause and
// 256 literals would make 14,000 near-empty blocks at tm-mnist (13 waves),
// each scanning its clause's 64 codes strided by C and walking 3 to 6
// samples behind a dependent global load of the literals.  Here a block of
// ta_delta::kCT clauses spans all literals, per segment of samples:
//   * reads the tile's fire/ftype bytes once, consecutive threads on
//     consecutive bytes of a row;
//   * one warp lists the pairs and numbers the samples that have one;
//   * stages only those samples' uint8 literals, packed to bit rows in
//     shared memory: a thread 8 bytes of a row, every row's load in flight
//     together, the bytes compared to 1 four at a time and gathered by a
//     carry-free multiply.
#include <cstdint>
#include <cuda_runtime.h>

#include "ta_delta.cuh"

namespace {

using ta_delta::kCT;

// Bytes p[0, 8) as two little-endian words; bytes at or past n read as 0.
__device__ __forceinline__ uint2 load8(const uint8_t* p, int n) {
  if (n >= 8 && (reinterpret_cast<uintptr_t>(p) & 7u) == 0) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < n) w[j / 4] |= static_cast<uint32_t>(p[j]) << (8 * (j % 4));
  }
  return make_uint2(w[0], w[1]);
}

// Bit j set where byte j of the masks (0xff or 0 a byte; lo holds bytes
// 0-3, hi 4-7) is set: each byte keeps its own bit, and the multiply sums
// the four bytes of a word into its top byte without a carry.
__device__ __forceinline__ uint32_t gather8(uint32_t lo, uint32_t hi) {
  return (((lo & 0x08040201u) * 0x01010101u) >> 24) |
         (((hi & 0x80402010u) * 0x01010101u) >> 24);
}

__global__ void __launch_bounds__(ta_delta::kMaxThreads) ta_update_kernel(
    const int8_t* __restrict__ ta, const uint8_t* __restrict__ lits,
    const uint8_t* __restrict__ fire, const uint8_t* __restrict__ ftype,
    int32_t* __restrict__ out, int b_total, int c_total, int seg,
    uint32_t c_base, uint32_t b_off, ta_delta::Draw d) {
  __shared__ ta_delta::Tile t;
  extern __shared__ __align__(16) uint32_t rows_s[];  // [seg][row_words] packed bits
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int L = static_cast<int>(d.l_total);
  const int row_words = (L + 31) / 32;
  uint8_t* row_bytes_s = reinterpret_cast<uint8_t*>(rows_s);
  const int c0 = blockIdx.x * kCT;
  const int n_c = min(kCT, c_total - c0);
  const int n_seg = b_total > seg ? (b_total + seg - 1) / seg : 1;
  const uint32_t ex0 = ta_delta::exclude_bits(ta, c0, n_c, threadIdx.x * ta_delta::kV, L);

  for (int k = 0; k < n_seg; ++k) {
    const int s0 = k * seg, ns = min(seg, b_total - s0);
    for (int i = threadIdx.x; i < ns * kCT; i += blockDim.x) {
      const int s = i / kCT, c = i % kCT;
      uint32_t code = 0u;
      if (c < n_c) {
        const size_t pair = static_cast<size_t>(s0 + s) * c_total + c0 + c;
        const uint32_t ft = ftype[pair];
        if (ft == 1u || ft == 2u) code = ft | (fire[pair] == 1 ? 4u : 0u);
      }
      t.code[s][c] = static_cast<uint8_t>(code);
    }
    __syncthreads();
    if (warp == 0) ta_delta::build_lists<true>(t, ns, lane);
    __syncthreads();

    const int n_rows = t.n_rows;
    for (int kb = threadIdx.x; kb < 4 * row_words; kb += blockDim.x) {
      const uint8_t* src = lits + static_cast<size_t>(s0) * L + 8 * kb;
#pragma unroll 4
      for (int r = 0; r < n_rows; ++r) {
        const uint2 q = load8(src + static_cast<size_t>(t.row_sample[r]) * L,
                                        L - 8 * kb);
        row_bytes_s[r * 4 * row_words + kb] = static_cast<uint8_t>(gather8(
            __vcmpeq4(q.x, 0x01010101u), __vcmpeq4(q.y, 0x01010101u)));
      }
    }
    __syncthreads();
    const uint32_t g_row0 = (b_off + static_cast<uint32_t>(s0)) * d.c_dim + c_base
                            + static_cast<uint32_t>(c0);
    ta_delta::walk_tile(t, rows_s, row_words, ta, out, c0, n_c, ex0, g_row0, d, k == 0);
    __syncthreads();                     // the next segment rewrites the lists
  }
}

struct Config {
  int threads, seg, smem;
};

Config config(int b_total, int l_total) {
  Config k;
  const int row_words = (l_total + 31) / 32;
  k.threads = ta_delta::block_threads(l_total);
  k.seg = ta_delta::seg_samples(b_total, 4 * row_words);
  k.smem = (k.seg * row_words + 1) * 4;   // one word past the last row
  return k;
}

// with ~10 KB of static shared memory: opt in past 48 KB
cudaError_t opt_in(int smem) {
  if (smem <= 32 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(ta_update_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" int ta_update_launch(
    const int8_t* ta, const uint8_t* lits, const uint8_t* fire,
    const uint8_t* ftype, int32_t* out, int b_total, int c_total, int l_total,
    uint32_t c_dim, uint32_t c_base, uint32_t seed, uint32_t b_off,
    uint32_t t_act, uint32_t t_inact, void* stream) {
  if (c_total <= 0 || l_total <= 0) return static_cast<int>(cudaSuccess);
  const Config k = config(b_total, l_total);
  const cudaError_t err = opt_in(k.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ta_delta::Draw d{seed, t_act, t_inact, c_dim, static_cast<uint32_t>(l_total)};
  ta_update_kernel<<<(c_total + kCT - 1) / kCT, k.threads, k.smem,
                     static_cast<cudaStream_t>(stream)>>>(
      ta, lits, fire, ftype, out, b_total, c_total, k.seg, c_base, b_off, d);
  return static_cast<int>(cudaGetLastError());
}

// info: registers a thread, threads a block, resident blocks per SM,
// shared bytes a block (static + dynamic), local (spill) bytes a thread
extern "C" int ta_update_occupancy(int b_total, int l_total, int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, ta_update_kernel);
  const Config k = config(b_total, l_total);
  if (err == cudaSuccess) err = opt_in(k.smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ta_update_kernel,
                                                        k.threads, k.smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = a.numRegs;
  info[1] = k.threads;
  info[2] = blocks;
  info[3] = static_cast<int>(a.sharedSizeBytes) + k.smem;
  info[4] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(cudaSuccess);
}

extern "C" const char* ta_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
