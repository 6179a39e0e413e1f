// Fused Tsetlin-machine training delta for Hopper (sm_90a): clause fire ->
// feedback type -> batch-summed automaton delta in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_train.py:
// _fused_train_kernel (launched by fused_tm_train_delta).  The result
// equals clause_eval -> feedback_select -> ta_update, bit for bit, but the
// (B, C) fire and feedback-type matrices never reach device memory.
//
// Two hash streams (hash_rng.cuh), with different clause ids:
//   * selection of (b, c): hash(bg * kSelMix + cg, seed ^ kSelXor) with the
//     GLOBAL sample bg = b + b_off and GLOBAL clause cg = c + c_off, as a
//     float32 r = rn(r_u32) * 2^-32 against p_t / p_n by class and polarity;
//   * the automaton draw of (b, c, l): hash(((bg * c_dim + c_base + c) * L
//     + l), seed), where c_base is 0 (local clause ids) unless the caller
//     passed c_total (then c_base = c_off, c_dim = c_total: global ids).
//
// Bounds on the H100: the automaton draws' integer operations, as for
// ta_update (ta_delta.cuh), plus one three-input logic op per (sample,
// clause, word) of the clause chain (6.3 M at tm-mnist, batch 64: 0.4 us).
// The TPU kernel keeps a resident (256 x 1664) int32 delta per clause
// block, far beyond shared memory; here the delta stays in registers, one
// clause at a time, and the walk is ta_delta.cuh's.  This file is its
// front end, per block of ta_delta::kCT clauses and segment of samples:
//   * cp.async stages the tile's include rows and the segment's packed
//     literal rows (double-buffered: the next segment's copy runs during
//     this one's walk; L1-allocating, so the blocks on one SM share the
//     rows every block reads);
//   * while the rows are in flight, a thread per (sample, clause) draws the
//     selection from the per-sample scalars in global memory;
//   * only the samples with a feedback type in the tile (about 1 in 5 at
//     tm-mnist: their target or negative class) evaluate the chain, one
//     warp a sample, lanes over the staged words, the clauses' fire bits
//     OR-reduced across the warp in one instruction.
// Each code is made once in the grid (a grid tiled in L as well would make
// it once per literal tile, for every sample), and the walk reads its literals
// from the same staged rows: no global load inside it, and the uint8
// literals are not read at all.

#include <cstdint>
#include <cuda_runtime.h>

#include "hash_rng.cuh"
#include "ta_delta.cuh"

namespace {

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// n words global -> shared by the whole block: 16-byte copies where both
// ends are 16-byte aligned, else 4-byte ones.
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* s, int n) {
  int i0 = 0;
  if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(dst)) & 15u) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) cp_async16(dst + 4 * i, s + 4 * i);
    i0 = n / 4 * 4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, s + i);
}

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// words of one segment buffer: seg packed literal rows and one word the
// walk may read past the last of them
__host__ __device__ inline int buffer_words(int seg, int w_total) {
  return round4(seg * w_total + 1);
}

template <int kCT>
__global__ void __launch_bounds__(ta_delta::kMaxThreads) fused_train_kernel(
    const int8_t* __restrict__ ta, const uint32_t* __restrict__ lit_words,
    const uint32_t* __restrict__ inc_words, const int32_t* __restrict__ y,
    const int32_t* __restrict__ kn, const float* __restrict__ p_t,
    const float* __restrict__ p_n, const int32_t* __restrict__ cls,
    const int32_t* __restrict__ pol, int32_t* __restrict__ out, int b_total,
    int c_total, int w_total, int seg, uint32_t c_base, uint32_t b_off,
    uint32_t c_off, ta_delta::Draw d) {
  __shared__ ta_delta::TileOf<kCT> t;
  __shared__ uint8_t active_s[ta_delta::kSegMax];   // samples with feedback in the tile
  __shared__ int n_active;
  extern __shared__ __align__(16) uint32_t dyn_s[];  // row buffers, then includes
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, n_warps = blockDim.x / 32;
  const int W = w_total;
  const int c0 = blockIdx.x * kCT;
  const int n_c = min(kCT, c_total - c0);
  const int n_seg = b_total > seg ? (b_total + seg - 1) / seg : 1;
  const int buf_words = buffer_words(seg, W);
  uint32_t* inc_s = dyn_s + (n_seg > 1 ? 2 : 1) * buf_words;

  auto stage = [&](int k) {
    const int s0 = k * seg, ns = min(seg, b_total - s0);
    copy_words(dyn_s + (k & 1) * buf_words, lit_words + static_cast<size_t>(s0) * W, ns * W);
  };
  copy_words(inc_s, inc_words + static_cast<size_t>(c0) * W, n_c * W);
  stage(0);
  cp_async_commit();
  const ta_delta::Excl<kCT> ex0 = ta_delta::exclude_bits<kCT>(
      ta, c0, n_c, threadIdx.x * ta_delta::kV, static_cast<int>(d.l_total));

  for (int k = 0; k < n_seg; ++k) {
    const int s0 = k * seg, ns = min(seg, b_total - s0);
    if (k + 1 < n_seg) stage(k + 1);
    cp_async_commit();

    // feedback types while the rows are in flight: a thread per pair
    for (int i = threadIdx.x; i < ns * kCT; i += blockDim.x) {
      const int s = i / kCT, c = i % kCT;
      uint32_t ft = 0u;
      if (c < n_c) {
        const int sb = s0 + s, cc = c0 + c;
        const uint32_t r = tm_rng::hash_u32(
            (b_off + static_cast<uint32_t>(sb)) * tm_rng::kSelMix + c_off
                + static_cast<uint32_t>(cc),
            d.seed ^ tm_rng::kSelXor);
        const float r_sel = __uint2float_rn(r) * 0x1p-32f;
        const int cl = __ldg(cls + cc), pl = __ldg(pol + cc);
        const bool is_t = cl == __ldg(y + sb), is_n = cl == __ldg(kn + sb);
        const float p = is_t ? __ldg(p_t + sb) : (is_n ? __ldg(p_n + sb) : 0.0f);
        if (r_sel < p) {
          ft = (is_t && pl > 0) ? 1u : (is_t && pl < 0) ? 2u
             : (is_n && pl > 0) ? 2u : (is_n && pl < 0) ? 1u : 0u;
        }
      }
      t.code[s][c] = static_cast<uint8_t>(ft);
    }
    cp_async_wait_all_but_last();
    __syncthreads();                     // segment k, the includes and the types
    if (warp == 0) {                     // the samples with a type in the tile
      int n = 0;
      for (int base = 0; base < ns; base += 32) {
        const int s = base + lane;
        uint32_t any = 0u;
#pragma unroll
        for (int c = 0; c < kCT; ++c) any |= s < ns ? t.code[s][c] : 0u;
        const uint32_t b = __ballot_sync(0xffffffffu, any != 0u);
        if (any) active_s[n + __popc(b & ((1u << lane) - 1u))] = static_cast<uint8_t>(s);
        n += __popc(b);
      }
      if (lane == 0) n_active = n;
    }
    __syncthreads();

    // fire bits of those samples only: a warp a sample, lanes over words
    const uint32_t* rows = dyn_s + (k & 1) * buf_words;
    for (int i = warp; i < n_active; i += n_warps) {
      const int s = active_s[i];
      uint32_t viol[kCT];
#pragma unroll
      for (int c = 0; c < kCT; ++c) viol[c] = 0u;
      for (int w = lane; w < W; w += 32) {
        const uint32_t unlit = ~rows[s * W + w];
#pragma unroll
        for (int c = 0; c < kCT; ++c) {
          if (c < n_c) viol[c] |= inc_s[c * W + w] & unlit;
        }
      }
      uint32_t bits = 0u;                // bit c: clause c0 + c does not fire
#pragma unroll
      for (int c = 0; c < kCT; ++c) bits |= (viol[c] != 0u ? 1u : 0u) << c;
      bits = __reduce_or_sync(0xffffffffu, bits);
      if (lane < kCT && !((bits >> lane) & 1u)) t.code[s][lane] |= 4u;
    }
    __syncthreads();
    if (warp == 0) ta_delta::build_lists<false>(t, ns, lane);
    __syncthreads();
    const uint32_t g_row0 = (b_off + static_cast<uint32_t>(s0)) * d.c_dim + c_base
                            + static_cast<uint32_t>(c0);
    ta_delta::walk_tile(t, rows, W, ta, out, c0, n_c, ex0, g_row0, d, k == 0);
    __syncthreads();                     // the next segment rewrites the lists
  }
}

struct Config {
  int threads, seg, smem;
};

Config config(int b_total, int l_total, int w_total, int ct) {
  Config k;
  k.threads = ta_delta::block_threads(l_total);
  k.seg = ta_delta::seg_samples(b_total, 4 * w_total);
  const int n_buf = b_total > k.seg ? 2 : 1;
  k.smem = (n_buf * buffer_words(k.seg, w_total) + round4(ct * w_total)) * 4;
  return k;
}

// with ~10-14 KB of static shared memory: opt in past 48 KB
template <int kCT>
cudaError_t opt_in(int smem) {
  if (smem <= 32 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fused_train_kernel<kCT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int kCT>
cudaError_t launch(const int8_t* ta, const uint32_t* lit_words, const uint32_t* inc_words,
                   const int32_t* y, const int32_t* kn, const float* p_t, const float* p_n,
                   const int32_t* cls, const int32_t* pol, int32_t* out, int b_total,
                   int c_total, int l_total, int w_total, uint32_t c_base, uint32_t b_off,
                   uint32_t c_off, const ta_delta::Draw& d, cudaStream_t stream) {
  const Config k = config(b_total, l_total, w_total, kCT);
  const cudaError_t err = opt_in<kCT>(k.smem);
  if (err != cudaSuccess) return err;
  fused_train_kernel<kCT><<<(c_total + kCT - 1) / kCT, k.threads, k.smem, stream>>>(
      ta, lit_words, inc_words, y, kn, p_t, p_n, cls, pol, out, b_total, c_total,
      w_total, k.seg, c_base, b_off, c_off, d);
  return cudaGetLastError();
}

template <int kCT>
cudaError_t occupancy(int b_total, int l_total, int w_total, int* info) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fused_train_kernel<kCT>);
  const Config k = config(b_total, l_total, w_total, kCT);
  if (err == cudaSuccess) err = opt_in<kCT>(k.smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_train_kernel<kCT>,
                                                        k.threads, k.smem);
  }
  if (err != cudaSuccess) return err;
  info[0] = a.numRegs;
  info[1] = k.threads;
  info[2] = blocks;
  info[3] = static_cast<int>(a.sharedSizeBytes) + k.smem;
  info[4] = static_cast<int>(a.localSizeBytes);
  info[5] = kCT;
  info[6] = k.seg;
  return cudaSuccess;
}

}  // namespace

// ct: clauses a block (2, 4 or 8), 0 for the default, ta_delta::kCT.
extern "C" int fused_train_launch(
    const int8_t* ta, const uint32_t* lit_words, const uint32_t* inc_words,
    const int32_t* y, const int32_t* kn, const float* p_t, const float* p_n,
    const int32_t* cls, const int32_t* pol, int32_t* out, int b_total,
    int c_total, int l_total, int w_total, uint32_t c_dim, uint32_t c_base,
    uint32_t seed, uint32_t b_off, uint32_t c_off, uint32_t t_act,
    uint32_t t_inact, int ct, void* stream) {
  if (ct == 0) ct = ta_delta::kCT;
  if (ct != 2 && ct != 4 && ct != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (c_total <= 0 || l_total <= 0) return static_cast<int>(cudaSuccess);
  const ta_delta::Draw d{seed, t_act, t_inact, c_dim, static_cast<uint32_t>(l_total)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (ct) {
    case 2: err = launch<2>(ta, lit_words, inc_words, y, kn, p_t, p_n, cls, pol, out,
                            b_total, c_total, l_total, w_total, c_base, b_off, c_off, d, s);
            break;
    case 8: err = launch<8>(ta, lit_words, inc_words, y, kn, p_t, p_n, cls, pol, out,
                            b_total, c_total, l_total, w_total, c_base, b_off, c_off, d, s);
            break;
    default: err = launch<4>(ta, lit_words, inc_words, y, kn, p_t, p_n, cls, pol, out,
                             b_total, c_total, l_total, w_total, c_base, b_off, c_off, d, s);
  }
  return static_cast<int>(err);
}

// info: registers a thread, threads a block, resident blocks per SM,
// shared bytes a block (static + dynamic), local (spill) bytes a thread,
// clauses a block and samples a segment, of the launch with ct clauses a
// block (0: the default)
extern "C" int fused_train_occupancy(int b_total, int l_total, int w_total, int ct,
                                     int* info) {
  if (ct == 0) ct = ta_delta::kCT;
  switch (ct) {
    case 2: return static_cast<int>(occupancy<2>(b_total, l_total, w_total, info));
    case 4: return static_cast<int>(occupancy<4>(b_total, l_total, w_total, info));
    case 8: return static_cast<int>(occupancy<8>(b_total, l_total, w_total, info));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fused_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
