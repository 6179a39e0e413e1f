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
// Bounds on the H100: the bank in, the (C, L) int32 delta out, and about
// ten integer operations per automaton draw actually made (one per sample,
// Type I clause and literal).  The TPU kernel keeps a resident (256 x 1664)
// int32 delta per clause block (1.7 MB), far beyond shared memory, so here
// the delta is tiled in L as well: a CUDA block owns 16 clauses x 256
// literals, one literal per thread, and keeps its 16 sums in registers.
// It stages its 16 include rows in shared memory (one contiguous range of
// the bank), then per segment of up to 512 samples:
//   phase 1: one warp per sample, lanes over the packed words (coalesced),
//     a ballot per clause for the fire bit, then lane c computes clause
//     c's feedback type; the (sample, clause) codes go to shared memory and
//     a sample with any feedback in the tile to a list.  The chain is
//     repeated once per literal tile: cheap beside the draws.
//   phase 2: every thread walks the listed samples only.  Skipping a
//     (sample, clause tile) pair whose types are all 0 is bit-exact, and
//     the list's order does not matter: int32 sums commute.
// A (sample, clause) code is the same for the whole block, so the Type I /
// Type II branches never diverge within a warp.

#include <cstdint>
#include <cuda_runtime.h>

#include "hash_rng.cuh"

namespace {

constexpr int kCT = 16;                  // clauses per CUDA block
constexpr int kThreads = 256;            // = literals per CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 512;                // samples per shared-memory segment

__global__ void fused_train_kernel(
    const int8_t* __restrict__ ta, const uint8_t* __restrict__ lits,
    const uint32_t* __restrict__ lit_words,
    const uint32_t* __restrict__ inc_words, const int32_t* __restrict__ y,
    const int32_t* __restrict__ kn, const float* __restrict__ p_t,
    const float* __restrict__ p_n, const int32_t* __restrict__ cls,
    const int32_t* __restrict__ pol, int32_t* __restrict__ out, int b_total,
    int c_total, int l_total, int w_total, uint32_t c_dim, uint32_t c_base,
    uint32_t seed, uint32_t b_off, uint32_t c_off, uint32_t t_act,
    uint32_t t_inact) {
  // code of a (sample, clause) pair: bits 0-1 feedback type, bit 2 fire
  __shared__ uint8_t code_s[kSeg][kCT];
  __shared__ int active_s[kSeg];         // samples with feedback in the tile
  __shared__ int n_active;
  extern __shared__ uint32_t inc_s[];    // [kCT][w_total] include words
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.x * kCT;
  const int n_c = min(kCT, c_total - c0);
  const int l = blockIdx.y * kThreads + tid;
  const bool l_ok = l < l_total;

  for (int i = tid; i < n_c * w_total; i += kThreads) {
    inc_s[i] = inc_words[static_cast<size_t>(c0) * w_total + i];
  }
  uint32_t excl = 0u;                    // bit c: automaton (c0 + c, l) excludes
  for (int c = 0; c < n_c; ++c) {
    if (l_ok && ta[static_cast<size_t>(c0 + c) * l_total + l] < 0) excl |= 1u << c;
  }
  int32_t acc[kCT];
#pragma unroll
  for (int c = 0; c < kCT; ++c) acc[c] = 0;

  for (int s0 = 0; s0 < b_total; s0 += kSeg) {
    const int ns = min(kSeg, b_total - s0);
    if (tid == 0) n_active = 0;
    __syncthreads();                     // also: inc_s is staged
    for (int b = warp; b < ns; b += kWarps) {
      const int sb = s0 + b;
      const uint32_t* lw = lit_words + static_cast<size_t>(sb) * w_total;
      uint32_t viol[kCT];
#pragma unroll
      for (int c = 0; c < kCT; ++c) viol[c] = 0u;
      for (int w = lane; w < w_total; w += 32) {
        const uint32_t unlit = ~__ldg(lw + w);
#pragma unroll
        for (int c = 0; c < kCT; ++c) {
          if (c < n_c) viol[c] |= inc_s[c * w_total + w] & unlit;
        }
      }
      uint32_t fired = 0u;
#pragma unroll
      for (int c = 0; c < kCT; ++c) {
        if (!__any_sync(0xffffffffu, viol[c] != 0u)) fired |= 1u << c;
      }
      uint8_t code = 0;
      if (lane < n_c) {
        const int cc = c0 + lane;
        const uint32_t r = tm_rng::hash_u32(
            (b_off + static_cast<uint32_t>(sb)) * tm_rng::kSelMix
                + c_off + static_cast<uint32_t>(cc),
            seed ^ tm_rng::kSelXor);
        const float r_sel = __uint2float_rn(r) * 0x1p-32f;
        const int cl = cls[cc], pl = pol[cc];
        const bool is_t = cl == y[sb], is_n = cl == kn[sb];
        const float p = is_t ? p_t[sb] : (is_n ? p_n[sb] : 0.0f);
        int ft = 0;
        if (r_sel < p) {
          ft = (is_t && pl > 0) ? 1 : (is_t && pl < 0) ? 2
             : (is_n && pl > 0) ? 2 : (is_n && pl < 0) ? 1 : 0;
        }
        code = static_cast<uint8_t>(ft | (((fired >> lane) & 1u) ? 4 : 0));
      }
      if (lane < kCT) code_s[b][lane] = code;
      if (__any_sync(0xffffffffu, (code & 3) != 0) && lane == 0) {
        active_s[atomicAdd(&n_active, 1)] = b;
      }
    }
    __syncthreads();

    const int na = n_active;
    if (l_ok) {
      for (int i = 0; i < na; ++i) {
        const int b = active_s[i];
        const uint32_t bg = b_off + static_cast<uint32_t>(s0 + b);
        const bool lit_on = lits[static_cast<size_t>(s0 + b) * l_total + l] == 1;
        const uint32_t row = bg * c_dim + c_base + static_cast<uint32_t>(c0);
#pragma unroll
        for (int c = 0; c < kCT; ++c) {
          const uint8_t code = code_s[b][c];
          const int ft = code & 3;
          if (ft == 0) continue;
          const bool fired = (code & 4) != 0;
          if (ft == 1) {
            const uint32_t gidx = (row + static_cast<uint32_t>(c)) *
                static_cast<uint32_t>(l_total) + static_cast<uint32_t>(l);
            const uint32_t r = tm_rng::hash_u32(gidx, seed);
            acc[c] += (fired && lit_on) ? static_cast<int32_t>(r < t_act)
                                        : -static_cast<int32_t>(r < t_inact);
          } else {
            acc[c] += (fired && !lit_on && ((excl >> c) & 1u)) ? 1 : 0;
          }
        }
      }
    }
    __syncthreads();                     // the next segment rewrites code_s
  }

  if (l_ok) {
#pragma unroll
    for (int c = 0; c < kCT; ++c) {
      if (c < n_c) out[static_cast<size_t>(c0 + c) * l_total + l] = acc[c];
    }
  }
}

}  // namespace

extern "C" int fused_train_launch(
    const int8_t* ta, const uint8_t* lits, const uint32_t* lit_words,
    const uint32_t* inc_words, const int32_t* y, const int32_t* kn,
    const float* p_t, const float* p_n, const int32_t* cls, const int32_t* pol,
    int32_t* out, int b_total, int c_total, int l_total, int w_total,
    uint32_t c_dim, uint32_t c_base, uint32_t seed, uint32_t b_off,
    uint32_t c_off, uint32_t t_act, uint32_t t_inact, void* stream) {
  if (c_total <= 0 || l_total <= 0) return static_cast<int>(cudaSuccess);
  const size_t inc_bytes = static_cast<size_t>(kCT) * w_total * sizeof(uint32_t);
  if (inc_bytes > 32 * 1024) {           // with ~10 KB static: opt in past 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        fused_train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(inc_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((c_total + kCT - 1) / kCT, (l_total + kThreads - 1) / kThreads);
  fused_train_kernel<<<grid, kThreads, inc_bytes, static_cast<cudaStream_t>(stream)>>>(
      ta, lits, lit_words, inc_words, y, kn, p_t, p_n, cls, pol, out, b_total,
      c_total, l_total, w_total, c_dim, c_base, seed, b_off, c_off, t_act,
      t_inact);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
