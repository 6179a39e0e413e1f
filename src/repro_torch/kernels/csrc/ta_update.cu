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
// Bounds on the H100: the bank in, the (C, L) int32 delta out, and about
// ten integer operations per hash actually drawn (one per sample, Type I
// clause and literal).  Each thread owns one (c, l) automaton and keeps
// its int32 sum in a register; a CUDA block is one clause x 256 literals.
// The reference's in-kernel batch loop becomes, per segment of up to 1024
// samples, a cooperative pass that lists the samples with feedback for
// this clause (code: feedback type and fire bit) in shared memory, then a
// loop of every thread over the listed samples only: a (sample, clause)
// pair without feedback costs one load for the whole block, and the
// listed order does not matter (int32 sums commute).

#include <cstdint>
#include <cuda_runtime.h>

#include "hash_rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 1024;               // samples per shared-memory segment

__global__ void ta_update_kernel(
    const int8_t* __restrict__ ta, const uint8_t* __restrict__ lits,
    const uint8_t* __restrict__ fire, const uint8_t* __restrict__ ftype,
    int32_t* __restrict__ out, int b_total, int c_total, int l_total,
    uint32_t c_dim, uint32_t c_base, uint32_t seed, uint32_t b_off,
    uint32_t t_act, uint32_t t_inact) {
  __shared__ int active_s[kSeg];         // samples with feedback for clause c
  __shared__ uint8_t code_s[kSeg];       // bits 0-1 feedback type, bit 2 fire
  __shared__ int n_active;
  const int c = blockIdx.x;
  const int l = blockIdx.y * kThreads + threadIdx.x;
  const bool l_ok = l < l_total;
  const size_t cell = static_cast<size_t>(c) * l_total + l;
  const bool excl = l_ok && ta[cell] < 0;
  const uint32_t row_c = c_base + static_cast<uint32_t>(c);
  int32_t acc = 0;
  for (int s0 = 0; s0 < b_total; s0 += kSeg) {
    const int ns = min(kSeg, b_total - s0);
    if (threadIdx.x == 0) n_active = 0;
    __syncthreads();
    for (int b = threadIdx.x; b < ns; b += kThreads) {
      const size_t pair = static_cast<size_t>(s0 + b) * c_total + c;
      const uint8_t ft = ftype[pair];
      if (ft == 1 || ft == 2) {
        const int i = atomicAdd(&n_active, 1);
        active_s[i] = b;
        code_s[i] = static_cast<uint8_t>(ft | (fire[pair] == 1 ? 4 : 0));
      }
    }
    __syncthreads();
    const int na = n_active;
    if (l_ok) {
      for (int i = 0; i < na; ++i) {
        const int b = s0 + active_s[i];
        const uint8_t code = code_s[i];
        const bool fired = (code & 4) != 0;
        const bool lit_on = lits[static_cast<size_t>(b) * l_total + l] == 1;
        if ((code & 3) == 1) {
          const uint32_t gidx =
              ((b_off + static_cast<uint32_t>(b)) * c_dim + row_c) *
                  static_cast<uint32_t>(l_total) + static_cast<uint32_t>(l);
          const uint32_t r = tm_rng::hash_u32(gidx, seed);
          acc += (fired && lit_on) ? static_cast<int32_t>(r < t_act)
                                   : -static_cast<int32_t>(r < t_inact);
        } else {
          acc += (fired && !lit_on && excl) ? 1 : 0;
        }
      }
    }
    __syncthreads();                     // the next segment rewrites the list
  }
  if (l_ok) out[cell] = acc;
}

}  // namespace

extern "C" int ta_update_launch(
    const int8_t* ta, const uint8_t* lits, const uint8_t* fire,
    const uint8_t* ftype, int32_t* out, int b_total, int c_total, int l_total,
    uint32_t c_dim, uint32_t c_base, uint32_t seed, uint32_t b_off,
    uint32_t t_act, uint32_t t_inact, void* stream) {
  if (c_total <= 0 || l_total <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(c_total, (l_total + kThreads - 1) / kThreads);
  ta_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ta, lits, fire, ftype, out, b_total, c_total, l_total, c_dim, c_base,
      seed, b_off, t_act, t_inact);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ta_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
