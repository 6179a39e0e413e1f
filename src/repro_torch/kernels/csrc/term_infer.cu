// Two-stage shared-term (factorized) compiled TM inference for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/term_infer.py:
// _term_infer_kernel (launched by factorized_tm_forward_tables).  Stage 1
// evaluates every unique (word, include-pattern) AND term of the artifact
// once per sample word into a term bit table; stage 2 walks each clause's
// chain of TERM ids over that table and folds the votes.  A term shared by
// n clauses costs its bit chain once plus n single-row gathers.
//
// The TPU keeps the (Tp, block_s) term table in VMEM between the two
// stages of one grid.  On tm-mnist at a 512-sample bucket the table is
// 21,024 x 16 x 4 B = 1.3 MB: too big for a block's 227 KB of shared
// memory, and every clause block needs all of it.  So stage 1 is its own
// launch into a global buffer the caller allocates (it stays in the 50 MB
// L2), and stage 2 is a second launch on the same stream.  A launch before
// both bit-transposes the bucket's literals into a caller-allocated buffer.
//
// Stage 1 is one thread per (term, sample word): term_w gathers of
// literal rows, bound by gather latency like the chain walk.  Stage 2's
// bounds and design: see chain_walk.cuh.

#include "chain_walk.cuh"

namespace {

__global__ void term_eval_kernel(
    const uint32_t* __restrict__ lit_t, int sw_total,
    const int32_t* __restrict__ term_chain, int n_terms_padded, int term_w,
    uint32_t* __restrict__ term_bits) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n_terms_padded) * sw_total) return;
  const int t = static_cast<int>(idx / sw_total);
  const int s = static_cast<int>(idx % sw_total);
  const int32_t* ids = term_chain + static_cast<size_t>(t) * term_w;
  uint32_t v = 0xFFFFFFFFu;
  for (int i = 0; i < term_w; ++i) {
    v &= __ldg(lit_t + static_cast<size_t>(ids[i]) * sw_total + s);
  }
  term_bits[idx] = v;
}

}  // namespace

extern "C" int term_infer_launch(
    const uint32_t* lit, int b_total, int w_total, uint32_t* lit_t,
    int sw_total, const int32_t* term_chain, int tp, int term_w,
    uint32_t* term_bits, const int32_t* clause_chain, int jp,
    const int32_t* votes, int n_rows, int k, const int32_t* indptr,
    int n_cblocks, const int32_t* tile_jb, const int32_t* tile_last,
    int n_term_tiles, const int32_t* margin, int block_c, int block_j,
    int32_t* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t et = repro_torch::launch_bit_transpose(
      lit, b_total, w_total, sw_total, lit_t, st);
  if (et != cudaSuccess) return static_cast<int>(et);
  const long long n = static_cast<long long>(tp) * sw_total;
  if (n > 0) {
    const int threads = repro_torch::kThreads;
    const long long blocks = (n + threads - 1) / threads;
    term_eval_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        lit_t, sw_total, term_chain, tp, term_w, term_bits);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(repro_torch::launch_chain(
      term_bits, sw_total, clause_chain, jp, votes, n_rows, k, indptr,
      n_cblocks, tile_jb, tile_last, n_term_tiles, margin, block_c, block_j,
      b_total, out, st));
}

extern "C" const char* term_infer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
