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
// L2), and stage 2 is the shared chain walk over it.  A launch before both
// bit-transposes the bucket's literals into a caller-allocated buffer and
// zeroes the class sums: three launches a call, four with exact early exit
// (the walk stores its fired words, a fold launch certifies in order).
//
// Stage 1 is one thread per (term, 4 sample words): a 16-byte load of each
// literal row on the term's chain, issued together, sentinel ids skipped,
// bound by the latency of two dependent loads.  On an H100 at the 512-sample
// bucket that took it from 3.05 us (a thread a word) to 1.86 us.  Evaluating terms where the walk
// reaches them instead, with no stage 1, made the walk a chain of three
// dependent loads and was slower; so was a stage 1 that transposed each
// literal word it needed itself, with no transpose launch (its blocks
// redid each word's transpose, 9.1 us against 1.8 + 3.1).  Stage 2's bounds and design: see
// chain_walk.cuh.

#include "chain_walk.cuh"

namespace {

using namespace repro_torch;

// Stage 1: term_bits[t * stride + s] = the AND of the literal rows on term
// t's chain for sample word s (ids >= n_lit_bits are sentinels).  A thread
// takes 4 words of one term: rows `stride` (a multiple of 4) words apart
// start 16-byte aligned, so each literal row is one 16-byte load, and a
// 4-id chain (term_w 4, tm-mnist's) one more.
__global__ void __launch_bounds__(kThreads) term_eval_kernel(
    const uint32_t* __restrict__ lit_t, int stride, const int32_t* __restrict__ term_chain,
    int term_w, bool ids_vec, int n_lit_bits, long long n, uint32_t* __restrict__ term_bits) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int groups = stride / 4;
  const int t = static_cast<int>(idx / groups);
  const int g = static_cast<int>(idx % groups);
  const int32_t* ids = term_chain + static_cast<size_t>(t) * term_w;
  uint4 v = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
  const auto and_row = [&](int l) {
    if (l >= n_lit_bits) return;
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(lit_t + static_cast<size_t>(l) * stride) + g);
    v.x &= r.x;
    v.y &= r.y;
    v.z &= r.z;
    v.w &= r.w;
  };
  if (ids_vec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(ids));
    and_row(q.x);
    and_row(q.y);
    and_row(q.z);
    and_row(q.w);
  } else {
    for (int i = 0; i < term_w; ++i) and_row(__ldg(ids + i));
  }
  reinterpret_cast<uint4*>(term_bits + static_cast<size_t>(t) * stride)[g] = v;
}

constexpr int kIds = 4;                 // ids a thread loads in one round

}  // namespace

// lit_t and term_bits are tables of rows `stride` words apart: sw_total
// rounded up to a multiple of 4 (the caller allocates them so).
extern "C" int term_infer_launch(
    const uint32_t* lit, int b_total, int w_total, uint32_t* lit_t,
    int sw_total, int stride, const int32_t* term_chain, int tp, int term_w,
    uint32_t* term_bits, const int32_t* clause_chain, const int32_t* lens,
    int jp, const int32_t* votes, int n_rows, int k, const int32_t* indptr,
    int n_cblocks, const int32_t* tile_jb, const int32_t* tile_last,
    int n_term_tiles, const int32_t* margin, int block_c, int block_j, int slab,
    int32_t* out, uint32_t* fired, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the padding words transpose too (samples past b_total read as 0), so
  // stage 1 reads no word that was never written
  cudaError_t e = launch_bit_transpose(lit, b_total, w_total, stride, stride, lit_t,
                                       out, sw_total * 32 * k, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(tp) * (stride / 4);
  if (n > 0) {
    const bool ids_vec = term_w == 4 && reinterpret_cast<uintptr_t>(term_chain) % 16 == 0;
    term_eval_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        lit_t, stride, term_chain, term_w, ids_vec, w_total * 32, n, term_bits);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(launch_chain<kIds>(
      term_bits, stride, sw_total, clause_chain, lens, jp, votes,
      n_rows, k, indptr, n_cblocks, tile_jb, tile_last, n_term_tiles, margin,
      block_c, block_j, slab, b_total, out, fired, st));
}

// Registers, threads, blocks an SM, shared bytes, spill bytes, grid x, grid
// y and threads a chain of the stage-2 walk at B samples, n_cblocks clause
// blocks of block_c, k classes and `slab` sample words a block (0: the
// heuristic's, chain_walk.cuh: slab_words), into info[0..7].
extern "C" int term_infer_occupancy(int b_total, int n_cblocks, int block_c, int k, int slab,
                                    int* info) {
  return static_cast<int>(exact_occupancy<kIds>(
      (b_total + 31) / 32, n_cblocks, block_c, k, slab, info));
}

extern "C" const char* term_infer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
