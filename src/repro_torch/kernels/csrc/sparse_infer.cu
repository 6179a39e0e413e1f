// Block-sparse compiled-schedule TM inference for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_infer.py:
// _sparse_infer_kernel (launched by sparse_tm_forward).  Each unique
// clause of a compiled artifact is a chain of literal ids (its include
// bits); the kernel ANDs the bit-transposed literal rows on the chain and
// folds the fired clauses' multiplicity x polarity votes into int32 class
// sums.  Work scales with the artifact's include count, not with C x W.
//
// What bounds it and what the design does about it: see chain_walk.cuh.
// The TPU kernel's sequential (slab, tile) grid becomes a thread per
// (clause, sample word) that walks the clause's own chain and stops at its
// end or at the word's death.  A launch before the walk bit-transposes the
// bucket's literals (jnp glue around the TPU kernel) into a buffer the
// caller allocates and zeroes the class sums, so a call is two launches,
// three with exact early exit: there the walk stores its fired words into
// a caller-allocated scratch and a fold launch certifies clause block by
// clause block.

#include "chain_walk.cuh"

namespace {

using namespace repro_torch;

constexpr int kIds = 4;                 // ids a thread loads in one round

}  // namespace

extern "C" int sparse_infer_launch(
    const uint32_t* lit, int b_total, int w_total, uint32_t* lit_t,
    int sw_total, const int32_t* chain_ids, const int32_t* lens, int jp,
    const int32_t* votes, int n_rows, int k, const int32_t* indptr,
    int n_cblocks, const int32_t* tile_jb, const int32_t* tile_last,
    const int32_t* margin, int block_c, int block_j, int slab, int32_t* out,
    uint32_t* fired, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_bit_transpose(lit, b_total, w_total, sw_total, sw_total,
                                             lit_t, out, sw_total * 32 * k, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_chain<kIds>(
      lit_t, sw_total, sw_total, chain_ids, lens, jp, votes, n_rows,
      k, indptr, n_cblocks, tile_jb, tile_last, /*tile_off=*/0, margin,
      block_c, block_j, slab, b_total, out, fired, st));
}

// Registers, threads, blocks an SM, shared bytes, spill bytes, grid x, grid
// y and threads a chain of the exact walk at B samples, n_cblocks clause
// blocks of block_c, k classes and `slab` sample words a block (0: the
// heuristic's, chain_walk.cuh: slab_words), into info[0..7].
extern "C" int sparse_infer_occupancy(int b_total, int n_cblocks, int block_c, int k, int slab,
                                      int* info) {
  return static_cast<int>(exact_occupancy<kIds>(
      (b_total + 31) / 32, n_cblocks, block_c, k, slab, info));
}

extern "C" const char* sparse_infer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
